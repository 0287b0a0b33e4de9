"""surfjax_torch quickstart: build a scene, render, G-buffer, animate, fit.

    python -m surfjax_torch.quickstart [--device cuda] [--out-dir DIR]

writes DIR/frame.png (default surfjax_torch_quickstart in the temporary
directory: $TMPDIR, else /tmp) and prints what each step made. On the
card it renders through the hand-written kernels (`backend="pallas"`:
the fused frame kernel for these mesh-free scenes, K1 and K2 for the
fit); `--device cpu` runs the eager pipeline (the settings' default
backend) on the CPU.

The scene, camera and material API is the JAX package's: Scene.add(node,
material), CSG combinators, Camera.pinhole, render / render_sequence and
fit_pose; `render` and `render_sequence` take a device and return tensors
on it.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

from surfjax_torch import (
    Box, Camera, Material, Plane, PointLight, RenderSettings, Scene, Sphere,
    render, render_sequence, smooth_union, subtract,
)
from surfjax_torch.diff import fit_pose
from surfjax_torch.io.image import save_png
from surfjax_torch.pipeline.frame import _check_device

OUT = os.path.join(tempfile.gettempdir(), "surfjax_torch_quickstart")


def demo_scene(size=(512, 384)):
    """The demo's scene (CSG, a smooth blend, a floor, one light) and its
    camera at size (width, height) -> (scene, camera)."""
    scene = Scene()
    scene.add(subtract(Box(center=(0.6, -0.2, 3.0),
                           half_extents=(0.45, 0.45, 0.45)),
                       Sphere(center=(0.6, 0.1, 2.7), radius=0.4)),
              Material.blinn_phong(albedo=(0.2, 0.45, 0.8), shininess=64))
    scene.add(smooth_union(Sphere(center=(-0.7, -0.3, 3.2), radius=0.5),
                           Sphere(center=(-0.2, 0.2, 3.0), radius=0.35),
                           0.25),
              Material.lambert(albedo=(0.4, 0.7, 0.45)), engine="sdf")
    scene.add(Plane(normal=(0.0, 1.0, 0.0), offset=-0.9),
              Material.lambert(albedo=(0.5, 0.5, 0.55)))
    scene.add_light(PointLight(position=(3.0, 4.0, -1.0)))
    camera = Camera.pinhole(size[0], size[1], fov_y_deg=45.0,
                            position=(0.0, 0.4, 0.0), target=(0.0, 0.0, 3.0))
    return scene, camera


def dolly(camera, n_frames: int = 8):
    """A small dolly from the camera's pose -> (R_flats (F, 9), positions
    (F, 3)), float32 numpy."""
    R = np.asarray(camera.rotation, np.float32).reshape(9)
    pos = np.asarray(camera.position, np.float32)
    return (np.stack([R] * n_frames),
            pos[None, :] + np.float32(0.02) * np.arange(
                n_frames, dtype=np.float32)[:, None] * np.float32(1.0))


def render_demo(device, out_dir: str, backend: str, size=(512, 384)):
    """Steps 1-3: the scene, one frame (written to out_dir/frame.png; its
    G-buffer is tensors on the device) and an 8-frame dolly in one call
    -> (the frame's FrameBuffers, the sequence's)."""
    scene, camera = demo_scene(size)
    settings = RenderSettings(shadows=True, ao=True, backend=backend)
    fb = render(scene, camera, settings, device=device)
    save_png(os.path.join(out_dir, "frame.png"), fb.rgb.cpu().numpy())
    hit = fb.hit > 0
    print("frame.png:", tuple(fb.rgb.shape), "| hits:", int(hit.sum()),
          "| depth range:", float(fb.depth[hit].min()),
          float(fb.depth[hit].max()))
    fbs = render_sequence(scene, camera, dolly(camera), settings,
                          device=device)
    print("sequence:", tuple(fbs.rgb.shape))
    return fb, fbs


def fit_case():
    """Step 4's problem: a smooth blob with plain shading (hard shadow and
    AO edges make poor pose gradients) seen by a 96x72 camera, and the
    perturbed pose the fit starts from -> (scene, camera, settings without
    a backend, (axis-angle w, translation dt))."""
    scene = Scene()
    scene.add(smooth_union(Sphere(center=(-0.35, -0.1, 3.0), radius=0.6),
                           Sphere(center=(0.45, 0.1, 3.0), radius=0.45),
                           0.3),
              Material.lambert(albedo=(0.4, 0.6, 0.8)), engine="sdf")
    scene.add_light(PointLight(position=(3.0, 4.0, -1.0)))
    init = (np.asarray([0.04, -0.03, 0.02], np.float32),
            np.asarray([0.05, -0.05, 0.0], np.float32))
    return (scene, Camera.pinhole(96, 72, fov_y_deg=45.0),
            RenderSettings(shadows=False, max_steps=64, t_max=20.0), init)


def fit_demo(device, backend: str):
    """Step 4: render the target at the true pose, then recover the pose
    from the perturbed start by 80 steps of fit_pose (gradients through
    the raymarcher by the implicit function theorem) -> the losses; raises
    unless the last is below a fifth of the first."""
    scene, cam, settings, init = fit_case()
    settings = settings.with_(backend=backend)
    target = render(scene, cam, settings, device=device).rgb
    _R, _t, losses = fit_pose(scene, cam, target, steps=80, lr=3e-2,
                              settings=settings, init=init, device=device)
    print(f"fit_pose: loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    if not losses[-1] < losses[0] * 0.2:
        raise RuntimeError(f"fit_pose did not converge: loss {losses[0]} "
                           f"-> {losses[-1]}")
    return losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="surfjax_torch.quickstart")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--out-dir", default=OUT)
    args = ap.parse_args(argv)
    device = _check_device(args.device)
    # the kernels on the card; the settings' default (the eager pipeline)
    # elsewhere
    backend = "pallas" if device.type == "cuda" else "jnp"
    os.makedirs(args.out_dir, exist_ok=True)
    render_demo(device, args.out_dir, backend)
    fit_demo(device, backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
