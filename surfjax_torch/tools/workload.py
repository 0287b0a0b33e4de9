"""The main paths' workloads, the mesh test scenes, and the timing
helpers that measure them.

The fused path's workload is the one `bench.py` pins: configs/c3_sdf.yaml
reframed to 1920x1080 at the config's vertical fov, 48 camera positions
each moved by 1e-4 * i on every axis, rendered in one `render_sequence`
call in the `value` (config settings) and `value_exact` (LoDs 0,
over_relax 1.0) modes. The split path's is configs/c4_mesh.yaml at its own
1920x1080 and tile_rows, 16 positions jittered the same way, in the
`config` mode (the yaml's settings: hard shadows, no AO) and the `ao` mode
(AO and soft shadows on). `chip_smoke.py`, the CUDA tests and
`surfjax_torch.tools.breakdown` share them.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from surfjax_torch.api import Camera
from surfjax_torch.config import load_config
from surfjax_torch.core.camera import Intrinsics
from surfjax_torch.meshgen import octasphere

EXACT = dict(secondary_lod_iters=0, ao_lod_iters=0, over_relax=1.0)


def gpu_line(fields: str = "name,power.limit") -> str:
    """`nvidia-smi --query-gpu=<fields> --format=csv,noheader` of card 0."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def reframe(camera, width: int, height: int):
    """The camera at width x height with the same vertical fov."""
    intr = camera.intrinsics
    fov = 2.0 * float(np.degrees(np.arctan(0.5 * intr.height / intr.fy)))
    return Camera(Intrinsics.from_fov(width, height, fov),
                  rotation=camera.rotation, position=camera.position)


def poses(camera, n_frames: int, jitter):
    """n_frames copies of the camera pose, position moved by jitter (F, 3)
    -> (R_flats (F, 9), positions (F, 3)), float32 numpy."""
    R = np.asarray(camera.rotation, np.float32).reshape(1, 9)
    pos = np.asarray(camera.position, np.float32)[None, :]
    return (np.repeat(R, n_frames, axis=0),
            (pos + jitter.astype(np.float32)).astype(np.float32))


def cam_rows_of(R_flats, positions, device):
    """(F, 9) and (F, 3) -> the (F, 12) float32 camera rows of frame_fused."""
    return torch.cat([torch.as_tensor(R_flats), torch.as_tensor(positions)],
                     dim=1).to(device=device, dtype=torch.float32).contiguous()


def _jitter(n_frames: int):
    return np.float32(1e-4) * np.arange(
        n_frames, dtype=np.float32)[:, None] * np.ones((1, 3), np.float32)


def main_path(config_path: str, n_frames: int = 48):
    """-> (scene, camera at 1920x1080, R_flats, positions, modes), modes a
    dict of the two fidelity modes' RenderSettings with backend pallas."""
    scene, camera, settings, _ = load_config(config_path)
    camera = reframe(camera, 1920, 1080)
    Rs, ps = poses(camera, n_frames, _jitter(n_frames))
    modes = {"value": settings.with_(backend="pallas"),
             "value_exact": settings.with_(backend="pallas", **EXACT)}
    return scene, camera, Rs, ps, modes


def mesh_modes(settings):
    """The split path's two modes of a mesh config's settings."""
    return {"config": settings.with_(backend="pallas"),
            "ao": settings.with_(backend="pallas", ao=True,
                                 soft_shadows=True)}


def mesh_main_path(config_path: str, n_frames: int = 16):
    """-> (scene, camera, R_flats, positions, modes) of a mesh config at
    its own size and tile_rows, modes as mesh_modes."""
    scene, camera, settings, _ = load_config(config_path)
    Rs, ps = poses(camera, n_frames, _jitter(n_frames))
    return scene, camera, Rs, ps, mesh_modes(settings)


def mesh_soft_ao_scene(api, size: int):
    """A 128-triangle mesh beside an SDF sphere over an analytic floor,
    AO and soft shadows on -> (scene, camera, settings); `api` is the
    package's api module (the same scene is built for surfjax)."""
    v, f = octasphere(2)
    v = v * 0.5 + np.asarray([0.6, -0.2, 2.8], np.float32)
    scene = api.Scene()
    scene.add(api.TriangleMesh(vertices=v, faces=f),
              api.Material.lambert(albedo=(0.8, 0.4, 0.3)))
    scene.add(api.Sphere(center=(-0.6, -0.1, 3.0), radius=0.5),
              api.Material.lambert(albedo=(0.3, 0.7, 0.4)), engine="sdf")
    scene.add(api.Plane(normal=(0.0, 1.0, 0.0), offset=-0.7),
              api.Material.lambert(albedo=(0.5, 0.5, 0.55)))
    scene.add_light(api.PointLight(position=(3.0, 4.0, -1.0)))
    cam = api.Camera.pinhole(size, size, 45.0, position=(0.0, 0.3, 0.0),
                             target=(0.0, 0.0, 3.0))
    st = api.RenderSettings(shadows=True, soft_shadows=True, ao=True,
                            ao_samples=5, max_steps=128, backend="pallas")
    return scene, cam, st


def two_mesh_scene(api, size: int):
    """Two meshes of 128 and 1 triangles, hard shadows -> (scene, camera,
    settings), built with the package's api module."""
    v1, f1 = octasphere(2)
    v1 = v1 * 0.6 + np.asarray([-0.8, 0.0, 3.0], np.float32)
    v2 = np.asarray([[0.5, -0.5, 2.5], [1.5, -0.5, 2.5], [1.0, 0.8, 3.0]],
                    np.float32)
    scene = api.Scene()
    scene.add(api.TriangleMesh(vertices=v1, faces=f1),
              api.Material.lambert(albedo=(0.8, 0.4, 0.3)))
    scene.add(api.TriangleMesh(vertices=v2,
                               faces=np.asarray([[0, 1, 2]], np.int32)),
              api.Material.lambert(albedo=(0.3, 0.4, 0.8)))
    scene.add_light(api.PointLight(position=(3.0, 4.0, -1.0)))
    return (scene, api.Camera.pinhole(size, size, 45.0),
            api.RenderSettings(shadows=True, backend="pallas"))


def cuda_ms(fn, reps: int):
    """-> (list of per-call ms by CUDA events, last result)."""
    times, out = [], None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times, out
