"""One step of the sharded differentiable fit on a ('frame', 'tile') mesh:
the counterpart of `__graft_entry__.py`'s `dryrun_multichip` and its scene
`_flagship`.

F = 2 * n_frame frames (orbit poses) shard over 'frame' and each frame's
rays over 'tile'. Every rank renders its frames' rays through the eager
`render_rays`, takes the sum of its squared rgb (the loss is the mean
squared rgb against a zero target) and its gradient to `leaf_params` by
autograd; the sums are added across ranks with `all_reduce` and divided
by the global count F * N * 3, and every rank takes the same SGD step at
1e-2.

    python -m surfjax_torch.parallel.dryrun N [--device cpu]

runs it in N spawned gloo ranks, every rank on the card (`cuda:0` when
there is one; gloo, because NCCL takes one rank per device) unless
`--device cpu` puts them on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from surfjax_torch.core.camera import camera_ray_dirs_dyn, orbit_pose
from surfjax_torch.core.scene_compile import params_to_device
from surfjax_torch.parallel.mesh import (
    all_reduce_sum, make_mesh, rank_device, shard_range,
)
from surfjax_torch.pipeline.frame import _check_device, render_rays

LR = 1e-2
SIZE = 16        # the frame's width and height
MAX_STEPS = 8    # the dry run's trace budget


def flagship(size: int):
    """Config-3-class SDF scene (a smooth-union blob over a plane, one
    point light), size x size -> (scene, camera, settings)."""
    from surfjax_torch import (
        Camera, Material, Plane, PointLight, Scene, Sphere, smooth_union,
    )
    from surfjax_torch.core.types import RenderSettings
    scene = Scene()
    scene.add(smooth_union(Sphere(center=(-0.4, -0.1, 3.0), radius=0.6),
                           Sphere(center=(0.5, 0.1, 3.0), radius=0.45),
                           0.3),
              Material.blinn_phong(albedo=(0.4, 0.6, 0.8), shininess=32),
              engine="sdf")
    scene.add(Plane(normal=(0.0, 1.0, 0.0), offset=-1.0),
              Material.lambert(albedo=(0.5, 0.5, 0.5)))
    scene.add_light(PointLight(position=(3.0, 4.0, -1.0)))
    cam = Camera.pinhole(size, size, fov_y_deg=45.0)
    return scene, cam, RenderSettings(shadows=True, max_steps=64)


def mesh_shape(n_devices: int):
    """(n_frame, n_tile): two frame shards where the rank count is even."""
    n_frame = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return n_frame, n_devices // n_frame


def orbit_poses(F: int, device):
    """F orbit poses around the scene -> (R_flats (F, 9), positions (F,
    3))."""
    thetas = torch.linspace(0.0, 1.0, F, dtype=torch.float32, device=device)
    four = torch.tensor(4.0, device=device)
    one = torch.tensor(1.0, device=device)
    Rs, ts = zip(*(orbit_pose(four, one, th) for th in thetas))
    shift = torch.tensor([0.0, 0.0, 3.0], device=device)
    return torch.stack(Rs), torch.stack(ts) + shift


def step_shard(static, settings, params, intr, Rs, ts, coord, shape):
    """The shard at coord (frame, tile) of a (n_frame, n_tile) mesh -> (its
    sum of squared rgb, the sum's gradient to leaf_params)."""
    N = intr.width * intr.height
    dev = Rs.device
    rays = shard_range(N, coord[1], shape[1])
    rows = torch.arange(intr.height, dtype=torch.float32,
                        device=dev).repeat_interleave(intr.width)[rays]
    cols = torch.arange(intr.width, dtype=torch.float32,
                        device=dev).repeat(intr.height)[rays]
    leaf = params["leaf_params"].clone().requires_grad_(True)
    p = dict(params, leaf_params=leaf)
    total = torch.zeros((), device=dev)
    for f in range(Rs.shape[0])[shard_range(Rs.shape[0], coord[0],
                                            shape[0])]:
        d = camera_ray_dirs_dyn(intr, Rs[f], rows, cols)
        o = tuple(ts[f][k].expand(rows.shape) for k in range(3))
        diff = render_rays(static, settings, p, o, d).rgb
        total = total + (diff * diff).sum()
    grad, = torch.autograd.grad(total, leaf)
    return total.detach(), grad


def dryrun_step(device="cuda", n_frames=None):
    """One fit step on this rank of the world's mesh (every rank calls it)
    over n_frames frames (default 2 * n_frame, as surfjax's) -> (the
    updated leaf_params, the loss), numpy, equal on every rank."""
    device = _check_device(device)
    n_frame, n_tile = mesh_shape(dist.get_world_size())
    mesh = make_mesh(n_frame, n_tile, device=device)
    dev = rank_device(mesh.device_type)
    scene, cam, settings = flagship(SIZE)
    settings = settings.with_(max_steps=MAX_STEPS)
    static, params = scene.freeze()
    params = params_to_device(params, dev)
    intr = cam.intrinsics
    F = n_frames or 2 * n_frame
    Rs, ts = orbit_poses(F, dev)
    loss, grad = step_shard(static, settings, params, intr, Rs, ts,
                            mesh.get_coordinate(), (n_frame, n_tile))
    count = F * intr.width * intr.height * 3
    loss = all_reduce_sum(loss) / count
    grad = all_reduce_sum(grad) / count
    new_leaf = params["leaf_params"] - LR * grad
    return new_leaf.cpu().numpy(), float(loss)


def dryrun_multichip(n_devices: int, device="cuda"):
    """One sharded fit step in a world of n_devices gloo ranks spawned on
    `device`'s type (the card unless the caller asks for "cpu"; rank r on
    `cuda:(r % device count)`) -> (updated leaf_params, loss) of rank 0,
    after checking that every rank holds the same. Without a card a card
    request raises before any rank is spawned."""
    from surfjax_torch.parallel.launch import run_world
    kind = torch.device(device).type
    results = run_world(dryrun_step, n_devices, kind, device=kind,
                        backend="gloo")
    new_leaf, loss = results[0]
    for leaf_r, loss_r in results[1:]:
        if loss_r != loss or not np.array_equal(leaf_r, new_leaf):
            raise RuntimeError("the ranks disagree on the step")
    if not (np.isfinite(loss) and np.isfinite(new_leaf).all()):
        raise RuntimeError(f"non-finite step: loss {loss}")
    n_frame, n_tile = mesh_shape(n_devices)
    print(f"dryrun_multichip({n_devices}): mesh=({n_frame}x{n_tile}) "
          f"loss={loss:.6f} OK")
    return new_leaf, loss


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="surfjax_torch.parallel.dryrun")
    ap.add_argument("n_devices", type=int, nargs="?", default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device type of the ranks (default cuda)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device)


if __name__ == "__main__":
    main()
