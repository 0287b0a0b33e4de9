"""Sharding and communication layer: the counterpart of
`surfjax/parallel/mesh.py`, over `torch.distributed`.

Two data axes, as in surfjax:
  * 'tile'  - contiguous ranges of a frame's flat (row-major) rays;
  * 'frame' - frames of an animation batch.

Every rank runs the same program (one process per rank). A rank renders
its own rays on its own device with the split path's kernels
(`backend="pallas"`) or the eager pipeline (`backend="jnp"`); the scene's
tables are replicated; the only traffic is the gather at the end of a
frame or sequence, over the mesh's 'tile' group and then its 'frame'
group, after which every rank holds the whole result. NCCL serves ranks
on cards, gloo ranks on the CPU (or several ranks on one card, which
NCCL refuses); gloo gathers CPU tensors only, so `_comm` stages a card's
tensor through the host for it, and never for NCCL.

A rank's device is `cuda:(local rank % device count)` or the CPU. There
is no fallback: a CUDA request without a card raises, and so does a
collective that fails. Eager torch has nothing to compile, so surfjax's
jit caches (`_sharded_frame_fn`, `_sharded_sequence_fn`) have no
counterpart.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from surfjax_torch.core.camera import Intrinsics, flat_camera_rays
from surfjax_torch.core.scene_compile import params_to_device
from surfjax_torch.core.types import FrameBuffers, RenderSettings
from surfjax_torch.pipeline.frame import (
    _as_f32, _check_backend, _check_device, _pose_tensors, render_rays,
)


def initialize_distributed(device="cuda", **kw) -> None:
    """Join the process group: `torch.distributed.init_process_group(**kw)`
    with NCCL for `cuda` and gloo for `cpu` unless kw names a backend.
    Returns at once if this process already has a group; any other error
    raises."""
    if dist.is_initialized():
        return
    device = _check_device(device)
    kw.setdefault("backend", "nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(**kw)


def rank_device(device_type: str) -> torch.device:
    """This rank's device: `cuda:(local rank % device count)` or the CPU.
    The local rank is LOCAL_RANK where a launcher sets it, else the global
    rank."""
    device = _check_device(device_type)
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_frame: int = 1, n_tile: Optional[int] = None,
              devices: Optional[Sequence[int]] = None,
              device="cuda") -> DeviceMesh:
    """('frame', 'tile') mesh over the ranks `devices` (default: every rank
    of the world), on `device`'s type. Defaults: all ranks on 'tile'.
    Raises when the requested shape cannot be built. Every rank of the
    world calls it; a rank outside a mesh of fewer ranks has no
    coordinate in it."""
    device = _check_device(device)
    devices = list(devices if devices is not None
                   else range(dist.get_world_size()))
    if n_frame <= 0 or n_frame > len(devices):
        raise ValueError(
            f"n_frame={n_frame} must be in [1, {len(devices)}] "
            f"(available devices)")
    if n_tile is None:
        n_tile = len(devices) // n_frame
        if n_frame * n_tile != len(devices):
            raise ValueError(
                f"n_frame={n_frame} does not divide the device count "
                f"{len(devices)}; pass n_tile explicitly to use a "
                f"subset deliberately")
    if n_tile <= 0 or n_frame * n_tile > len(devices):
        raise ValueError(
            f"mesh shape ({n_frame}, {n_tile}) needs "
            f"{n_frame * n_tile} devices; have {len(devices)}")
    used = n_frame * n_tile
    ranks = torch.as_tensor(devices[:used], dtype=torch.int64)
    return DeviceMesh(device.type, ranks.reshape(n_frame, n_tile),
                      mesh_dim_names=("frame", "tile"))


def shard_range(n: int, index: int, count: int) -> slice:
    """The index-th of count equal contiguous blocks of n items."""
    if n % count:
        raise ValueError(f"{n} items do not split into {count} equal "
                         "shards")
    per = n // count
    return slice(index * per, (index + 1) * per)


def _comm(t: torch.Tensor, group) -> torch.Tensor:
    """The tensor as the group's backend takes it: gloo gathers and sends
    CPU tensors only, so a card's tensor goes through the host for it;
    NCCL takes it where it is."""
    if dist.get_backend(group) == "gloo" and t.device.type != "cpu":
        return t.cpu()
    return t.contiguous()


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's t (equal shapes), concatenated along dim in the
    group's rank order, on t's device."""
    if group.size() == 1:
        return t
    src = _comm(t, group)
    parts = [torch.empty_like(src) for _ in range(group.size())]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """t summed over the group's ranks (default: the world), on t's
    device."""
    if dist.get_world_size(group) == 1:
        return t
    buf = _comm(t, group).clone()
    dist.all_reduce(buf, group=group)
    return buf.to(t.device)


def _gather_fb(fb: FrameBuffers, mesh: DeviceMesh, tile_dim: int,
               frame_dim: int) -> FrameBuffers:
    """Each buffer gathered over 'tile' along tile_dim, then over 'frame'
    along frame_dim (frame-major, as P(('frame', 'tile')) lays the shards
    out)."""
    tile, frame = mesh.get_group("tile"), mesh.get_group("frame")
    return FrameBuffers(*(all_gather_cat(all_gather_cat(a, tile, tile_dim),
                                         frame, frame_dim) for a in fb))


def _crop_reshape(fb: FrameBuffers, n: int, H: int, W: int
                  ) -> FrameBuffers:
    def fix(a, ch=None):
        return a[:n].reshape((H, W) if ch is None else (H, W, ch))
    return FrameBuffers(rgb=fix(fb.rgb, 3), depth=fix(fb.depth),
                        normal=fix(fb.normal, 3), hit=fix(fb.hit),
                        obj_id=fix(fb.obj_id))


def render_frame_shard(static, settings: RenderSettings, params,
                       intr: Intrinsics, R_flat, cam_pos, index: int,
                       count: int) -> FrameBuffers:
    """Shard `index` of `count` of one frame: the frame's flat rays padded
    to a multiple of count (the last pixel repeated), the index-th
    contiguous block rendered -> flat FrameBuffers of that block. The
    one-frame case of render_sequence_shard."""
    fb = render_sequence_shard(static, settings, params, intr,
                               R_flat.reshape(1, 9), cam_pos.reshape(1, 3),
                               (0, index), (1, count))
    return FrameBuffers(*(a[0] for a in fb))


def render_sequence_shard(static, settings: RenderSettings, params,
                          intr: Intrinsics, R_flats, positions,
                          coord: Tuple[int, int],
                          shape: Tuple[int, int]) -> FrameBuffers:
    """The shard at coord (frame, tile) of a (n_frame, n_tile) mesh: the
    coord[0]-th contiguous block of frames, of each frame its flat rays
    padded to a multiple of n_tile (the last pixel repeated) and the
    coord[1]-th contiguous block of them -> FrameBuffers (frames of the
    block, rays of the block, ...). With backend="pallas" the split path's
    kernels render the blocks in passes of whole frames, each block padded
    to whole tiles on its own (render_tile.render_rays_pallas), each
    kernel launched once per pass; with backend="jnp" the eager pipeline
    renders them frame after frame."""
    _check_backend(settings)
    frames = shard_range(R_flats.shape[0], coord[0], shape[0])
    o, d, _ = flat_camera_rays(intr, R_flats[frames], positions[frames],
                               pad_to=shape[1])
    sl = shard_range(o[0].shape[1], coord[1], shape[1])
    o, d = (tuple(c[:, sl] for c in v) for v in (o, d))
    if settings.backend == "pallas":
        from surfjax_torch.kernels.render_tile import render_rays_pallas
        return render_rays_pallas(static, settings, params, o, d)
    fbs = [render_rays(static, settings, params, tuple(c[f] for c in o),
                       tuple(c[f] for c in d)) for f in range(o[0].shape[0])]
    return FrameBuffers(*(torch.stack(parts) for parts in zip(*fbs)))


def _mesh_for(mesh: Optional[DeviceMesh], device) -> DeviceMesh:
    device = _check_device(device)
    if mesh is None:
        return make_mesh(device=device)
    if mesh.device_type != device.type:
        raise ValueError(f"the mesh is on {mesh.device_type!r}, the call "
                         f"asks for {device.type!r}")
    return mesh


def render_frame_sharded(scene, camera,
                         settings: RenderSettings = RenderSettings(),
                         mesh: Optional[DeviceMesh] = None,
                         device="cuda") -> Optional[FrameBuffers]:
    """One frame, its rays sharded over the whole mesh (both axes folded,
    frame-major) -> the frame's FrameBuffers (H, W, ...) on every rank of
    the mesh; None on a rank outside it."""
    mesh = _mesh_for(mesh, device)
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    dev = rank_device(mesh.device_type)
    static, params = scene.freeze()
    params = params_to_device(params, dev)
    intr = camera.intrinsics
    n_frame, n_tile = mesh.shape
    R_flat, cam_pos = _pose_tensors(camera, dev)
    with torch.no_grad():
        fb = render_frame_shard(static, settings, params, intr, R_flat,
                                cam_pos, coord[0] * n_tile + coord[1],
                                n_frame * n_tile)
        fb = _gather_fb(fb, mesh, 0, 0)
    return _crop_reshape(fb, intr.width * intr.height, intr.height,
                         intr.width)


def render_sequence_sharded(scene, camera, poses,
                            settings: RenderSettings = RenderSettings(),
                            mesh: Optional[DeviceMesh] = None,
                            device="cuda") -> Optional[FrameBuffers]:
    """Animation batch: frames in contiguous blocks over 'frame', each
    frame's rays over 'tile'; one gather at the end -> FrameBuffers (F, H,
    W, ...) on every rank of the mesh; None on a rank outside it.

    poses: (R_flats (F, 9), positions (F, 3)). The default mesh is
    (min(world, 2), world // min(world, 2))."""
    if mesh is None:
        world = dist.get_world_size()
        mesh = make_mesh(n_frame=min(world, 2),
                         n_tile=world // min(world, 2), device=device)
    mesh = _mesh_for(mesh, device)
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    dev = rank_device(mesh.device_type)
    static, params = scene.freeze()
    params = params_to_device(params, dev)
    intr = camera.intrinsics
    R_flats = _as_f32(poses[0], dev).reshape(-1, 9)
    positions = _as_f32(poses[1], dev).reshape(-1, 3)
    F = R_flats.shape[0]
    n_frame = mesh.shape[0]
    if F % n_frame:
        raise ValueError(
            f"frame count {F} must divide the 'frame' axis {n_frame}")
    with torch.no_grad():
        fb = render_sequence_shard(static, settings, params, intr, R_flats,
                                   positions, coord, tuple(mesh.shape))
        fb = _gather_fb(fb, mesh, 1, 0)
    H, W = intr.height, intr.width

    def fix(a, ch=None):
        return a[:, :H * W].reshape((F, H, W) if ch is None
                                    else (F, H, W, ch))

    return FrameBuffers(rgb=fix(fb.rgb, 3), depth=fix(fb.depth),
                        normal=fix(fb.normal, 3), hit=fix(fb.hit),
                        obj_id=fix(fb.obj_id))
