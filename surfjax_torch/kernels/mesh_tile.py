"""Packet (per-tile) triangle-mesh intersection: the counterpart of
`surfjax/kernels/mesh_tile.py`.

  1. `mesh_candidates`, the wrapper of the hand-written CUDA kernel
     (csrc/mesh_candidates.cu) with its plain version
     `mesh_candidates_reference`: every ray is clipped to the mesh's grid
     box; a tile's frustum is the AABB of its lanes' entry/exit segment
     endpoints, refined by three oriented separating axes. The candidate
     triangles of a tile are those whose AABB and projections overlap it,
     compacted into a (tiles, K) index table. The sets are conservative,
     so the nearest hit over a tile's candidates equals the brute-force
     nearest hit.
  2. `mesh_tile`, the wrapper of the hand-written CUDA kernel
     (csrc/mesh_tile.cu) with its plain version `mesh_tile_reference`:
     Moller-Trumbore of every ray of a tile against the tile's candidates
     in ascending order, keeping the nearest hit (strict <, so ties go to
     the lowest triangle index) with its barycentric shading normal and
     geometric normal; or, for shadow rays, any hit. A tile whose count
     exceeds K scans the full packed table instead.

The candidate scheme exists because element gathers were slow on the TPU.
The port keeps it: it is what the reference computes. On the GPU each warp
of 32 rays then votes on its tile's candidates, 32 at a time, by the box
and oriented axes of its own rays' segments (`mesh_warp_masks` is that vote
in plain PyTorch), reads the rows through L1 and tests only the voted
candidates.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from surfjax_torch.core.math import BIG, f32, sqrt
from surfjax_torch.engines.mesh import moller_trumbore, per_lane
from surfjax_torch.kernels import record_call
from surfjax_torch.utils.profiling import annotate

PACKET_K = 1024  # candidate budget per tile; overflow -> full-table scan
# Above this triangle count the reference routes a mesh through the grid
# DDA (engines/mesh.intersect_mesh) instead of the packet kernel, with a
# warning; the port keeps that routing.
MAX_PACKET_TRIS = 40_000
ROW_W = 24       # packed triangle row: v0, e1, e2, gn, n0, n1, n2, pad
LANES = 128
MT_WX = 16       # the kernel's warps: 16 x 2 rays (csrc/mesh_tile.cu)
VOTE_SLOTS = 256  # candidate slots mesh_warp_masks compares at a time


# The most (tile, triangle) entries the plain version tests at a time: a
# batch with more tiles (a sequence's frames in one pass) is taken in
# groups of whole tiles, each tile's candidates being its own. The kernel
# takes every tile at once.
CAND_ENTRIES = 1 << 26
MC_THREADS = 256  # the candidate kernel's threads per tile
                  # (csrc/mesh_candidates.cu)


@annotate("surfjax_torch.mesh_candidates")
def mesh_candidates(ms, tri_packed, o2, d2, t_min, t_max, tile_rows: int,
                    K: int = PACKET_K):
    """-> (cand (tiles, K) int32 triangle ids, counts (tiles,) int32).

    Conservative per-tile candidate sets by segment-AABB culling plus
    three oriented axes (mesh_candidates_reference). Slots at and above a
    tile's count hold the last triangle, as in the reference; a count
    above K means overflow. t_max is a Python float or a per-lane tensor.

    CUDA tensors launch the hand-written kernel (csrc/mesh_candidates.cu,
    one launch per call, counted in `mesh_candidates.launches`); CPU
    tensors run the plain version. Anything else raises."""
    args = (ms, tri_packed, o2, d2, t_min, t_max, tile_rows, K)
    record_call("mesh_candidates", args)
    dev = o2[0].device
    with annotate("surfjax_torch.kernel.mesh_candidates"):
        if dev.type == "cuda":
            launch, out = mesh_candidates_launcher(*args)
            launch()
            mesh_candidates.launches += 1
            return out
        if dev.type == "cpu":
            return mesh_candidates_reference(*args)
    raise ValueError(f"unsupported device {dev}")


mesh_candidates.launches = 0


def mesh_candidates_reference(ms, tri_packed, o2, d2, t_min, t_max,
                              tile_rows: int, K: int = PACKET_K):
    """The candidate kernel's plain version -> (cand, counts), the
    kernel's to the bit.

    Every ray is clipped to the mesh's grid box (_lane_clip); a tile's
    region is the box of its lanes' segment endpoints and, on three
    oriented axes (the valid lanes' directions summed in the kernel's
    order, _tile_sum, and two orthogonals, _axes), the range of the
    endpoints' projections. The candidates of a tile are the triangles
    whose box and projections meet its region, padded by eps; each
    triangle a lane's segment meets is among them. The tiles' regions are
    formed at once, their overlap with the triangles in groups of at most
    CAND_ENTRIES entries (_tile_candidates)."""
    rows = o2[0].shape[0]
    tiles = rows // tile_rows
    pa, pb, valid = _lane_clip(o2, d2, per_lane(o2[0], t_max), t_min,
                               grid_box(ms))
    valid = valid.reshape(tiles, -1)
    pa, pb = ([c.reshape(tiles, -1) for c in p] for p in (pa, pb))

    def tile_range(a_lane, b_lane):
        lo, hi = _ranges(a_lane, b_lane, valid)
        return lo.amin(dim=1), hi.amax(dim=1)

    boxes = [tile_range(pa[ax], pb[ax]) for ax in range(3)]
    # The projections are written out in float32 with no matrix product,
    # so neither bf16 nor TF32 can shrink a triangle's projected range
    # (surfjax pins HIGHEST for that reason: a bf16 projection culled true
    # hits on its device).
    axes = [(a,) + tile_range(_dot([c[:, None] for c in a], pa),
                              _dot([c[:, None] for c in a], pb))
            for a in _axes([_tile_sum(torch.where(valid, c.reshape(
                tiles, -1), 0.0)) for c in d2])]

    step = max(1, CAND_ENTRIES // max(1, tri_packed.shape[0]))
    parts = [_tile_candidates(
        tri_packed, [(lo[g], hi[g]) for lo, hi in boxes],
        [([c[g] for c in a], lo[g], hi[g]) for a, lo, hi in axes], K)
        for g in (slice(s, s + step) for s in range(0, tiles, step))]
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def _tile_sum(x):
    """(tiles, n) per-lane values -> (tiles,) each row's sum in the
    candidate kernel's order: thread k of MC_THREADS adds lanes k,
    k + MC_THREADS, ... in turn to +0.0 (lanes past the tile's end add
    +0.0), each warp's 32 sums go through the butterfly (_butterfly_sum)
    and the warps' totals are added in warp order."""
    tiles, n = x.shape
    steps = -(-n // MC_THREADS)
    x = torch.nn.functional.pad(x, (0, steps * MC_THREADS - n))
    x = x.reshape(tiles, steps, MC_THREADS)
    s = torch.zeros((tiles, MC_THREADS), dtype=x.dtype, device=x.device)
    for k in range(steps):
        s = s + x[:, k]
    w = _butterfly_sum(s.reshape(-1, 32)).reshape(tiles, -1)
    total = w[:, 0]
    for k in range(1, w.shape[1]):
        total = total + w[:, k]
    return total


def _tile_candidates(tri_packed, boxes, axes, K: int):
    """The plain candidates for a group of tiles, given per tile its box
    (lo, hi per axis) and its three oriented axes (three (tiles,)
    components each) with the range of its segments' projections on each
    -> (cand, counts) of the group."""
    tiles = boxes[0][0].shape[0]
    # triangle boxes from the packed v0/e1/e2
    v0 = tri_packed[:, 0:3]
    p1 = v0 + tri_packed[:, 3:6]
    p2 = v0 + tri_packed[:, 6:9]
    tri_lo = torch.minimum(torch.minimum(v0, p1), p2)
    tri_hi = torch.maximum(torch.maximum(v0, p1), p2)

    eps = f32(1e-4)
    overlap = torch.ones((tiles, tri_packed.shape[0]), dtype=torch.bool,
                         device=tri_packed.device)
    for ax, (lo, hi) in enumerate(boxes):
        overlap &= tri_lo[None, :, ax] <= hi[:, None] + eps
        overlap &= tri_hi[None, :, ax] >= lo[:, None] - eps
    verts = (v0, p1, p2)
    for a, slo, shi in axes:
        tproj = [_dot([c[:, None] for c in a],
                      [vt[None, :, k] for k in range(3)]) for vt in verts]
        tpro_lo = torch.minimum(torch.minimum(tproj[0], tproj[1]), tproj[2])
        tpro_hi = torch.maximum(torch.maximum(tproj[0], tproj[1]), tproj[2])
        overlap &= tpro_lo <= shi[:, None] + eps
        overlap &= tpro_hi >= slo[:, None] - eps

    # compaction: the j-th overlapping triangle of tile t goes to slot j
    # (a scatter of the nonzero entries; surfjax uses a broadcast compare
    # that would take gigabytes at 1080p)
    F_n = tri_packed.shape[0]
    counts = overlap.sum(dim=1).to(torch.int32)
    slot = torch.cumsum(overlap.to(torch.int32), dim=1) - 1
    t_idx, f_idx = overlap.nonzero(as_tuple=True)
    s_idx = slot[t_idx, f_idx]
    keep = s_idx < K
    cand = torch.full((tiles, K), F_n - 1, dtype=torch.int32,
                      device=tri_packed.device)
    cand[t_idx[keep], s_idx[keep].long()] = f_idx[keep].to(torch.int32)
    return cand, counts


class McArgs(ctypes.Structure):
    """Arguments of mc_candidates (csrc/mesh_candidates.cu), passed by
    value."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "tri", "ox", "oy", "oz", "dx", "dy", "dz", "tmax", "cand",
        "counts")] + \
        [(name, ctypes.c_int) for name in (
            "tiles", "tile_rays", "K", "n_tris")] + \
        [("t_min", ctypes.c_float), ("t_max", ctypes.c_float),
         ("box_lo", ctypes.c_float * 3), ("box_hi", ctypes.c_float * 3)]


def mesh_candidates_launcher(ms, tri_packed, o2, d2, t_min, t_max,
                             tile_rows: int, K: int = PACKET_K):
    """Prepare one launch of the candidate kernel on CUDA tensors
    (mesh_candidates' arguments) -> (launch, (cand, counts)): launch()
    enqueues the kernel on the current stream, writes cand and counts, and
    raises if the launch was refused. The wrapper launches once;
    chip_smoke.py times repeated launches."""
    from surfjax_torch.kernels import _build
    rows, lanes = o2[0].shape
    if rows % tile_rows:
        raise ValueError(f"{rows} ray rows do not split into tiles of "
                         f"{tile_rows} rows")
    tiles = rows // tile_rows
    dev = o2[0].device
    lane_t = isinstance(t_max, torch.Tensor)
    if lane_t and t_max.shape != o2[0].shape:
        t_max = per_lane(o2[0], t_max)
    rays = [r.contiguous() for r in list(o2) + list(d2)] + \
        ([t_max.contiguous()] if lane_t else [])
    tri = tri_packed.contiguous()
    for name, ten in [("tri_packed", tri)] + \
            [(f"ray array {k}", r) for k, r in enumerate(rays)]:
        if ten.device != dev or ten.dtype != torch.float32:
            raise ValueError(f"{name}: need float32 on {dev}; got "
                             f"{ten.dtype} on {ten.device}")
        if name.startswith("ray") and ten.shape != o2[0].shape:
            raise ValueError(f"{name}: shape {tuple(ten.shape)}, expected "
                             f"{tuple(o2[0].shape)}")
    if tri.dim() != 2 or tri.shape[1] != ROW_W:
        raise ValueError(f"tri_packed must be (F, {ROW_W}); got "
                         f"{tuple(tri.shape)}")
    cand = torch.empty((tiles, K), dtype=torch.int32, device=dev)
    counts = torch.empty((tiles,), dtype=torch.int32, device=dev)
    args = McArgs(tri.data_ptr(), *[r.data_ptr() for r in rays[:6]],
                  rays[6].data_ptr() if lane_t else None, cand.data_ptr(),
                  counts.data_ptr(), tiles=tiles,
                  tile_rays=tile_rows * lanes, K=K, n_tris=tri.shape[0],
                  t_min=f32(t_min), t_max=0.0 if lane_t else f32(t_max))
    args.box_lo[:], args.box_hi[:] = grid_box(ms)
    lib = _build.load()

    def launch():
        with torch.cuda.device(dev):
            err = lib.mc_candidates(args, dev.index, ctypes.c_void_p(
                torch.cuda.current_stream(dev).cuda_stream))
        if err != 0:
            raise RuntimeError(f"mc_candidates launch failed: cudaError "
                               f"{err} ({_build.error_string(err)})")
        # the arrays the kernel reads stay alive as long as launch does
        return tri, rays, cand, counts

    return launch, (cand, counts)


def _check_inputs(tri_packed, cand, counts, o2, d2, t_maxv):
    rays = list(o2) + list(d2) + [t_maxv]
    shape, dev = rays[0].shape, rays[0].device
    if len(shape) != 2 or shape[1] != 128:
        raise ValueError(f"rays must be (rows, 128); got {tuple(shape)}")
    tiles, K = cand.shape
    if shape[0] % tiles or (shape[0] // tiles) % 2:
        raise ValueError(f"{shape[0]} ray rows do not split into {tiles} "
                         "tiles of an even number of rows")
    for name, ten, dt in [("tri_packed", tri_packed, torch.float32),
                          ("cand", cand, torch.int32),
                          ("counts", counts, torch.int32)] + \
            [(f"ray array {k}", r, torch.float32) for k, r in enumerate(rays)]:
        if ten.device != dev or ten.dtype != dt:
            raise ValueError(f"{name}: need {dt} on {dev}; got {ten.dtype} "
                             f"on {ten.device}")
        if name.startswith("ray") and tuple(ten.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(ten.shape)}, expected "
                             f"{tuple(shape)}")
    if tri_packed.dim() != 2 or tri_packed.shape[1] != ROW_W:
        raise ValueError(f"tri_packed must be (F, {ROW_W}); got "
                         f"{tuple(tri_packed.shape)}")
    if counts.shape != (tiles,):
        raise ValueError(f"counts must be ({tiles},); got "
                         f"{tuple(counts.shape)}")


def mesh_tile_reference(tri_packed, cand, counts, o2, d2, t_maxv,
                        t_min: float, smooth: bool, any_hit: bool, box=None,
                        count_tests: bool = False, masks=None):
    """Plain PyTorch version of the mesh kernel over (rows, 128) rays.

    -> (t, ns (3), ng (3)): nearest hit (ties to the lowest candidate
    slot) with its shading and geometric normals, or for any_hit the t
    of the first occluder in candidate order and no normals; t == BIG on
    a miss and the normals (0, 0, 1) where nothing was recorded. Both are
    the kernel's results to the bit. With count_tests, also the per-lane
    number of triangle tests the kernel needs: every candidate for a
    nearest-hit lane, up to the first occluder for an any-hit lane, none
    for a lane whose segment is empty (t_max <= t_min).

    `box` (the grid box the kernel's cull clips rays to) is accepted and
    not read. With masks (the `masks` of mesh_warp_masks' votes), each
    lane visits only its warp's voted candidates, and count_tests
    counts those: the culled algorithm, whose results the cull must leave
    as they are.

    Candidates are taken in chunks: each (ray, triangle) test is the
    kernel's arithmetic, and a chunk's first minimum (or first hit) is
    merged with strict <, which is what a scan in order keeps."""
    out, last, active = _mesh_scan(tri_packed, cand, counts, o2, d2, t_maxv,
                                   t_min, smooth, any_hit, masks)
    if not count_tests:
        return out
    if masks is None:
        tests = last + 1
    else:
        tests = _voted_up_to(masks, warp_of_rays(last.shape[0], last.device),
                             last)
    return out + (torch.where(active, tests, 0),)


def _popcount(x):
    """Set bits of int64 values in [0, 2**32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _voted_up_to(masks, warp, last):
    """-> per lane the voted slots of its warp in [0, last] (0 where last
    < 0); masks int32 (warps, words), warp and last per lane."""
    words = masks.long() & 0xFFFFFFFF
    pop = _popcount(words)
    before = torch.cumsum(pop, dim=1) - pop          # words below each word
    lc = torch.clamp(last, min=0)
    wi = lc >> 5
    part = words[warp, wi] & ((2 << (lc & 31)) - 1)
    return torch.where(last >= 0, before[warp, wi] + _popcount(part), 0)


def _mesh_scan(tri_packed, cand, counts, o2, d2, t_maxv, t_min: float,
               smooth: bool, any_hit: bool, masks):
    """mesh_tile_reference's scan -> (outputs, per ray (rows, 128) the
    last candidate slot the kernel's scan takes to: its first occluder for
    an any-hit lane that has one, else its tile's last slot (-1 where the
    tile has none), and whether its segment is not empty)."""
    tiles, K = cand.shape
    F_n = tri_packed.shape[0]
    shape = o2[0].shape
    o = [c.reshape(tiles, 1, -1) for c in o2]
    d = [c.reshape(tiles, 1, -1) for c in d2]
    t_max = t_maxv.reshape(tiles, 1, -1)
    lanes = o[0].shape[2]
    tmin = f32(t_min)
    over = counts > K
    n_valid = torch.where(over, F_n, torch.clamp(counts, max=K)).long()
    dev = o[0].device
    t_best = torch.full((tiles, lanes), BIG, device=dev)
    zero = torch.zeros_like(t_best)
    one = torch.ones_like(t_best)
    ns = [zero, zero, one]
    ng = [zero, zero, one]
    first = torch.full((tiles, lanes), -1, dtype=torch.int64, device=dev)
    eps = f32(1e-7)
    if masks is not None:
        warp = warp_of_rays(shape[0], dev).reshape(tiles, lanes)
    chunk = max(1, min(64, (1 << 24) // max(1, tiles * lanes)))
    n_steps = int(n_valid.max()) if tiles else 0
    for base in range(0, n_steps, chunk):
        ks = torch.arange(base, min(base + chunk, n_steps), device=dev)
        ids = torch.where(over[:, None], torch.clamp(ks, max=F_n - 1),
                          cand[:, torch.clamp(ks, max=K - 1)].long())
        rows = tri_packed[ids]                          # (tiles, C, 24)

        v0, e1, e2 = (tuple(rows[:, :, j:j + 1] for j in range(c, c + 3))
                      for c in (0, 3, 6))
        t, ok, u, v = moller_trumbore(o, d, v0, e1, e2, eps)
        hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin)
               & (t < t_max) & (ks[None, :] < n_valid[:, None])[:, :, None])
        if masks is not None:
            voted = (masks[:, ks >> 5] >> (ks & 31)) & 1       # (warps, C)
            hit &= voted[warp].permute(0, 2, 1) == 1
        if any_hit:
            # the first occluder of each lane in this chunk
            j = hit.to(torch.int32).argmax(dim=1, keepdim=True)
            new = hit.any(dim=1) & (first < 0)
            first = torch.where(new, base + j[:, 0], first)
            t_best = torch.where(new, t.gather(1, j)[:, 0], t_best)
            continue
        tc = torch.where(hit, t, float("inf"))
        m = tc.amin(dim=1, keepdim=True)
        j = (tc == m).to(torch.int32).argmax(dim=1, keepdim=True)
        better = m[:, 0] < t_best
        t_best = torch.where(better, m[:, 0], t_best)
        uj, vj = u.gather(1, j)[:, 0], v.gather(1, j)[:, 0]
        # the 24 columns of each lane's chosen row, each (tiles, lanes)
        col = rows[torch.arange(tiles, device=dev)[:, None],
                   j[:, 0]].unbind(-1)
        gn = col[9:12]
        if smooth:
            w = 1.0 - uj - vj
            sx, sy, sz = ((w * col[12 + k] + uj * col[15 + k])
                          + vj * col[18 + k] for k in range(3))
            inv = 1.0 / sqrt((sx * sx + sy * sy) + sz * sz)
            sh = (sx * inv, sy * inv, sz * inv)
        else:
            sh = gn
        for ax in range(3):
            ns[ax] = torch.where(better, sh[ax], ns[ax])
            ng[ax] = torch.where(better, gn[ax], ng[ax])
    out = (t_best.reshape(shape), tuple(a.reshape(shape) for a in ns),
           tuple(a.reshape(shape) for a in ng))
    last = (n_valid[:, None] - 1) * torch.ones_like(first)
    if any_hit:
        last = torch.where(first >= 0, first, last)
    return out, last.reshape(shape), ~(t_max[:, 0] <= tmin).reshape(shape)


def grid_box(ms):
    """The mesh's grid box, which mesh_candidates clips rays to and the
    kernel's cull too -> ((x, y, z) low, (x, y, z) high), float32 values
    as Python floats."""
    bmin = [np.float32(v) for v in ms.bbox_min]
    bext = [np.float32(ms.cell_size[0] * ms.nx),
            np.float32(ms.cell_size[1] * ms.ny),
            np.float32(ms.cell_size[2] * ms.nz)]
    return (tuple(float(v) for v in bmin),
            tuple(float(bmin[ax] + bext[ax]) for ax in range(3)))


def warp_of_rays(rows: int, device):
    """-> int64 (rows, 128): the kernel's warp of each ray. Blocks of 256
    threads take two rows of the ray array each; in a block, warp k holds
    the 16 x 2 rays of columns 16 k .. 16 k + 15; warps are numbered in
    thread order."""
    r = torch.arange(rows, device=device)[:, None]
    c = torch.arange(LANES, device=device)[None, :]
    return (r // 2) * (LANES // MT_WX) + c // MT_WX


def _lane_clip(o2, d2, t_maxv, t_min: float, box):
    """Each ray clipped to the grid box (grid_box) with mesh_candidates'
    slab arithmetic -> (entry point (3), exit point (3), whether the
    segment meets the box)."""
    bmin, bmax = box
    t_lo = torch.full_like(o2[0], f32(t_min))
    t_hi = t_maxv
    for ax in range(3):
        dz = d2[ax] == 0.0
        inv = 1.0 / torch.where(dz, 1.0, d2[ax])
        ta = (bmin[ax] - o2[ax]) * inv
        tb = (bmax[ax] - o2[ax]) * inv
        tn = torch.minimum(ta, tb)
        tf = torch.maximum(ta, tb)
        in_slab = (o2[ax] > bmin[ax]) & (o2[ax] < bmax[ax])
        tn = torch.where(dz, torch.where(in_slab, -BIG, BIG), tn)
        tf = torch.where(dz, torch.where(in_slab, BIG, -BIG), tf)
        t_lo = torch.maximum(t_lo, tn)
        t_hi = torch.minimum(t_hi, tf)
    return ([o2[ax] + t_lo * d2[ax] for ax in range(3)],
            [o2[ax] + t_hi * d2[ax] for ax in range(3)], t_lo <= t_hi)


def _ranges(pa, pb, valid):
    """Per lane the range of two values, BIG / -BIG where not valid."""
    return (torch.where(valid, torch.minimum(pa, pb), BIG),
            torch.where(valid, torch.maximum(pa, pb), -BIG))


def _butterfly_sum(x):
    """(warps, 32) -> (warps,): the sum of each row as the kernel's
    __shfl_xor_sync butterfly forms it (offsets 16, 8, 4, 2, 1; every
    lane ends with the same value)."""
    idx = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        x = x + x[:, idx ^ off]
    return x[:, 0]


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _axes(w):
    """Three oriented axes from a summed direction w (three tensors): w
    normalised ((1, 0, 0) where its norm is 1e-6 or less) and two
    orthogonals -> [w, u, v], each three tensors of w's shape; the
    arithmetic of csrc/mesh_tile.cu's warp_box and
    csrc/mesh_candidates.cu."""
    nrm = sqrt((w[0] * w[0] + w[1] * w[1]) + w[2] * w[2])
    ok = nrm > f32(1e-6)
    w = [torch.where(ok, c / nrm, 1.0 if k == 0 else 0.0)
         for k, c in enumerate(w)]
    big_y = torch.abs(w[1]) >= f32(0.9)
    ref = [torch.where(big_y, 1.0, 0.0), torch.where(big_y, 0.0, 1.0),
           torch.zeros_like(w[0])]
    u = _cross(w, ref)
    un = sqrt((u[0] * u[0] + u[1] * u[1]) + u[2] * u[2])
    u = [c / un for c in u]
    return [w, u, _cross(w, u)]


def _warp_axes(d_w, valid_w):
    """The warp's three oriented axes (csrc/mesh_tile.cu's warp_box): its
    valid lanes' directions summed in the butterfly's order, then _axes
    -> [w, u, v], each three (warps,) tensors."""
    return _axes([_butterfly_sum(torch.where(valid_w, c, 0.0))
                  for c in d_w])


def _dot(a, p):
    return (p[0] * a[0] + p[1] * a[1]) + p[2] * a[2]


def _ray_of_thread(rows: int, device):
    """-> int64 (warps, 32): the ray each lane of each warp holds."""
    warp = warp_of_rays(rows, device).reshape(-1)
    order = torch.argsort(warp, stable=True)
    return order.reshape(-1, 32)


class WarpVotes(NamedTuple):
    """mesh_warp_masks' result. In each mask, bit b of word j stands for
    candidate slot 32 j + b of the warp's tile (its table index in an
    overflow tile); words = ceil(max(F, K) / 32)."""
    masks: torch.Tensor   # int32 (warps, words): the vote, as the kernel's
    boxed: torch.Tensor   # int32 (warps, words): the slots whose box passed
    empty: torch.Tensor   # bool (warps,): the warp's box is empty


def mesh_warp_masks(tri_packed, cand, counts, o2, d2, t_maxv, t_min: float,
                    box) -> WarpVotes:
    """The kernel's vote in plain PyTorch. A slot is voted where its
    triangle meets the warp's region: its box meets the warp's box (the
    min and max over the warp's lanes of their clipped segments' ends,
    _lane_clip, padded by mesh_candidates' eps of 1e-4; `boxed` holds the
    slots that pass this far) and its projection on each of the warp's oriented axes meets the
    range of the lanes' endpoints' projections, padded the same way. The
    kernel's arithmetic in its order (min and max are exact, so their
    reductions' order does not matter; the direction sum is the kernel's
    butterfly). A warp whose box is empty (no lane's segment meets the
    grid box) votes for nothing and, in the kernel, on no chunk."""
    tiles, K = cand.shape
    F_n = tri_packed.shape[0]
    rows = o2[0].shape[0]
    dev = o2[0].device
    tile_rays = o2[0].numel() // tiles
    lanes_of = _ray_of_thread(rows, dev)
    pa, pb, valid = _lane_clip(o2, d2, t_maxv, t_min, box)
    by_warp = [[c.reshape(-1)[lanes_of] for c in p] for p in (pa, pb)]
    valid_w = valid.reshape(-1)[lanes_of]
    eps = f32(1e-4)

    def warp_range(a, b):
        lo, hi = _ranges(a, b, valid_w)
        return lo.amin(dim=1) - eps, hi.amax(dim=1) + eps

    bounds = [warp_range(a, b) for a, b in zip(*by_warp)]
    empty = ~torch.stack([lo <= hi for lo, hi in bounds]).all(dim=0)
    axis = _warp_axes([c.reshape(-1)[lanes_of] for c in d2], valid_w)
    proj = [warp_range(_dot([c[:, None] for c in a], by_warp[0]),
                       _dot([c[:, None] for c in a], by_warp[1]))
            for a in axis]
    n_warps = lanes_of.shape[0]
    tile = torch.arange(n_warps, device=dev) * 32 // tile_rays
    over = counts > K
    n_slots = torch.where(over, F_n, torch.clamp(counts, max=K)).long()
    v0 = tri_packed[:, 0:3]
    p1 = v0 + tri_packed[:, 3:6]
    p2 = v0 + tri_packed[:, 6:9]
    tri_lo = torch.minimum(torch.minimum(v0, p1), p2)
    tri_hi = torch.maximum(torch.maximum(v0, p1), p2)
    n_words = -(-max(F_n, K) // 32)
    words = torch.zeros((2, n_warps, n_words), dtype=torch.int64, device=dev)
    bit = torch.arange(32, device=dev, dtype=torch.int64)
    for base in range(0, n_words * 32, VOTE_SLOTS):
        ks = torch.arange(base, min(base + VOTE_SLOTS, n_words * 32),
                          device=dev)
        ids = torch.where(over[:, None], torch.clamp(ks, max=F_n - 1),
                          cand[:, torch.clamp(ks, max=K - 1)].long())[tile]
        boxed = ks[None, :] < n_slots[tile][:, None]         # (warps, C)
        for ax, (lo, hi) in enumerate(bounds):
            boxed &= tri_lo[ids, ax] <= hi[:, None]
            boxed &= tri_hi[ids, ax] >= lo[:, None]
        keep = boxed.clone()
        verts = [[vt[ids, k] for k in range(3)] for vt in (v0, p1, p2)]
        for a, (lo, hi) in zip(axis, proj):
            t0, t1, t2 = (_dot([c[:, None] for c in a], vt) for vt in verts)
            keep &= torch.minimum(torch.minimum(t0, t1), t2) <= hi[:, None]
            keep &= torch.maximum(torch.maximum(t0, t1), t2) >= lo[:, None]
        for k, m in enumerate((keep, boxed)):
            packed = (m.reshape(n_warps, -1, 32).long() << bit).sum(dim=2)
            words[k, :, base // 32:base // 32 + packed.shape[1]] = packed
    words = (words - (words >= 2 ** 31).long() * 2 ** 32).to(torch.int32)
    return WarpVotes(words[0], words[1], empty)


# FP32 operations by hand count (csrc/mesh_tile.cu), per lane: the warp's
# box (warp_box: the slabs 36, `valid` 1, the endpoints 18, the warp's min
# and max 30, eps 6, the empty test 3), once per warp; its oriented axes
# (the direction sum 15, the normalisation 10, the reference axis 1, two
# cross products 18, u's normalisation 9, the endpoints' projections 30,
# their min and max 6, the warp's 30, eps 6), once per warp; one
# candidate's box against the warp's (tri_overlaps: per axis 2 adds, 2
# mins, 2 maxes, 2 compares), once per voted chunk of 32 candidates; its
# projections on the three axes (per axis 3 dots of 5, 2 mins, 2 maxes, 2
# compares), where its box passed; a Moller-Trumbore test.
MT_BOX_OPS, MT_AXES_BOX_OPS, MT_VOTE_OPS, MT_AXES_VOTE_OPS, MT_TEST_OPS = \
    94, 125, 24, 63, 50


def mesh_cull_count(args, votes: WarpVotes) -> dict:
    """One mesh call (mesh_tile's arguments) and its warps' votes
    (mesh_warp_masks) -> the work of the culled algorithm as the kernel
    runs it: lane-tests (each lane's voted candidates up to the last slot
    its scan takes to, as count_tests counts them), the chunks of 32
    candidates each warp votes on (up to the last slot any of its lanes
    takes to; none where its box is empty), warps, and the FP32
    operations by hand count (MT_*_OPS; the axes are tested on each voted
    chunk's candidates whose box passed)."""
    masks = votes.masks
    _, last, active = _mesh_scan(*args[:9], masks)
    warp = warp_of_rays(last.shape[0], last.device)
    tests = torch.where(active, _voted_up_to(masks, warp, last), 0)
    n_warps = masks.shape[0]
    reach = torch.full((n_warps,), -1, dtype=torch.int64, device=last.device)
    reach = reach.scatter_reduce(0, warp.reshape(-1),
                                 torch.where(active, last, -1).reshape(-1),
                                 "amax")
    chunks = torch.where((reach >= 0) & ~votes.empty, reach // 32 + 1, 0)
    lane_tests, vote_chunks = int(tests.sum()), int(chunks.sum())
    passed = int(_voted_up_to(votes.boxed,
                              torch.arange(n_warps, device=last.device),
                              chunks * 32 - 1).sum())
    ops = MT_TEST_OPS * lane_tests + MT_AXES_VOTE_OPS * passed + 32 * (
        MT_VOTE_OPS * vote_chunks + (MT_BOX_OPS + MT_AXES_BOX_OPS) * n_warps)
    return {"lane_tests": lane_tests, "vote_chunks": vote_chunks,
            "warps": n_warps, "ops": ops}


class MeshTileArgs(ctypes.Structure):
    """Arguments of mt_mesh_tile (csrc/mesh_tile.cu), passed by value."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "tri", "cand", "counts", "ox", "oy", "oz", "dx", "dy", "dz", "tmax",
        "t", "nsx", "nsy", "nsz", "ngx", "ngy", "ngz")] + \
        [(name, ctypes.c_int) for name in (
            "n_rays", "tile_rays", "K", "n_tris", "any_hit", "smooth")] + \
        [("t_min", ctypes.c_float), ("box_lo", ctypes.c_float * 3),
         ("box_hi", ctypes.c_float * 3)]


# the phases of the profiling instantiation, in csrc/mesh_tile.cu's order
MT_PHASE_NAMES = ("box", "vote", "test", "record", "write")


class MeshTileProf(ctypes.Structure):
    """The profiling instantiation's outputs (csrc/mesh_tile.cu)."""
    _fields_ = [("rec", ctypes.c_void_p), ("tests", ctypes.c_void_p),
                ("masks", ctypes.c_void_p), ("mask_words", ctypes.c_int)]


def mesh_tile_launcher(tri_packed, cand, counts, o2, d2, t_maxv,
                       t_min: float, smooth: bool, any_hit: bool, box,
                       profile: bool = False):
    """Prepare one launch of the mesh kernel on CUDA tensors -> (launch,
    outputs as mesh_tile returns them): launch() enqueues the kernel on the
    current stream and raises if the launch was refused. The wrapper
    launches once; chip_smoke.py times repeated launches. With profile,
    -> (launch, outputs, (rec, tests, masks)) of the profiling
    instantiation, which writes them at every launch: rec int64 (warps,
    len(MT_PHASE_NAMES), 3), per phase lane 0's cycles, the chunks voted
    on in the vote phase's second slot, the loop's trips and lane-tests in
    the test phase's; tests int32 like the rays, each lane's triangle
    tests; masks int32 (warps, words), every chunk's vote, as
    mesh_warp_masks gives it. `box` is the mesh's grid box (grid_box)."""
    from surfjax_torch.kernels import _build
    _check_inputs(tri_packed, cand, counts, o2, d2, t_maxv)
    rays = [r.contiguous() for r in list(o2) + list(d2) + [t_maxv]]
    shape, dev = rays[0].shape, rays[0].device
    tiles, K = cand.shape
    tables = [a.contiguous() for a in (tri_packed, cand, counts)]
    out = torch.empty((7,) + tuple(shape), dtype=torch.float32, device=dev)
    ptrs = [a.data_ptr() for a in tables + rays] + \
        [out[k].data_ptr() for k in range(7)]
    args = MeshTileArgs(*ptrs, n_rays=shape[0] * shape[1],
                        tile_rays=(shape[0] // tiles) * shape[1], K=K,
                        n_tris=tri_packed.shape[0], any_hit=int(any_hit),
                        smooth=int(smooth), t_min=f32(t_min))
    args.box_lo[:], args.box_hi[:] = box
    outs = (out[0], (out[1], out[2], out[3]), (out[4], out[5], out[6]))
    lib = _build.load()
    if profile:
        n_warps = out[0].numel() // 32
        words = -(-max(tri_packed.shape[0], K) // 32)
        rec = torch.zeros((n_warps, len(MT_PHASE_NAMES), 3),
                          dtype=torch.int64, device=dev)
        tests = torch.zeros(shape, dtype=torch.int32, device=dev)
        masks = torch.zeros((n_warps, words), dtype=torch.int32, device=dev)
        prof = MeshTileProf(rec.data_ptr(), tests.data_ptr(),
                            masks.data_ptr(), words)
        name = "mt_mesh_tile_profile"
        call = lambda stream: lib.mt_mesh_tile_profile(  # noqa: E731
            args, prof, dev.index, stream)
    else:
        name = "mt_mesh_tile"
        call = lambda stream: lib.mt_mesh_tile(  # noqa: E731
            args, dev.index, stream)

    def launch():
        with torch.cuda.device(dev):
            err = call(ctypes.c_void_p(
                torch.cuda.current_stream(dev).cuda_stream))
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError "
                               f"{err} ({_build.error_string(err)})")
        # the arrays the kernel reads stay alive as long as launch does
        return tables, rays, out

    if profile:
        return launch, outs, (rec, tests, masks)
    return launch, outs


@annotate("surfjax_torch.kernel.mesh_tile")
def mesh_tile(tri_packed, cand, counts, o2, d2, t_maxv, t_min: float,
              smooth: bool, any_hit: bool, box=None):
    """The mesh kernel over (rows, 128) rays and a tile's candidates ->
    the outputs of mesh_tile_reference. `box` is the mesh's grid box
    (grid_box), which the kernel's cull clips rays to: the kernel needs
    it, the plain version does not read it.

    CUDA tensors launch the hand-written kernel (counted in
    `mesh_tile.launches`); CPU tensors run the plain version. Anything
    else raises."""
    _check_inputs(tri_packed, cand, counts, o2, d2, t_maxv)
    dev = o2[0].device
    args = (tri_packed, cand, counts, o2, d2, t_maxv, t_min, smooth,
            any_hit, box)
    record_call("mesh_tile", args)
    if dev.type == "cuda":
        if box is None:
            raise ValueError("the mesh kernel needs the mesh's grid box "
                             "(grid_box)")
        launch, out = mesh_tile_launcher(*args)
        launch()
        mesh_tile.launches += 1
        return out
    if dev.type == "cpu":
        return mesh_tile_reference(*args)
    raise ValueError(f"unsupported device {dev}")


mesh_tile.launches = 0


def mesh_tile_kernel(ms, settings, tri_packed, o2, d2, t_max,
                     any_hit: bool = False):
    """Packet mesh intersection over (rows, 128)-tiled rays -> (t,
    n_shade (3), n_geom (3)); t == BIG on a miss. t_max may be a per-lane
    tensor (the shadow distance)."""
    # shadow (any-hit) rays accept from shadow_eps, not t_min, so their
    # candidate segments start there too
    t_seg_min = settings.shadow_eps if any_hit else settings.t_min
    t_maxv = per_lane(o2[0], t_max)
    cand, counts = mesh_candidates(ms, tri_packed, o2, d2, t_seg_min, t_maxv,
                                   settings.tile_rows)
    return mesh_tile(tri_packed, cand, counts, o2, d2, t_maxv, t_seg_min,
                     ms.smooth, any_hit, grid_box(ms))
