"""Packet (per-tile) triangle-mesh intersection: the counterpart of
`surfjax/kernels/mesh_tile.py`.

  1. `mesh_candidates` (tensor code): every ray is clipped to the mesh's
     grid box; a tile's frustum is the AABB of its lanes' entry/exit
     segment endpoints, refined by three oriented separating axes. The
     candidate triangles of a tile are those whose AABB and projections
     overlap it, compacted into a (tiles, K) index table. The sets are
     conservative, so the nearest hit over a tile's candidates equals the
     brute-force nearest hit.
  2. `mesh_tile`, the wrapper of the hand-written CUDA kernel
     (csrc/mesh_tile.cu) with its plain version `mesh_tile_reference`:
     Moller-Trumbore of every ray of a tile against the tile's candidates
     in ascending order, keeping the nearest hit (strict <, so ties go to
     the lowest triangle index) with its barycentric shading normal and
     geometric normal; or, for shadow rays, any hit. A tile whose count
     exceeds K scans the full packed table instead.

The candidate scheme exists because element gathers were slow on the TPU.
The port keeps it: it is what the reference computes, and on the GPU a
tile's candidates are staged through shared memory.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from surfjax_torch.core.math import BIG, f32, sqrt
from surfjax_torch.engines.mesh import moller_trumbore, per_lane
from surfjax_torch.kernels import record_call

PACKET_K = 1024  # candidate budget per tile; overflow -> full-table scan
# Above this triangle count the reference routes a mesh through the grid
# DDA (engines/mesh.intersect_mesh) instead of the packet kernel, with a
# warning; the port keeps that routing.
MAX_PACKET_TRIS = 40_000
ROW_W = 24       # packed triangle row: v0, e1, e2, gn, n0, n1, n2, pad


def mesh_candidates(ms, tri_packed, o2, d2, t_min, t_max, tile_rows: int,
                    K: int = PACKET_K):
    """-> (cand (tiles, K) int32 triangle ids, counts (tiles,) int32).

    Conservative per-tile candidate sets by segment-AABB culling plus
    three oriented axes. Slots at and above a tile's count hold the last
    triangle, as in the reference; a count above K means overflow."""
    rows, lanes = o2[0].shape
    tiles = rows // tile_rows
    bmin = [np.float32(v) for v in ms.bbox_min]
    bext = [np.float32(ms.cell_size[0] * ms.nx),
            np.float32(ms.cell_size[1] * ms.ny),
            np.float32(ms.cell_size[2] * ms.nz)]
    bmax = [float(bmin[ax] + bext[ax]) for ax in range(3)]
    bmin = [float(v) for v in bmin]

    # per-lane ray/box clip (slab)
    t_lo = torch.full_like(o2[0], f32(t_min))
    t_hi = per_lane(o2[0], t_max)
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
    valid = t_lo <= t_hi

    # segment endpoints; invalid lanes contribute empty boxes
    pa = [o2[ax] + t_lo * d2[ax] for ax in range(3)]
    pb = [o2[ax] + t_hi * d2[ax] for ax in range(3)]

    def tile_range(a_lane, b_lane):
        lo = torch.where(valid, torch.minimum(a_lane, b_lane), BIG)
        hi = torch.where(valid, torch.maximum(a_lane, b_lane), -BIG)
        return (lo.reshape(tiles, -1).amin(dim=1),
                hi.reshape(tiles, -1).amax(dim=1))

    # triangle boxes from the packed v0/e1/e2
    v0 = tri_packed[:, 0:3]
    p1 = v0 + tri_packed[:, 3:6]
    p2 = v0 + tri_packed[:, 6:9]
    tri_lo = torch.minimum(torch.minimum(v0, p1), p2)
    tri_hi = torch.maximum(torch.maximum(v0, p1), p2)

    eps = f32(1e-4)
    overlap = torch.ones((tiles, tri_packed.shape[0]), dtype=torch.bool,
                         device=o2[0].device)
    for ax in range(3):
        lo, hi = tile_range(pa[ax], pb[ax])
        overlap &= tri_lo[None, :, ax] <= hi[:, None] + eps
        overlap &= tri_hi[None, :, ax] >= lo[:, None] - eps

    # Oriented refinement: the mean segment direction of the tile and two
    # orthogonals as separating axes. Any axis is sound (the segments'
    # projections lie inside their endpoints' projection hull); the eps
    # guards rounding. The projections are written out in float32 with
    # no matrix product, so neither bf16 nor TF32 can shrink a triangle's
    # projected range (surfjax pins HIGHEST for that reason: a bf16
    # projection culled true hits on its device).
    dsum = [torch.where(valid, d2[ax], 0.0).reshape(tiles, -1).sum(dim=1)
            for ax in range(3)]
    nrm = sqrt((dsum[0] * dsum[0] + dsum[1] * dsum[1]) + dsum[2] * dsum[2])
    ok = nrm > f32(1e-6)
    w = torch.stack([torch.where(ok, dsum[ax] / torch.where(ok, nrm, 1.0),
                                 1.0 if ax == 0 else 0.0)
                     for ax in range(3)], dim=1)              # (tiles, 3)
    ref = torch.zeros_like(w)
    big_y = torch.abs(w[:, 1]) >= f32(0.9)
    ref[:, 0] = torch.where(big_y, 1.0, 0.0)
    ref[:, 1] = torch.where(big_y, 0.0, 1.0)
    u = torch.linalg.cross(w, ref, dim=1)
    u = u / sqrt((u[:, 0:1] * u[:, 0:1] + u[:, 1:2] * u[:, 1:2])
                 + u[:, 2:3] * u[:, 2:3])
    v = torch.linalg.cross(w, u, dim=1)
    verts = (v0, p1, p2)
    for a in (w, u, v):
        tproj = [(a[:, 0:1] * vt[None, :, 0] + a[:, 1:2] * vt[None, :, 1])
                 + a[:, 2:3] * vt[None, :, 2] for vt in verts]
        tpro_lo = torch.minimum(torch.minimum(tproj[0], tproj[1]), tproj[2])
        tpro_hi = torch.maximum(torch.maximum(tproj[0], tproj[1]), tproj[2])
        sa, sb = ((q[0].reshape(tiles, -1) * a[:, 0:1]
                   + q[1].reshape(tiles, -1) * a[:, 1:2])
                  + q[2].reshape(tiles, -1) * a[:, 2:3] for q in (pa, pb))
        slo, shi = tile_range(sa.reshape(o2[0].shape),
                              sb.reshape(o2[0].shape))
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
                      device=o2[0].device)
    cand[t_idx[keep], s_idx[keep].long()] = f_idx[keep].to(torch.int32)
    return cand, counts


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
                        t_min: float, smooth: bool, any_hit: bool,
                        count_tests: bool = False):
    """Plain PyTorch version of the mesh kernel over (rows, 128) rays.

    -> (t, ns (3), ng (3)): nearest hit (ties to the lowest candidate
    slot) with its shading and geometric normals, or for any_hit the t
    of the first occluder in candidate order and no normals; t == BIG on
    a miss and the normals (0, 0, 1) where nothing was recorded. Both are
    the kernel's results to the bit. With count_tests, also the per-lane
    number of triangle tests the kernel needs: every candidate for a
    nearest-hit lane, up to the first occluder for an any-hit lane, none
    for a lane whose segment is empty (t_max <= t_min).

    Candidates are taken in chunks: each (ray, triangle) test is the
    kernel's arithmetic, and a chunk's first minimum (or first hit) is
    merged with strict <, which is what a scan in order keeps."""
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
    if not count_tests:
        return out
    active = ~(t_max[:, 0] <= tmin)
    nv = n_valid[:, None] * torch.ones_like(first)
    tests = torch.where(first >= 0, first + 1, nv) if any_hit else nv
    return out + (torch.where(active, tests, 0).reshape(shape),)


class MeshTileArgs(ctypes.Structure):
    """Arguments of mt_mesh_tile (csrc/mesh_tile.cu), passed by value."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "tri", "cand", "counts", "ox", "oy", "oz", "dx", "dy", "dz", "tmax",
        "t", "nsx", "nsy", "nsz", "ngx", "ngy", "ngz")] + \
        [(name, ctypes.c_int) for name in (
            "n_rays", "tile_rays", "K", "n_tris", "any_hit", "smooth")] + \
        [("t_min", ctypes.c_float)]


def mesh_tile_launcher(tri_packed, cand, counts, o2, d2, t_maxv,
                       t_min: float, smooth: bool, any_hit: bool):
    """Prepare one launch of the mesh kernel on CUDA tensors -> (launch,
    outputs as mesh_tile returns them): launch() enqueues the kernel on the
    current stream and raises if the launch was refused. The wrapper
    launches once; chip_smoke.py times repeated launches."""
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
    fn = _build.load().mt_mesh_tile

    def launch():
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(args, dev.index, ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"mt_mesh_tile launch failed: cudaError "
                               f"{err} ({_build.error_string(err)})")
        # the arrays the kernel reads stay alive as long as launch does
        return tables, rays

    return launch, (out[0], (out[1], out[2], out[3]),
                    (out[4], out[5], out[6]))


def mesh_tile(tri_packed, cand, counts, o2, d2, t_maxv, t_min: float,
              smooth: bool, any_hit: bool):
    """The mesh kernel over (rows, 128) rays and a tile's candidates ->
    the outputs of mesh_tile_reference.

    CUDA tensors launch the hand-written kernel (counted in
    `mesh_tile.launches`); CPU tensors run the plain version. Anything
    else raises."""
    _check_inputs(tri_packed, cand, counts, o2, d2, t_maxv)
    dev = o2[0].device
    record_call("mesh_tile", (tri_packed, cand, counts, o2, d2, t_maxv,
                              t_min, smooth, any_hit))
    if dev.type == "cuda":
        launch, out = mesh_tile_launcher(tri_packed, cand, counts, o2, d2,
                                         t_maxv, t_min, smooth, any_hit)
        launch()
        mesh_tile.launches += 1
        return out
    if dev.type == "cpu":
        return mesh_tile_reference(tri_packed, cand, counts, o2, d2, t_maxv,
                                   t_min, smooth, any_hit)
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
    cand, counts = mesh_candidates(ms, tri_packed, o2, d2, t_seg_min, t_max,
                                   settings.tile_rows)
    return mesh_tile(tri_packed, cand, counts, o2, d2,
                     per_lane(o2[0], t_max), t_seg_min, ms.smooth, any_hit)
