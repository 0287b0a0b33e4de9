"""Triangle-mesh engine: uniform-grid traversal + Moller-Trumbore +
barycentric shading. Counterpart of `surfjax/engines/mesh.py`.

Host side (`build_grid`): triangles are binned into a uniform voxel grid in
CSR layout (cell_start prefix + flat cell_tris), plus the Moller-Trumbore
edge vectors, area-weighted vertex normals and the packed (F, 24) rows the
packet kernel reads. surfjax bins through its own C++ library; the port
bins in numpy and produces the same CSR (triangles ascending per cell).

Device side (`intersect_mesh`, `mesh_normal`): the grid DDA and the
barycentric normal as eager tensor code. The DDA steps every live ray one
cell per trip and tests that cell's padded triangle list.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from surfjax_torch.core.math import BIG, f32, fdiv, sqrt


class MeshStatic(NamedTuple):
    nx: int
    ny: int
    nz: int
    n_tris: int
    len_cell_tris: int
    k_max: int                 # padded per-step triangle tests
    bbox_min: Tuple[float, float, float]
    cell_size: Tuple[float, float, float]
    smooth: bool


class MeshTables(NamedTuple):
    static: MeshStatic
    arrays: Dict[str, np.ndarray]


def _bin_triangles(v0, v1, v2, bb_min, cell, nx: int, ny: int, nz: int):
    """Conservative AABB overlap of every triangle with the grid cells ->
    (cell counts, cell_tris), triangles ascending within each cell."""
    dims = [nx - 1, ny - 1, nz - 1]
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    lo = np.clip(((tmin - bb_min) / cell).astype(np.int64), 0, dims)
    hi = np.clip(((tmax - bb_min) / cell).astype(np.int64), 0, dims)
    ext = hi - lo + 1
    per = ext.prod(axis=1)
    f_ids = np.repeat(np.arange(v0.shape[0]), per)
    k = np.arange(per.sum()) - np.repeat(np.cumsum(per) - per, per)
    ey, ez = ext[f_ids, 1], ext[f_ids, 2]
    ix = lo[f_ids, 0] + k // (ey * ez)
    iy = lo[f_ids, 1] + (k // ez) % ey
    iz = lo[f_ids, 2] + k % ez
    cid = (ix * ny + iy) * nz + iz
    order = np.argsort(cid, kind="stable")   # keeps f ascending per cell
    counts = np.bincount(cid, minlength=nx * ny * nz).astype(np.int32)
    return counts, f_ids[order].astype(np.int32)


def build_grid(mesh, grid_res=None) -> MeshTables:
    """Host-side uniform-grid build over a TriangleMesh."""
    verts = np.asarray(mesh.vertices, np.float32)
    faces = np.asarray(mesh.faces, np.int32)
    F = faces.shape[0]
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    e1 = v1 - v0
    e2 = v2 - v0
    gn = np.cross(e1, e2)  # area-weighted geometric normals
    gl = np.sqrt((gn * gn).sum(-1, keepdims=True))
    gnn = gn / np.maximum(gl, 1e-20)

    # area-weighted vertex normals for barycentric (smooth) shading
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], gn)
    vl = np.sqrt((vn * vn).sum(-1, keepdims=True))
    vn = vn / np.maximum(vl, 1e-20)

    bb_min = verts.min(0)
    bb_max = verts.max(0)
    extent = np.maximum(bb_max - bb_min, 1e-6)
    pad = extent * 1e-3 + 1e-6
    bb_min = bb_min - pad
    bb_max = bb_max + pad
    extent = bb_max - bb_min

    if grid_res is None:
        grid_res = getattr(mesh, "grid_res", None)
    if grid_res is None:
        n = max(int(np.ceil((2.0 * F) ** (1.0 / 3.0))), 1)
        grid_res = (n, n, n)
    nx, ny, nz = (int(v) for v in grid_res)
    cell = extent / np.asarray([nx, ny, nz], np.float32)

    counts, cell_tris = _bin_triangles(v0, v1, v2, bb_min, cell, nx, ny, nz)
    cell_start = np.zeros(nx * ny * nz + 1, np.int32)
    np.cumsum(counts, out=cell_start[1:])
    if not cell_tris.size:
        cell_tris = np.zeros(1, np.int32)
    # every cell's full list must be testable: truncation makes holes
    k_max = int(max(counts.max(), 1))

    # packed per-triangle rows for the packet kernel
    # (v0, e1, e2, gn, n0, n1, n2, pad) -> (F, 24)
    gn32 = gnn.astype(np.float32)
    vn32 = vn.astype(np.float32)
    tri_packed = np.concatenate(
        [v0, e1, e2, gn32, vn32[faces[:, 0]], vn32[faces[:, 1]],
         vn32[faces[:, 2]], np.zeros((F, 3), np.float32)],
        axis=1).astype(np.float32)

    arrays = {
        "tri_v0": v0, "tri_e1": e1, "tri_e2": e2,
        "tri_n": gn32,
        "vert_n": vn32,
        "faces": faces,
        "verts": verts,
        "cell_start": cell_start,
        "cell_tris": cell_tris,
        "tri_packed": tri_packed,
    }
    static = MeshStatic(nx, ny, nz, F, int(cell_tris.shape[0]), k_max,
                        tuple(float(x) for x in bb_min),
                        tuple(float(x) for x in cell),
                        bool(getattr(mesh, "smooth", True)))
    return MeshTables(static, arrays)


def _mesh_arrays(params, mesh_idx):
    # keys are mesh{i}_{name} with a name that starts with a letter, so a
    # digit check keeps mesh1_ from matching mesh10_* keys
    pre = f"mesh{mesh_idx}_"
    return {k[len(pre):]: v for k, v in params.items()
            if k.startswith(pre) and not k[len(pre)].isdigit()}


def clamp_ids(ids, n: int):
    """int64 gather indices clamped to [0, n - 1]."""
    return torch.clamp(ids.long(), 0, n - 1)


def per_lane(like, value) -> torch.Tensor:
    """A float32 per-lane tensor from a tensor or a Python float."""
    if isinstance(value, torch.Tensor):
        return value * torch.ones_like(like)
    return torch.full_like(like, f32(value))


def intersect_mesh(ms: MeshStatic, mesh_idx: int, params, o, d,
                   t_min, t_max):
    """Nearest mesh hit for a flat ray batch -> (t, tri_id int32); t is
    BIG on a miss. t_max may be a per-ray tensor."""
    a = _mesh_arrays(params, mesh_idx)
    tri_v0, tri_e1, tri_e2 = a["tri_v0"], a["tri_e1"], a["tri_e2"]
    cell_start = a["cell_start"].long()
    cell_tris = a["cell_tris"].long()
    dims = (ms.nx, ms.ny, ms.nz)
    bmin = [np.float32(v) for v in ms.bbox_min]
    cs = [np.float32(v) for v in ms.cell_size]
    eps = f32(1e-7)

    # ray / grid-AABB clip (slab test)
    t_enter = torch.full_like(o[0], f32(t_min))
    t_max_v = per_lane(o[0], t_max)
    t_exit = t_max_v
    for ax in range(3):
        lo = float(bmin[ax])
        hi = float(bmin[ax] + cs[ax] * np.float32(dims[ax]))
        dz = d[ax] == 0.0
        inv = 1.0 / torch.where(dz, 1.0, d[ax])
        ta = (lo - o[ax]) * inv
        tb = (hi - o[ax]) * inv
        tn = torch.minimum(ta, tb)
        tf = torch.maximum(ta, tb)
        in_slab = (o[ax] > lo) & (o[ax] < hi)
        tn = torch.where(dz, torch.where(in_slab, -BIG, BIG), tn)
        tf = torch.where(dz, torch.where(in_slab, BIG, -BIG), tf)
        t_enter = torch.maximum(t_enter, tn)
        t_exit = torch.minimum(t_exit, tf)
    alive = t_enter <= t_exit

    # initial cell + DDA state
    t0 = t_enter + f32(1e-5)
    cell, step, tmax_ax, tdelta = [], [], [], []
    for ax in range(3):
        pc = o[ax] + t0 * d[ax]
        c = torch.floor(fdiv(pc - float(bmin[ax]), float(cs[ax])))
        # clamp before the cast: lanes far outside the grid are dead
        ic = torch.clamp(c, -1.0, float(dims[ax])).to(torch.int64)
        ic = torch.clamp(ic, 0, dims[ax] - 1)
        dz = d[ax] == 0.0
        pos = d[ax] > 0.0
        step.append(torch.where(pos, 1, torch.where(dz, 0, -1)))
        nxt = torch.where(pos, ic + 1, ic).to(torch.float32)
        bound = float(bmin[ax]) + nxt * float(cs[ax])
        inv = 1.0 / torch.where(dz, 1.0, d[ax])
        tmax_ax.append(torch.where(dz, BIG, (bound - o[ax]) * inv))
        tdelta.append(torch.where(dz, BIG, torch.abs(float(cs[ax]) * inv)))
        cell.append(ic)

    t_best = torch.full_like(o[0], BIG)
    tri_best = torch.zeros_like(o[0], dtype=torch.int64)
    n_cells = dims[0] * dims[1] * dims[2]
    t_max_cell = t_max_v
    for _ in range(dims[0] + dims[1] + dims[2] + 3):
        if not bool(alive.any()):
            break
        ix, iy, iz = cell
        cid = torch.clamp((ix * dims[1] + iy) * dims[2] + iz, 0, n_cells - 1)
        start = cell_start[cid]
        cnt = cell_start[cid + 1] - start
        t_cell_exit = torch.minimum(torch.minimum(tmax_ax[0], tmax_ax[1]),
                                    tmax_ax[2])
        t_hi = torch.minimum(t_cell_exit + f32(1e-4), t_max_cell)
        for j in range(ms.k_max):
            slot = torch.clamp(start + j, 0, ms.len_cell_tris - 1)
            ti = cell_tris[slot]
            valid = alive & (j < cnt)
            v0, e1, e2 = (a[ti].unbind(1) for a in (tri_v0, tri_e1, tri_e2))
            t, ok, u, v = moller_trumbore(o, d, v0, e1, e2, eps)
            hit = (valid & ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                   & (t > f32(t_min)) & (t < t_hi) & (t < t_best))
            t_best = torch.where(hit, t, t_best)
            tri_best = torch.where(hit, ti, tri_best)
        found = t_best < f32(BIG * 0.5)
        # step to the next cell (axis of the smallest tmax)
        tmx, tmy, tmz = tmax_ax
        x_min = (tmx <= tmy) & (tmx <= tmz)
        y_min = (~x_min) & (tmy <= tmz)
        z_min = (~x_min) & (~y_min)
        for ax, sel in enumerate((x_min, y_min, z_min)):
            mv = alive & sel
            cell[ax] = torch.where(mv, cell[ax] + step[ax], cell[ax])
            tmax_ax[ax] = torch.where(mv, tmax_ax[ax] + tdelta[ax],
                                      tmax_ax[ax])
        inside = torch.ones_like(alive)
        for ax in range(3):
            inside = inside & (cell[ax] >= 0) & (cell[ax] < dims[ax])
        alive = alive & inside & (~found) & (t_cell_exit < t_exit)
    return t_best, tri_best.to(torch.int32)


def moller_trumbore(o, d, v0, e1, e2, eps: float):
    """Branch-free Moller-Trumbore of rays o + t d against triangles (v0,
    edges e1, e2), every argument a component triple of broadcastable
    tensors -> (t, ok, u, v), in surfjax's association. ok is False for a
    ray parallel to the triangle's plane."""
    pvx = d[1] * e2[2] - d[2] * e2[1]
    pvy = d[2] * e2[0] - d[0] * e2[2]
    pvz = d[0] * e2[1] - d[1] * e2[0]
    det = (e1[0] * pvx + e1[1] * pvy) + e1[2] * pvz
    ok = torch.abs(det) > eps
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tvx = o[0] - v0[0]
    tvy = o[1] - v0[1]
    tvz = o[2] - v0[2]
    u = ((tvx * pvx + tvy * pvy) + tvz * pvz) * inv_det
    qvx = tvy * e1[2] - tvz * e1[1]
    qvy = tvz * e1[0] - tvx * e1[2]
    qvz = tvx * e1[1] - tvy * e1[0]
    v = ((d[0] * qvx + d[1] * qvy) + d[2] * qvz) * inv_det
    t = ((e2[0] * qvx + e2[1] * qvy) + e2[2] * qvz) * inv_det
    return t, ok, u, v


def mesh_normal(ms: MeshStatic, mesh_idx: int, params, p, tri_id):
    """Shading normal at hit points: barycentric-interpolated vertex
    normals when smooth, geometric otherwise. Ids out of range (lanes won
    by another object) are clamped, as JAX clamps a gather."""
    a = _mesh_arrays(params, mesh_idx)
    tri_id = clamp_ids(tri_id, ms.n_tris)
    if not ms.smooth:
        n = a["tri_n"][tri_id]
        return (n[:, 0], n[:, 1], n[:, 2])
    faces = a["faces"].long()[tri_id]
    v0 = a["tri_v0"][tri_id]
    e1 = a["tri_e1"][tri_id]
    e2 = a["tri_e2"][tri_id]
    # barycentric coords of p in the hit triangle (project onto edges)
    wx = p[0] - v0[:, 0]
    wy = p[1] - v0[:, 1]
    wz = p[2] - v0[:, 2]
    d11 = (e1[:, 0] * e1[:, 0] + e1[:, 1] * e1[:, 1]) + e1[:, 2] * e1[:, 2]
    d12 = (e1[:, 0] * e2[:, 0] + e1[:, 1] * e2[:, 1]) + e1[:, 2] * e2[:, 2]
    d22 = (e2[:, 0] * e2[:, 0] + e2[:, 1] * e2[:, 1]) + e2[:, 2] * e2[:, 2]
    dw1 = (wx * e1[:, 0] + wy * e1[:, 1]) + wz * e1[:, 2]
    dw2 = (wx * e2[:, 0] + wy * e2[:, 1]) + wz * e2[:, 2]
    denom = d11 * d22 - d12 * d12
    denom = torch.where(torch.abs(denom) < f32(1e-20), f32(1e-20), denom)
    u = (d22 * dw1 - d12 * dw2) / denom
    v = (d11 * dw2 - d12 * dw1) / denom
    w = 1.0 - u - v
    vn = a["vert_n"]
    n0 = vn[faces[:, 0]]
    n1 = vn[faces[:, 1]]
    n2 = vn[faces[:, 2]]
    nxs = (w * n0[:, 0] + u * n1[:, 0]) + v * n2[:, 0]
    nys = (w * n0[:, 1] + u * n1[:, 1]) + v * n2[:, 1]
    nzs = (w * n0[:, 2] + u * n1[:, 2]) + v * n2[:, 2]
    inv = 1.0 / sqrt((nxs * nxs + nys * nys) + nzs * nzs)
    return (nxs * inv, nys * inv, nzs * inv)
