"""Ring-sharded triangle-mesh intersection: the counterpart of
`surfjax/parallel/ring_mesh.py`, for a mesh that does not fit on every
device.

The triangle table is split into D shards over the ring's ranks; each
rank keeps its own ray range and folds the shard it holds into its
running nearest hit, then passes the shard one hop on (send to rank r+1,
receive from r-1, `torch.distributed.batch_isend_irecv`), D folds in all.
The nearest hit is the lexicographic minimum over (t, global triangle
id), which no order of the shards changes, so the result is bitwise
equal to one pass over the whole table with the same Moller-Trumbore
arithmetic (`engines/mesh.py::moller_trumbore`, surfjax's association).

surfjax computes this in plain jnp outside any Pallas kernel; here it is
plain torch. Brute force per shard, as in surfjax: O(rays/D x n_tris) per
rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from surfjax_torch.core.math import BIG, f32
from surfjax_torch.engines.mesh import MeshTables, moller_trumbore
from surfjax_torch.parallel.mesh import (
    _comm, all_gather_cat, rank_device, shard_range,
)

_MT_EPS = 1e-7  # the determinant guard of engines/mesh.py::intersect_mesh
NO_ID = 2 ** 30  # the running minimum's id before any hit


def shard_triangles(tables: MeshTables, n_shards: int) -> dict:
    """Split a built mesh's Moller-Trumbore tables into n_shards equal
    shards, padded with degenerate (never-hit) triangles; each shard
    carries its triangles' global ids, n_tris for padding -> dict of
    (n_shards, S[, 3]) numpy arrays and "n_tris"."""
    a = tables.arrays
    v0 = np.asarray(a["tri_v0"], np.float32)
    e1 = np.asarray(a["tri_e1"], np.float32)
    e2 = np.asarray(a["tri_e2"], np.float32)
    n = v0.shape[0]
    S = -(-n // n_shards)
    pad = n_shards * S - n

    def padded(x):
        # zero edges give det == 0, which never passes |det| > eps
        return np.concatenate(
            [x, np.zeros((pad,) + x.shape[1:], x.dtype)], 0
        ).reshape(n_shards, S, *x.shape[1:])

    ids = np.concatenate([np.arange(n, dtype=np.int32),
                          np.full(pad, n, np.int32)])
    return {"v0": padded(v0), "e1": padded(e1), "e2": padded(e2),
            "ids": ids.reshape(n_shards, S), "n_tris": n}


def _mt_shard(o, d, v0, e1, e2, ids, t_min, t_max, t_best, tri_best,
              chunk: int = 64):
    """Fold one triangle shard (v0, e1, e2 (S, 3), ids (S,)) into the
    running (t_best, tri_best) of a flat ray batch, chunk triangles at a
    time: surfjax's arithmetic, with the id tie-break that makes the
    reduction exact. t_max: a per-ray tensor."""
    S = v0.shape[0]
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    if pad:
        v0 = torch.cat([v0, v0.new_zeros((pad, 3))])
        e1 = torch.cat([e1, e1.new_zeros((pad, 3))])
        e2 = torch.cat([e2, e2.new_zeros((pad, 3))])
        ids = torch.cat([ids, ids.new_full((pad,), NO_ID)])
    oc = tuple(c[:, None] for c in o)
    dc = tuple(c[:, None] for c in d)
    tmax = t_max[:, None]
    for k in range(n_chunks):
        sl = slice(k * chunk, (k + 1) * chunk)
        tri = tuple(tuple(a[sl, j][None, :] for j in range(3))
                    for a in (v0, e1, e2))
        t, ok, u, v = moller_trumbore(oc, dc, *tri, f32(_MT_EPS))
        hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
               & (t > f32(t_min)) & (t < tmax))
        # lexicographic (t, id) running minimum over this chunk
        t_hit = torch.where(hit, t, BIG)
        id_hit = torch.where(hit, ids[sl][None, :], NO_ID)
        t_c = t_hit.min(dim=1).values
        id_c = torch.where(t_hit <= t_c[:, None], id_hit,
                           NO_ID).min(dim=1).values
        better = (t_c < t_best) | ((t_c == t_best) & (id_c < tri_best))
        t_best = torch.where(better, t_c, t_best)
        tri_best = torch.where(better, id_c, tri_best)
    return t_best, tri_best


def _rotate(tensors, group):
    """One hop around the ring: send each tensor to the next rank of the
    group, receive the previous rank's -> the received tensors, on the
    device of the ones sent."""
    D = group.size()
    me = dist.get_group_rank(group, dist.get_rank())
    nxt = dist.get_global_rank(group, (me + 1) % D)
    prv = dist.get_global_rank(group, (me - 1) % D)
    out, ops = [], []
    for t in tensors:
        src = _comm(t, group)
        buf = torch.empty_like(src)
        ops += [dist.P2POp(dist.isend, src, nxt, group),
                dist.P2POp(dist.irecv, buf, prv, group)]
        out.append(buf)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [b.to(t.device) for b, t in zip(out, tensors)]


def ring_trace(shards, o, d, t_min, t_max, mesh: DeviceMesh,
               axis: str = "shard"):
    """Nearest mesh hit over the ring of the mesh's `axis`. `shards` from
    shard_triangles(n_shards = the ring's size); o, d the whole flat ray
    batch (component triples; their length must split into equal ranges
    over the ring), the same on every rank. Each rank traces its range
    against every shard in turn -> (t, tri) of the whole batch on every
    rank, on its device: t == BIG and tri == n_tris on a miss. Bitwise
    equal to a single-device pass over the full table."""
    group = mesh.get_group(axis)
    D = group.size()
    r = dist.get_group_rank(group, dist.get_rank())
    dev = rank_device(mesh.device_type)
    n_tris = shards["n_tris"]
    ray = lambda c: torch.as_tensor(c, dtype=torch.float32, device=dev)
    o = tuple(ray(c) for c in o)
    d = tuple(ray(c) for c in d)
    sl = shard_range(o[0].shape[0], r, D)
    o_l = tuple(c[sl] for c in o)
    d_l = tuple(c[sl] for c in d)
    tmax = (ray(t_max) * torch.ones_like(o[0]))[sl]
    res = [torch.as_tensor(shards[k][r], device=dev)
           for k in ("v0", "e1", "e2", "ids")]
    t_best = torch.full_like(o_l[0], BIG)
    tri_best = torch.full_like(o_l[0], NO_ID, dtype=torch.int32)
    for step in range(D):
        t_best, tri_best = _mt_shard(o_l, d_l, *res, t_min, tmax, t_best,
                                     tri_best)
        if step + 1 < D:
            res = _rotate(res, group)
    t = all_gather_cat(t_best, group)
    tri = all_gather_cat(tri_best, group)
    return t, torch.where(t < f32(BIG * 0.5), tri, n_tris).to(torch.int32)
