"""The port's packet mesh intersection (kernels/mesh_tile.py): candidate
culling, the plain version of the mesh kernel, and the wrapper.

  * the candidate sets are conservative (the check of
    tests/test_mesh.py::test_mesh_candidates_conservative, at R 16 and 64);
  * the plain version equals a numpy brute force over all triangles in the
    same association: the nearest hit and its normals bitwise, the
    any-hit occluder (the first in triangle order) bitwise too;
  * against surfjax's mesh_tile_kernel in interpret mode: hit masks
    equal, t within 1e-5 relative, normals within 1e-4 on all but at most
    8 lanes per 4096 (shared edges, where XLA:CPU's fused arithmetic may
    pick the neighbour), and the any-hit masks equal;
  * the whole split slice on c4 (render with backend="pallas" on the CPU)
    against surfjax's pallas render, held to the bounds
    tests/test_mesh.py holds surfjax to against its golden oracle.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import surfjax.api as sj_api  # noqa: E402
from surfjax.kernels.mesh_tile import (  # noqa: E402
    mesh_tile_kernel as sj_mesh_tile_kernel,
)
from surfjax.pipeline.frame import render_sequence as sj_rs  # noqa: E402

from surfjax_torch.core.math import BIG  # noqa: E402
from surfjax_torch.core.scene_compile import from_reference  # noqa: E402
from surfjax_torch.core.types import RenderSettings  # noqa: E402
from surfjax_torch.kernels.mesh_tile import (  # noqa: E402
    mesh_candidates, mesh_tile, mesh_tile_kernel, mesh_tile_reference,
)
from surfjax_torch.meshgen import octasphere  # noqa: E402
from surfjax_torch.pipeline.frame import render_sequence as pt_rs  # noqa: E402

from tests.test_torch_pipeline import gaps, load_pair  # noqa: E402

F32 = np.float32


def _mesh(subdivisions=2, scale=0.8, z=3.0):
    v, f = octasphere(subdivisions)
    v = v * F32(scale) + np.asarray([0.0, 0.0, z], np.float32)
    ref_static, ref_params = sj_api.Scene().add(
        sj_api.TriangleMesh(vertices=v, faces=f)).freeze()
    static, params = from_reference(ref_static, ref_params, device="cpu")
    return (ref_static.mesh_static[0], ref_params, static.mesh_static[0],
            params)


def _rays(rows, seed, spread=0.4):
    """rows x 128 rays from the origin into a cone around +z -> numpy
    (o, d) component lists of (rows, 128) float32."""
    n = rows * 128
    ang = np.random.default_rng(seed).uniform(-spread, spread, (2, n))
    dx = np.sin(ang[0]).astype(F32)
    dy = np.sin(ang[1]).astype(F32)
    dz = np.sqrt(1.0 - dx * dx - dy * dy).astype(F32)
    o = [np.zeros((rows, 128), F32) for _ in range(3)]
    return o, [c.reshape(rows, 128) for c in (dx, dy, dz)]


def _brute(tri, o, d, t_min, t_max, any_hit):
    """Moller-Trumbore of every ray against every triangle in ascending
    order, numpy float32 in the kernel's association -> (t, ns, ng)."""
    o = [c.reshape(-1) for c in o]
    d = [c.reshape(-1) for c in d]
    t_max = np.asarray(t_max, F32).reshape(-1)
    one, zero = F32(1.0), F32(0.0)
    t_best = np.full(o[0].shape, F32(BIG))
    ns = [np.zeros_like(t_best), np.zeros_like(t_best),
          np.ones_like(t_best)]
    ng = [a.copy() for a in ns]
    found = np.zeros(o[0].shape, bool)
    for row in tri:
        e1, e2 = row[3:6], row[6:9]
        pvx = d[1] * e2[2] - d[2] * e2[1]
        pvy = d[2] * e2[0] - d[0] * e2[2]
        pvz = d[0] * e2[1] - d[1] * e2[0]
        det = (e1[0] * pvx + e1[1] * pvy) + e1[2] * pvz
        ok = np.abs(det) > F32(1e-7)
        inv_det = one / np.where(ok, det, one)
        tvx, tvy, tvz = o[0] - row[0], o[1] - row[1], o[2] - row[2]
        u = ((tvx * pvx + tvy * pvy) + tvz * pvz) * inv_det
        qvx = tvy * e1[2] - tvz * e1[1]
        qvy = tvz * e1[0] - tvx * e1[2]
        qvz = tvx * e1[1] - tvy * e1[0]
        v = ((d[0] * qvx + d[1] * qvy) + d[2] * qvz) * inv_det
        t = ((e2[0] * qvx + e2[1] * qvy) + e2[2] * qvz) * inv_det
        hit = (ok & (u >= zero) & (v >= zero) & (u + v <= one)
               & (t > F32(t_min)) & (t < t_max))
        if any_hit:
            hit &= ~found
            found |= hit
            t_best = np.where(hit, t, t_best)
            continue
        hit &= t < t_best
        t_best = np.where(hit, t, t_best)
        w = (one - u) - v
        s = [(w * row[12 + k] + u * row[15 + k]) + v * row[18 + k]
             for k in range(3)]
        inv = one / np.sqrt((s[0] * s[0] + s[1] * s[1]) + s[2] * s[2])
        for k in range(3):
            ns[k] = np.where(hit, s[k] * inv, ns[k])
            ng[k] = np.where(hit, row[9 + k], ng[k])
    return t_best, ns, ng


@pytest.mark.parametrize("R", [16, 64])
def test_mesh_candidates_conservative(R):
    """Every triangle a lane hits within its segment is among its tile's
    candidates, or the tile overflows K and the kernel scans the whole
    table. The projections run in plain float32 (no matrix product), so
    no reduced-precision product can shrink a triangle's range."""
    v, f = octasphere(3)
    v = v * F32(0.9) + np.asarray([0.0, 0.0, 3.2], np.float32)
    ref_static, ref_params = sj_api.Scene().add(
        sj_api.TriangleMesh(vertices=v, faces=f)).freeze()
    static, params = from_reference(ref_static, ref_params, device="cpu")
    tri = ref_params["mesh0_tri_packed"]
    o, d = _rays(64, seed=7)
    t_min, t_max = F32(1e-3), F32(1e4)
    # per-lane hits of every triangle, by the accept test of the kernel
    d_all = np.stack([c.reshape(-1) for c in d], -1)[:, None, :]
    o_all = np.stack([c.reshape(-1) for c in o], -1)[:, None, :]
    e1, e2 = tri[:, 3:6], tri[:, 6:9]
    pv = np.cross(d_all, e2[None])
    det = (e1[None] * pv).sum(-1)
    ok = np.abs(det) > 1e-7
    inv = 1.0 / np.where(ok, det, 1.0)
    tv = o_all - tri[None, :, 0:3]
    u = (tv * pv).sum(-1) * inv
    qv = np.cross(tv, e1[None])
    vv = (d_all * qv).sum(-1) * inv
    t = (e2[None] * qv).sum(-1) * inv
    hits = (ok & (u >= 0) & (vv >= 0) & (u + vv <= 1.0) & (t > t_min)
            & (t < t_max))
    cand, counts = mesh_candidates(
        static.mesh_static[0], params["mesh0_tri_packed"],
        tuple(torch.from_numpy(c) for c in o),
        tuple(torch.from_numpy(c) for c in d), float(t_min), float(t_max), R)
    cand, counts = cand.numpy(), counts.numpy()
    K = cand.shape[1]
    tiles = 64 // R
    tile_hits = hits.reshape(tiles, R * 128, -1).any(axis=1)
    assert tile_hits.any()
    for ti in range(tiles):
        if counts[ti] > K:
            continue
        got = set(cand[ti, :counts[ti]].tolist())
        assert len(got) == counts[ti]
        missing = set(np.nonzero(tile_hits[ti])[0].tolist()) - got
        assert not missing, f"tile {ti} (R={R}): hit triangles {missing} " \
            "culled"


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("K", [1024, 8])
def test_plain_mesh_tile_matches_brute_force(any_hit, K):
    """K = 8 makes every tile overflow into the full-table scan."""
    _, ref_params, ms, params = _mesh()
    tri = params["mesh0_tri_packed"]
    o, d = _rays(16, seed=3)
    t_min = 1e-3
    rng = np.random.default_rng(4)
    t_max = (rng.uniform(2.0, 4.0, (16, 128)).astype(F32) if any_hit
             else np.full((16, 128), F32(1e4)))
    ot = tuple(torch.from_numpy(c) for c in o)
    dt = tuple(torch.from_numpy(c) for c in d)
    cand, counts = mesh_candidates(ms, tri, ot, dt, t_min,
                                   torch.from_numpy(t_max), 8, K=K)
    if K == 8:
        assert (counts > 8).all()
    t, ns, ng = mesh_tile_reference(tri, cand, counts, ot, dt,
                                    torch.from_numpy(t_max), t_min,
                                    ms.smooth, any_hit)
    t_b, ns_b, ng_b = _brute(ref_params["mesh0_tri_packed"], o, d, t_min,
                             t_max, any_hit)
    hit = t_b < F32(BIG * 0.5)
    assert 0.1 < hit.mean() < 0.9
    assert t.numpy().reshape(-1).tobytes() == t_b.tobytes()
    for a, b in zip(ns + ng, ns_b + ng_b):
        assert a.numpy().reshape(-1).tobytes() == b.tobytes()


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_mesh_tile_matches_reference_kernel(any_hit):
    """The port's packet path (candidates + plain kernel) against
    surfjax's mesh_tile_kernel in interpret mode, tile_rows 8."""
    ref_ms, ref_params, ms, params = _mesh()
    o, d = _rays(32, seed=5)
    t_max = (np.random.default_rng(6).uniform(2.0, 4.0, (32, 128))
             .astype(F32) if any_hit else F32(1e4))
    st = RenderSettings(tile_rows=8)
    got = mesh_tile_kernel(
        ms, st, params["mesh0_tri_packed"],
        tuple(torch.from_numpy(c) for c in o),
        tuple(torch.from_numpy(c) for c in d),
        torch.from_numpy(t_max) if any_hit else float(t_max), any_hit)
    ref = sj_mesh_tile_kernel(
        ref_ms, sj_api.RenderSettings(tile_rows=8),
        jnp.asarray(ref_params["mesh0_tri_packed"]),
        tuple(jnp.asarray(c) for c in o), tuple(jnp.asarray(c) for c in d),
        jnp.asarray(t_max) if any_hit else float(t_max), any_hit=any_hit)
    t_g, t_r = got[0].numpy(), np.asarray(ref[0])
    lim = t_max if any_hit else F32(BIG * 0.5)
    hit_g, hit_r = t_g < lim, t_r < lim
    np.testing.assert_array_equal(hit_g, hit_r)
    assert 0.1 < hit_g.mean() < 0.9
    if any_hit:
        return
    np.testing.assert_allclose(t_g[hit_g], t_r[hit_r], rtol=1e-5)
    for a, b in zip(got[1] + got[2], ref[1] + ref[2]):
        dn = np.abs(a.numpy() - np.asarray(b))[hit_g]
        assert (dn > 1e-4).sum() <= 8 * max(1, dn.size // 4096), dn.max()


def test_mesh_tile_wrapper_devices_and_counts():
    """CPU tensors run the plain version without counting a launch; a
    tensor on another device or of another type is refused."""
    _, _, ms, params = _mesh()
    tri = params["mesh0_tri_packed"]
    o, d = _rays(16, seed=8)
    ot = tuple(torch.from_numpy(c) for c in o)
    dt = tuple(torch.from_numpy(c) for c in d)
    cand, counts = mesh_candidates(ms, tri, ot, dt, 1e-3, 1e4, 8)
    t_max = torch.full((16, 128), 1e4)
    before = mesh_tile.launches
    got = mesh_tile(tri, cand, counts, ot, dt, t_max, 1e-3, True, False)
    ref = mesh_tile_reference(tri, cand, counts, ot, dt, t_max, 1e-3,
                              True, False)
    assert mesh_tile.launches == before
    assert torch.equal(got[0], ref[0])
    meta = tuple(c.to("meta") for c in ot)
    with pytest.raises(ValueError):
        mesh_tile(tri, cand, counts, meta, dt, t_max, 1e-3, True, False)
    with pytest.raises(ValueError, match="int32"):
        mesh_tile(tri, cand.long(), counts, ot, dt, t_max, 1e-3, True, False)
    with pytest.raises(ValueError, match="rows"):
        mesh_tile(tri, cand[:1], counts[:1], tuple(c[:3] for c in ot),
                  tuple(c[:3] for c in dt), t_max[:3], 1e-3, True, False)
    assert mesh_tile.launches == before


def test_c4_slice_matches_reference_pallas():
    """c4 (8192-triangle octasphere over a plane, hard shadows) at 48x48,
    tile_rows 8, through the port's split path on the CPU against
    surfjax's pallas render. Measured: hits and obj_id equal on every
    pixel, depth within 1.9e-6 relative, rgb within 2.9e-6, normals
    within 7.8e-6."""
    (sj_s, sj_c, sj_st), (pt_s, pt_c, pt_st), poses = load_pair(
        "c4_mesh", 48, n_frames=1, backend="pallas", tile_rows=8)
    ref = sj_rs(sj_s, sj_c, poses, sj_st)
    got = pt_rs(pt_s, pt_c, poses, pt_st, device="cpu")
    g = gaps(ref, got)
    assert g["hit_agree"] > 0.999 and g["obj_agree"] > 0.999, g
    assert g["rgb_max"] < 1e-3 and g["normal_max"] < 1e-3, g
    assert 0.3 < float(got.hit.mean()) < 1.0
    assert (got.obj_id == 0).any() and (got.obj_id == 1).any()
