"""The mesh kernel's warp-level cull in plain PyTorch (kernels/mesh_tile.py):
`mesh_warp_masks`, the vote each warp of the kernel takes, and the culled
plain version `mesh_tile_reference(..., masks=)`, which visits only the
voted candidates.

  * the culled plain version equals the unculled one bitwise: on c4 at
    64x48 with tile_rows 8 (both modes, the primary and the shadow call),
    on the mesh + SDF scene and the two-mesh scene, and on the probes:
    rays aimed at a mesh's vertices and edge midpoints, shadow rays with
    several occluders, and tiles that overflow K;
  * every triangle that a lane hits (brute force over the whole table) is
    among its warp's voted candidates;
  * the vote is that of a loop over warps written out in numpy, for each
    warp shape the kernel can run;
  * the per-lane segments repeat mesh_candidates' arithmetic: each of a
    tile's candidates meets the tile's box of those segments;
  * on the probes, the culled plain version equals a numpy scan of the
    whole table in triangle order bitwise;
  * against surfjax's mesh_tile_kernel (interpret mode) on the nested
    shells: the culled any-hit masks equal surfjax's.
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

import surfjax_torch.api as api  # noqa: E402
from surfjax_torch.api import render  # noqa: E402
from surfjax_torch.config import load_config  # noqa: E402
from surfjax_torch.core.math import f32  # noqa: E402
from surfjax_torch.core.scene_compile import from_reference  # noqa: E402
from surfjax_torch.engines.mesh import moller_trumbore  # noqa: E402
from surfjax_torch.kernels.mesh_tile import (  # noqa: E402
    _lane_clip, _ranges, mesh_candidates, mesh_tile_reference,
    mesh_warp_masks, warp_of_rays,
)
from surfjax_torch.tools.kernel_check import capture_calls, flat  # noqa
from surfjax_torch.tools.workload import (  # noqa: E402
    mesh_modes, mesh_probe_calls, mesh_soft_ao_scene, reframe,
    two_mesh_scene,
)

from tests.test_torch_mesh_tile import _brute  # noqa: E402
from tests.test_torch_pipeline import CONFIG_DIR  # noqa: E402


def mesh_calls(scene, cam, st):
    with capture_calls() as calls:
        render(scene, cam, st, device="cpu")
    out = [args for name, args in calls if name == "mesh_tile"]
    assert out
    return out


def case_calls(c4_modes=("config", "ao")):
    """label -> mesh_tile's arguments of every case (CASES), c4 in the
    modes given."""
    out = {}
    scene, cam, st, _ = load_config(f"{CONFIG_DIR}/c4_mesh.yaml")
    for mode in c4_modes:
        st_m = mesh_modes(st)[mode]
        primary, shadow = mesh_calls(scene, reframe(cam, 64, 48),
                                     st_m.with_(tile_rows=8))
        assert not primary[8] and shadow[8]
        out[f"c4 {mode} primary"] = primary
        out[f"c4 {mode} shadow"] = shadow
    for name, build in (("mesh_soft_ao", mesh_soft_ao_scene),
                        ("two_meshes", two_mesh_scene)):
        for k, args in enumerate(mesh_calls(*build(api, 48))):
            out[f"{name} {k}"] = args
    for label, args in mesh_probe_calls(api, "cpu"):
        out[label] = args
    return out


@pytest.fixture(scope="module")
def calls():
    return case_calls()


CASES = ["c4 config primary", "c4 config shadow", "c4 ao primary",
         "c4 ao shadow", "mesh_soft_ao 0", "mesh_soft_ao 1", "two_meshes 0",
         "two_meshes 1", "two_meshes 2", "two_meshes 3", "edges", "overflow",
         "edges any-hit", "overflow any-hit", "edges to target any-hit",
         "layers any-hit"]


def test_cases_cover_what_the_tests_claim(calls):
    assert sorted(calls) == sorted(CASES)
    for label in ("overflow", "overflow any-hit"):
        cand, counts = calls[label][1:3]
        assert (counts > cand.shape[1]).all()
    # c4's shadow tiles at this size hold most of the mesh
    assert int(calls["c4 config shadow"][2].max()) > 1000


@pytest.mark.parametrize("label", CASES)
def test_culled_plain_version_equals_unculled(calls, label):
    """Visiting only the warps' voted candidates changes no output bit,
    and the culled count is the voted candidates up to each lane's first
    occluder, never more than the unculled one."""
    args = calls[label]
    masks = mesh_warp_masks(*args[:7], args[9]).masks
    full = mesh_tile_reference(*args, count_tests=True)
    culled = mesh_tile_reference(*args, count_tests=True, masks=masks)
    for a, b in zip(flat(culled[:3]), flat(full[:3])):
        assert torch.equal(a, b)
    assert bool((culled[3] <= full[3]).all())
    if label.startswith("c4"):
        assert int(culled[3].sum()) * 4 < int(full[3].sum())


def _hit_ids(args, tri_block: int = 512):
    """-> bool (rays, F): the lanes' hits of every triangle of the table,
    by the kernel's accept test."""
    tri, o2, d2, t_maxv, t_min = args[0], args[3], args[4], args[5], args[6]
    o = [c.reshape(-1, 1) for c in o2]
    d = [c.reshape(-1, 1) for c in d2]
    t_max = t_maxv.reshape(-1, 1)
    out = []
    for b in range(0, tri.shape[0], tri_block):
        rows = tri[b:b + tri_block]
        v0, e1, e2 = ([rows[None, :, c + k] for k in range(3)]
                      for c in (0, 3, 6))
        t, ok, u, v = moller_trumbore(o, d, v0, e1, e2, f32(1e-7))
        out.append(ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                   & (t > f32(t_min)) & (t < t_max))
    return torch.cat(out, dim=1)


def _voted_ids(args, masks):
    """-> bool (warps, F): the triangles each warp voted for."""
    tri, cand, counts = args[:3]
    F_n, (tiles, K) = tri.shape[0], cand.shape
    n_warps = masks.shape[0]
    tile = torch.arange(n_warps) * 32 // (args[3][0].numel() // tiles)
    slots = torch.arange(masks.shape[1] * 32)
    bits = ((masks.long()[:, slots >> 5] >> (slots & 31)) & 1).bool()
    over = counts > K
    ids = torch.where(over[:, None], torch.clamp(slots, max=F_n - 1),
                      cand[:, torch.clamp(slots, max=K - 1)].long())[tile]
    n_slots = torch.where(over, F_n, torch.clamp(counts, max=K))[tile]
    bits &= slots[None, :] < n_slots[:, None]
    voted = torch.zeros((n_warps, F_n), dtype=torch.bool)
    voted[torch.arange(n_warps)[:, None].expand_as(ids)[bits], ids[bits]] = \
        True
    return voted


@pytest.mark.parametrize("label", CASES)
def test_every_hit_triangle_is_voted(calls, label):
    """By the box with the oriented axes, as the kernel votes, and by the
    box alone."""
    args = calls[label]
    hits = _hit_ids(args)
    # the one-triangle mesh shadows no receiver at this size
    assert bool(hits.any()) or label == "two_meshes 3"
    warp = warp_of_rays(args[3][0].shape[0], "cpu").reshape(-1)
    votes = mesh_warp_masks(*args[:7], args[9])
    for axes, masks in ((True, votes.masks), (False, votes.boxed)):
        missed = hits & ~_voted_ids(args, masks)[warp]
        assert not bool(missed.any()), \
            f"{int(missed.sum())} hits not voted (axes {axes})"


def _np_axes(d, valid):
    """A warp's oriented axes in numpy float32 (d: (3, 32) directions)."""
    f = np.float32
    s = np.where(valid, d, f(0.0)).astype(f)
    idx = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        s = (s + s[:, idx ^ off]).astype(f)
    w = s[:, 0]
    nrm = np.sqrt((w[0] * w[0] + w[1] * w[1]) + w[2] * w[2])
    w = w / nrm if nrm > f(1e-6) else np.asarray([1, 0, 0], f)
    ref = np.asarray([1, 0, 0] if abs(w[1]) >= f(0.9) else [0, 1, 0], f)

    def cross(a, b):
        return np.asarray([a[1] * b[2] - a[2] * b[1],
                           a[2] * b[0] - a[0] * b[2],
                           a[0] * b[1] - a[1] * b[0]], f)
    u = cross(w, ref)
    u = u / np.sqrt((u[0] * u[0] + u[1] * u[1]) + u[2] * u[2])
    return [w, u, cross(w, u)]


def _np_dot(a, p):
    return (p[0] * a[0] + p[1] * a[1]) + p[2] * a[2]


def _numpy_votes(args, axes):
    """The vote written out as a loop over warps in numpy (float32), from
    the lanes' clipped segments -> (the votes, whether each warp's box is
    empty)."""
    tri, cand, counts, o2, d2, t_maxv, t_min = args[:7]
    pa, pb, valid = _lane_clip(o2, d2, t_maxv, t_min, args[9])
    pa, pb, d = (np.stack([a.numpy().reshape(-1) for a in v])
                 for v in (pa, pb, d2))
    valid = valid.numpy().reshape(-1)
    big = np.float32(1e30)
    rows = o2[0].shape[0]
    warp = warp_of_rays(rows, "cpu").numpy().reshape(-1)
    tiles, K = cand.shape
    tile_rays = o2[0].numel() // tiles
    t = tri.numpy()
    v0 = t[:, 0:3]
    p1, p2 = v0 + t[:, 3:6], v0 + t[:, 6:9]
    eps = np.float32(1e-4)
    n_words = -(-max(t.shape[0], K) // 32)
    out = np.zeros((rows * 128 // 32, n_words), np.uint32)
    empty = np.zeros(out.shape[0], bool)
    for w in range(out.shape[0]):
        lanes = np.nonzero(warp == w)[0]
        assert len(lanes) == 32
        ok = valid[lanes]
        a_, b_ = pa[:, lanes], pb[:, lanes]
        w_lo = np.where(ok, np.minimum(a_, b_), big).min(axis=1) - eps
        w_hi = np.where(ok, np.maximum(a_, b_), -big).max(axis=1) + eps
        empty[w] = not (w_lo <= w_hi).all()
        tile = w * 32 // tile_rays
        n = int(counts[tile])
        ids = np.arange(t.shape[0]) if n > K else cand[tile, :n].numpy()
        vs = [v0[ids].T, p1[ids].T, p2[ids].T]
        keep = ((np.minimum(np.minimum(*vs[:2]), vs[2]) <= w_hi[:, None])
                & (np.maximum(np.maximum(*vs[:2]), vs[2])
                   >= w_lo[:, None])).all(axis=0)
        if axes:
            for ax in _np_axes(d[:, lanes], ok):
                sa, sb = _np_dot(ax, a_), _np_dot(ax, b_)
                lo = np.where(ok, np.minimum(sa, sb), big).min() - eps
                hi = np.where(ok, np.maximum(sa, sb), -big).max() + eps
                tp = [_np_dot(ax, vt) for vt in vs]
                keep &= (np.minimum(np.minimum(*tp[:2]), tp[2]) <= hi) & \
                    (np.maximum(np.maximum(*tp[:2]), tp[2]) >= lo)
        for slot in np.nonzero(keep)[0]:
            out[w, slot // 32] |= np.uint32(1) << np.uint32(slot % 32)
    return out.view(np.int32), empty


@pytest.mark.parametrize("axes", [True, False])
@pytest.mark.parametrize("label", ["edges", "overflow any-hit",
                                   "two_meshes 0", "c4 config shadow"])
def test_warp_masks_equal_a_loop_over_warps(calls, label, axes):
    """With the oriented axes (as the kernel votes) and without (the
    candidates whose box passed); the warps whose box is empty; the culled
    plain version with those votes stays bitwise equal to the unculled
    one."""
    args = calls[label]
    votes = mesh_warp_masks(*args[:7], args[9])
    masks = votes.masks if axes else votes.boxed
    want, empty = _numpy_votes(args, axes)
    np.testing.assert_array_equal(masks.numpy(), want)
    np.testing.assert_array_equal(votes.empty.numpy(), empty)
    culled = mesh_tile_reference(*args, masks=masks)
    for a, b in zip(flat(culled), flat(mesh_tile_reference(*args))):
        assert torch.equal(a, b)


def test_warp_of_rays_is_the_kernels_thread_order():
    """Each warp holds 32 rays, 16 columns of two rows, and a block of two
    rows holds whole warps, numbered along the row."""
    rows = 8
    warp = warp_of_rays(rows, "cpu")
    counts = torch.bincount(warp.reshape(-1))
    assert counts.shape[0] == rows * 4 and bool((counts == 32).all())
    for w in range(rows * 4):
        r, c = torch.nonzero(warp == w, as_tuple=True)
        assert int(c.max() - c.min()) == 15 and int(r.max() - r.min()) == 1
        assert int(r.min()) == 2 * (w // 8) and int(c.min()) == 16 * (w % 8)


@pytest.mark.parametrize("label", ["c4 config primary", "c4 config shadow",
                                   "mesh_soft_ao 1"])
def test_lane_segments_repeat_mesh_candidates(calls, label):
    """Every candidate of a tile meets the tile's box of the lanes'
    segments (the vote's clip, _lane_clip, padded by eps), as it met
    mesh_candidates' own box: the same arithmetic."""
    tri, cand, counts, o2, d2, t_maxv, t_min = calls[label][:7]
    tiles, K = cand.shape
    pa, pb, valid = _lane_clip(o2, d2, t_maxv, t_min, calls[label][9])
    lo, hi = zip(*(_ranges(a, b, valid) for a, b in zip(pa, pb)))
    eps = f32(1e-4)
    box_lo = torch.stack([a.reshape(tiles, -1).amin(dim=1) for a in lo],
                         1) - eps
    box_hi = torch.stack([a.reshape(tiles, -1).amax(dim=1) for a in hi],
                         1) + eps
    v0 = tri[:, 0:3]
    p1, p2 = v0 + tri[:, 3:6], v0 + tri[:, 6:9]
    t_lo = torch.minimum(torch.minimum(v0, p1), p2)
    t_hi = torch.maximum(torch.maximum(v0, p1), p2)
    checked = 0
    for tile in range(tiles):
        n = int(counts[tile])
        if n == 0 or n > K:
            continue
        ids = cand[tile, :n].long()
        assert bool((t_lo[ids] <= box_hi[tile]).all())
        assert bool((t_hi[ids] >= box_lo[tile]).all())
        checked += n
    assert checked > 0


PROBES = ["edges", "overflow", "edges any-hit", "overflow any-hit",
          "edges to target any-hit", "layers any-hit"]


@pytest.mark.parametrize("label", PROBES)
def test_culled_probes_equal_a_scan_of_the_whole_table(calls, label):
    """Rays at shared vertices and edge midpoints and through several
    occluders, where the rule decides the result: the nearest hit with
    strict < (ties to the lowest triangle), or the first occluder in
    triangle order. The culled plain version against a numpy scan of every
    triangle in that order (test_torch_mesh_tile._brute, none of the
    port's code): t, ns and ng bitwise. surfjax's kernel in interpret mode
    cannot be held to the bit here: XLA:CPU contracts its multiply-adds
    (with jit disabled too), which moves t by an ulp and, at a vertex,
    turns hits into misses."""
    args = calls[label]
    tri, o2, d2, t_maxv, t_min, smooth, any_hit = (args[0],) + args[3:9]
    votes = mesh_warp_masks(*args[:7], args[9])
    got = mesh_tile_reference(*args, masks=votes.masks)
    t_b, ns_b, ng_b = _brute(tri.numpy(), [c.numpy() for c in o2],
                             [c.numpy() for c in d2], t_min,
                             t_maxv.numpy(), any_hit)
    if not smooth:
        ns_b = ng_b
    hit = t_b < t_maxv.numpy().reshape(-1)
    assert 0.5 < hit.mean() <= 1.0
    assert got[0].numpy().reshape(-1).tobytes() == t_b.tobytes()
    for a, b in zip(got[1] + got[2], ns_b + ng_b):
        assert a.numpy().reshape(-1).tobytes() == b.tobytes()


def test_culled_shells_against_surfjax():
    """Shadow rays through three nested shells (up to six occluders each)
    through surfjax's mesh_tile_kernel in interpret mode and through the
    port's candidates and culled plain version: the same occluded lanes
    (the caller reads only t < t_max of an any-hit call; which occluder
    is first in candidate order is each kernel's own)."""
    from surfjax_torch.meshgen import octasphere
    v, f = octasphere(2)
    centre = np.asarray([0.1, -0.05, 3.0], np.float32)
    verts = np.concatenate([(v * np.float32(r) + centre).astype(np.float32)
                            for r in (0.3, 0.6, 0.9)])
    faces = np.concatenate([f + k * len(v) for k in range(3)]).astype(
        np.int32)
    ref_static, ref_params = sj_api.Scene().add(
        sj_api.TriangleMesh(vertices=verts, faces=faces)).freeze()
    static, params = from_reference(ref_static, ref_params, device="cpu")
    ms = static.mesh_static[0]
    rng = np.random.default_rng(5)
    tg = centre + rng.uniform(-0.25, 0.25, (16 * 128, 3)).astype(np.float32)
    d = tg.astype(np.float32)
    d = (d / np.sqrt((d * d).sum(axis=1))[:, None]).astype(np.float32)
    o = [np.zeros((16, 128), np.float32) for _ in range(3)]
    d = [np.ascontiguousarray(d[:, k].reshape(16, 128)) for k in range(3)]
    t_max = rng.uniform(1.5, 4.0, (16, 128)).astype(np.float32)
    settings = sj_api.RenderSettings(tile_rows=8)
    ref = sj_mesh_tile_kernel(
        ref_static.mesh_static[0], settings,
        jnp.asarray(ref_params["mesh0_tri_packed"]),
        tuple(jnp.asarray(c) for c in o), tuple(jnp.asarray(c) for c in d),
        jnp.asarray(t_max), any_hit=True)
    tri = params["mesh0_tri_packed"]
    ot = tuple(torch.from_numpy(c) for c in o)
    dt = tuple(torch.from_numpy(c) for c in d)
    tm = torch.from_numpy(t_max)
    t_min = settings.shadow_eps
    cand, counts = mesh_candidates(ms, tri, ot, dt, t_min, tm, 8)
    from surfjax_torch.kernels.mesh_tile import grid_box
    args = (tri, cand, counts, ot, dt, tm, t_min, ms.smooth, True,
            grid_box(ms))
    got = mesh_tile_reference(*args, masks=mesh_warp_masks(
        *args[:7], args[9]).masks)
    t_g, t_r = got[0].numpy(), np.asarray(ref[0])
    occ_g, occ_r = t_g < t_max, t_r < t_max
    np.testing.assert_array_equal(occ_g, occ_r)
    assert 0.2 < occ_g.mean() < 1.0
