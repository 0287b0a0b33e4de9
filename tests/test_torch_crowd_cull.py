"""The warp-level member culling of KF's crowd instantiation, through its
plain version on the CPU (`render_tile.crowd_warp_masks`, and
`frame_fused_reference(..., masks=)`, which visits per warp only the
masked members, as `kf_frame_kernel<true>` does on the card).

  (a) the masks are conservative: for every warp and member loop, each
      member whose exact per-lane gate keeps it on some lane of the warp
      is in the warp's mask (the gates as the kernel's per-lane code takes
      them: a primary bound entry with t1 < clip2 at t_clip = t_max, an
      exact hit in range, AO's far gate, the hard shadows' segment skip,
      a penumbra factor below 1);
  (b) the twin with the masks equals the twin without them, bitwise, on
      all nine buffers;
  (c) the masks cut the work: masked members per warp on crowd_demo;
  (d) a member swept across a warp test's boundary, within +- its slack,
      keeps (a) and (b);
  (e) the masked twin against surfjax (Pallas kernels in interpret mode).

Scenes: crowd_demo reframed to 200x121 in both modes (not a multiple of
the 16x8-pixel block, so warps are ragged), the shapes of
`workload.crowd_cases`, sphere crowds of 64 and 256 members and
`workload.cull_edge_scene` (members grazing warp-edge rays, a point
light with kf < 1.2, a directional light, depth edges), at 61x37.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import surfjax.api as sj_api  # noqa: E402

import surfjax_torch.api as pt_api  # noqa: E402
from surfjax_torch.config import load_config  # noqa: E402
from surfjax_torch.core.math import BIG, f32, maximum  # noqa: E402
from surfjax_torch.core.scene_compile import params_to_device  # noqa: E402
from surfjax_torch.kernels import render_tile as rt  # noqa: E402
from surfjax_torch.tools import workload  # noqa: E402

from tests.test_torch_pipeline import CONFIG_DIR, gaps  # noqa: E402

SMALL = (61, 37)
DEMO = (200, 121)
NINE = ("r", "g", "b", "depth", "obj", "nx", "ny", "nz", "hit")


def _scene(name):
    """-> (scene, camera, settings with vector_objects on)."""
    if name.startswith("crowd_demo"):
        scene, cam, st, _ = load_config(f"{CONFIG_DIR}/crowd_demo.yaml")
        st = st.with_(backend="pallas",
                      soft_shadows=name.endswith("soft"))
        return scene, workload.reframe(cam, *DEMO), st
    if name.startswith("edge"):
        sc, cam, st = workload.cull_edge_scene(pt_api, SMALL,
                                               soft=name.endswith("soft"))
        return sc, cam, st.with_(vector_objects=True)
    if name.startswith("spheres"):
        sc, cam, st = workload.sphere_crowd(pt_api, int(name.split()[1]),
                                            size=SMALL)
        return sc, cam, st.with_(vector_objects=True)
    sc, cam, st = workload.crowd_cases(pt_api, SMALL)[name]
    return sc, cam, st.with_(vector_objects=True)


CASES = ("crowd_demo config", "crowd_demo soft", "edge hard", "edge soft",
         "spheres 64", "spheres 256") + tuple(
             n for n in workload.crowd_cases(pt_api) if n != "crowd + mesh")


def _frame(scene, cam, st, seed=0):
    static, params = scene.freeze()
    scene_t = rt.SceneTensors(static, params_to_device(params, "cpu"))
    Rs, ps = workload.poses(cam, 1, np.random.default_rng(seed).normal(
        0.0, 1e-3, (1, 3)))
    rows = workload.cam_rows_of(Rs, ps, "cpu")
    return scene_t, st, cam.intrinsics, rows


@functools.lru_cache(maxsize=None)
def _case(name):
    """-> (frame args, masks, unmasked twin, masked twin, their count_ops
    operations)."""
    args = _frame(*_scene(name))
    masks = rt.crowd_warp_masks(*args)
    with rt.count_ops() as plain_ops:
        plain = rt.frame_fused_reference(*args)
    with rt.count_ops() as culled_ops:
        culled = rt.frame_fused_reference(*args, masks=masks)
    return args, masks, plain, culled, (plain_ops["ops"], culled_ops["ops"])


def _lane_gates(scene_t, st, intr, rows):
    """key -> (lanes, n_members) bool: the lanes whose exact per-lane gate
    keeps the member in that loop."""
    static, params = scene_t
    lp, nparams = params["leaf_params"], params["node_params"]
    crowd = rt.split_crowd(static, st)[0]
    refs = rt._crowd_refs(static, st, lp, nparams)
    o3, d3 = rt.frame_rays(intr, rows)
    o = tuple(c.reshape(-1) for c in o3)
    d = tuple(c.reshape(-1) for c in d3)
    t, obj, leaf, hit_f, _ = rt.trace_core(static, st, lp, nparams, o, d)
    hit = hit_f > 0.5
    t_sane = torch.where(hit, t, 0.0)
    p = tuple(o[k] + t_sane * d[k] for k in range(3))
    n = rt.normals_core(static, st, lp, nparams, p, obj, leaf, d)
    eps = f32(st.shadow_eps)
    p_off = tuple(p[k] + n[k] * eps for k in range(3))
    em = rt._exit_margin(st)
    sdf_end = crowd.n_sph_sdf + crowd.n_box_sdf
    single_end = crowd.n_singles
    t_min = torch.full_like(o[0], f32(st.t_min))
    t_max = torch.full_like(o[0], f32(st.t_max))
    t0 = f32(st.soft_shadow_tmin)
    gate = f32(2.0 * f32(st.ao_radius))
    rays = [rt._light_ray(st, kind, params["lights"][li], p_off)
            for li, kind in enumerate(static.ir.lights)]
    cols = {}

    def put(key, j, lanes):
        cols.setdefault(key, {})[j] = lanes

    for lo, hi, tag in crowd.all_ranges + crowd.pair_ranges:
        for j in range(lo, hi):
            b, sdf_j = rt._crowd_shape(crowd, refs, j, tag)
            prm = lp[int(refs[0][j, 0])]
            ana = sdf_end <= j < single_end
            if ana:
                put("primary_ana", j, rt._leaf_exact_t(
                    prm, tag, o, d, f32(st.t_min), f32(st.t_max))
                    < BIG * 0.5)
            else:
                t1, clip2 = rt._bound_entry(b, o, d, t_min, t_max, em)
                put("primary_sdf", j, t1 < clip2)
            if st.ao:
                dx, dy, dz = (p_off[k] - b[k] for k in range(3))
                put("ao", j, hit & (rt.sqrt((dx * dx + dy * dy) + dz * dz)
                                    - b[3] <= gate))
            for li, (l, dist, kf) in enumerate(rays if st.shadows else ()):
                if st.soft_shadows:
                    if tag is True:
                        v = rt._penumbra_sphere(prm, p_off, l, t0, dist, kf)
                    else:
                        t_lo, t_hi = rt._influence_window(b, p_off, l, t0,
                                                          dist, kf)
                        v, _ = rt._soft_march(sdf_j, p_off, l,
                                              maximum(t_lo, t0),
                                              torch.minimum(dist, t_hi), kf,
                                              st.shadow_steps,
                                              relax=st.over_relax)
                    put(("soft", li), j, hit & (v < 1.0))
                elif ana:
                    put(("hard_ana", li), j, hit & (rt._leaf_exact_t(
                        prm, tag, p_off, l, eps, dist) < dist))
                else:
                    put(("hard_sdf", li), j, hit & (rt._seg_bound_dist(
                        b, p_off, l, eps, dist) <= f32(em)))
    n_members = len(crowd.members)
    out = {}
    for key, by_j in cols.items():
        g = torch.zeros((o[0].numel(), n_members), dtype=torch.bool)
        for j, lanes in by_j.items():
            g[:, j] = lanes
        out[key] = g
    return out


def _uncovered(args, masks) -> dict:
    """key -> the (warp, member) pairs some lane's gate keeps that the
    warp's mask leaves out."""
    gates = _lane_gates(*args)
    out = {}
    for key, m in masks.masks.items():
        need = torch.zeros(m.shape, dtype=torch.int32)
        if key in gates:     # else a loop over an empty member range
            need.index_add_(0, masks.warp_of, gates[key].to(torch.int32))
        out[key] = [tuple(x) for x in ((need > 0) & ~m).nonzero().tolist()]
    assert set(gates) <= set(masks.masks)
    return out


@pytest.mark.parametrize("name", CASES)
def test_masks_are_conservative(name):
    args, masks, _, _, _ = _case(name)
    bad = {k: v for k, v in _uncovered(args, masks).items() if v}
    assert not bad, bad


@pytest.mark.parametrize("name", CASES)
def test_masked_twin_equals_unmasked(name):
    _, masks, plain, masked, _ = _case(name)
    for label, a, b in zip(NINE, plain, masked):
        assert torch.equal(a, b), label
    assert float(plain[8].mean()) > 0.1


@pytest.mark.parametrize("mode", ["config", "soft"])
def test_masks_cut_work_on_crowd_demo(mode):
    """Mean masked members per warp of the 48-member crowd at 200x121
    (the secondary loops over the warps with a hit), measured: primary SDF
    1.40, AO 4.24, hard shadows 1.91 / 1.62 (point / directional light),
    soft shadows 6.79 / 1.91; each is held below a bound of a quarter of
    the crowd or less. The culled twin counts 4.85e7 operations against
    1.23e8 (`config`) and 1.09e8 against 2.00e8 (`soft`)."""
    _, masks, _, _, (plain_ops, culled_ops) = _case(f"crowd_demo {mode}")
    n = masks.masks["primary_sdf"].shape[1]
    counts = masks.counts()
    assert n == 48
    assert counts["primary_sdf"][0] < 3 and counts["ao"][0] < 6, counts
    for li in (0, 1):
        if mode == "soft":
            assert counts[f"soft {li}"][0] < 12, counts
        else:
            assert counts[f"hard_sdf {li}"][0] < 4, counts
            assert counts[f"hard_ana {li}"][0] < 1, counts
    assert culled_ops < 0.8 * plain_ops, (culled_ops, plain_ops)


def test_count_ops_charges_member_tests_per_live_warp():
    """CrowdMasks.lanes counts a 32-member chunk's tests once, at the
    chunk's first member, on each warp with a live pixel: every warp
    without `live`, none where no pixel is live; one test per member of
    the chunk (the last chunk of crowd_demo's 48 members holds 16). A
    sphere member's test is cull_keep's 44 operations (its bound is its
    leaf's own centre and radius); a box adds the 6 of its reach."""
    _, masks, _, _, _ = _case("spheres 64")
    assert masks.test_ops == (44,) * 64
    _, masks, _, _, _ = _case("crowd_demo config")
    n_warps = masks.hit_warps.numel()
    n_pix = masks.warp_of.numel()
    assert min(masks.test_ops) >= 44
    chunks = {0: sum(masks.test_ops[:32]), 32: sum(masks.test_ops[32:48])}
    for live, warps in ((None, n_warps), (masks.warp_of == 5, 1),
                        (torch.zeros(n_pix, dtype=torch.bool), 0)):
        for j in (0, 1, 31, 32, 47):
            with rt.count_ops() as ops:
                lanes = masks.lanes("ao", j, live)
            assert ops["ops"] == warps * chunks.get(j, 0), (j, warps)
            assert torch.equal(lanes, masks.masks["ao"][masks.warp_of, j])


def _with_radius(scene, obj_idx: int, radius: float):
    """The scene with one sphere object's radius replaced."""
    new = pt_api.Scene()
    for k, o in enumerate(scene.objects):
        node = pt_api.Sphere(center=o.node.center, radius=radius) \
            if k == obj_idx else o.node
        new.add(node, o.material, engine=o.engine)
    for light in scene.lights:
        new.add_light(light)
    return new


@pytest.mark.parametrize("key", ["primary_sdf", "ao", "hard_sdf",
                                 "soft"])
@pytest.mark.parametrize("delta", [-1.0, 0.0, 1.0])
def test_member_swept_across_the_boundary(key, delta):
    """The sphere member nearest a warp test's boundary (outside it) is
    grown until the test sits at delta times its slack from the boundary
    (-1: one slack outside, 0: on it, 1: one slack inside): the masks stay
    conservative and the masked twin equal to the unmasked one."""
    scene, cam, st = workload.cull_edge_scene(pt_api, SMALL,
                                              soft=key == "soft")
    st = st.with_(vector_objects=True)
    args = _frame(scene, cam, st)
    masks = rt.crowd_warp_masks(*args)
    seg, reach, rel = masks.tests[key if key in masks.masks else (key, 0)]
    crowd = rt.split_crowd(args[0].static, st)[0]
    margin = rt.cull_margin(masks.bounds, reach, seg, rel)
    slack = rt.cull_margin(masks.bounds, reach, seg, 0.0) - margin
    # the SDF spheres: their radius is their bound
    sph = torch.zeros_like(margin, dtype=torch.bool)
    sph[:, :crowd.n_sph_sdf] = True
    near = torch.where(sph & seg.any & (margin > 0.0), margin, float("inf"))
    w, j = divmod(int(near.argmin()), near.shape[1])
    grow = (float(margin[w, j]) + delta * float(slack[w, j])) / (1.0 + rel)
    obj_idx = crowd.members[j][0]
    args = _frame(_with_radius(scene, obj_idx,
                               float(masks.bounds[3][j]) + grow), cam, st)
    masks = rt.crowd_warp_masks(*args)
    if delta:       # one slack inside: voted in; one slack outside: not
        full = key if key in masks.masks else (key, 0)
        assert bool(masks.masks[full][w, j]) == (delta > 0)
    bad = {k: v for k, v in _uncovered(args, masks).items() if v}
    assert not bad, bad
    plain = rt.frame_fused_reference(*args)
    masked = rt.frame_fused_reference(*args, masks=masks)
    for label, a, b in zip(NINE, plain, masked):
        assert torch.equal(a, b), label


def test_warp_layout_is_the_kernels():
    """Lane l of warp w of block (bx, by) is thread 32*w + l: pixel (by*8
    + (32w + l) // 16, bx*16 + l % 16); warps wholly outside the frame
    are not listed."""
    F, H, W = 2, 11, 37
    lanes, warp_of = rt._warp_layout(F, H, W, "cpu")
    want = []
    for f in range(F):
        for by in range(-(-H // 8)):
            for bx in range(-(-W // 16)):
                for w in range(4):
                    px = []
                    for lane in range(32):
                        tid = 32 * w + lane
                        i, j = by * 8 + (tid >> 4), bx * 16 + (tid & 15)
                        px.append((f * H + i) * W + j
                                  if i < H and j < W else -1)
                    if max(px) >= 0:
                        want.append(px)
    got = sorted(map(tuple, lanes.tolist()))
    assert got == sorted(map(tuple, want))
    assert int(warp_of.numel()) == F * H * W
    assert torch.equal(lanes[warp_of, :].eq(
        torch.arange(F * H * W).view(-1, 1)).any(dim=1),
        torch.ones(F * H * W, dtype=torch.bool))


def test_masked_twin_matches_reference_pallas():
    """The culled twin against surfjax's pallas render (interpret mode)
    with vector_objects on, on the crowd of small spheres and boxes with
    hard shadows and AO at 64x48: the bounds of
    tests/test_torch_crowd.py (hits and obj_id equal, depth within 1e-4 *
    max(1, t), rgb within 2e-4, normals within 5e-4)."""
    name = "crowd hard+ao"
    sj_scene, sj_cam, sj_st = workload.crowd_cases(sj_api, (64, 48))[name]
    pt_scene, pt_cam, pt_st = workload.crowd_cases(pt_api, (64, 48))[name]
    ref = sj_api.render(sj_scene, sj_cam, sj_st.with_(vector_objects=True))
    scene_t, st, intr, _ = _frame(pt_scene, pt_cam,
                                  pt_st.with_(vector_objects=True))
    R = np.asarray(pt_cam.rotation, np.float32).reshape(1, 9)
    pos = np.asarray(pt_cam.position, np.float32).reshape(1, 3)
    rows = workload.cam_rows_of(R, pos, "cpu")
    masks = rt.crowd_warp_masks(scene_t, st, intr, rows)
    fb = rt.frame_buffers(rt.frame_fused_reference(scene_t, st, intr, rows,
                                                   masks=masks))
    got = tuple(getattr(fb, f)[0] for f in fb._fields)
    g = gaps(ref, got)
    assert g["hit_agree"] == 1.0 and g["obj_agree"] == 1.0, g
    assert g["depth_rel_max"] <= 1e-4 and g["normal_max"] <= 5e-4, g
    assert g["rgb_max"] <= 2e-4, g
