"""The split path's crowd kernels (K1 and K2 with a crowd,
surfjax_torch/kernels/csrc/split_path.cu, and ao_fix with a crowd,
csrc/ao_fix_crowd.cu, which cull the crowd's members per warp of 32
consecutive rays) through their plain versions on the CPU:
`render_tile.split_warp_masks` votes each warp's member masks with the
kernels' regions, tests and slack, and `render_tile_reference(...,
masks=)` / `trace_rays_reference(..., masks=)` / `ao_fix_reference(...,
masks=)` visit per warp only the masked members, as the kernels do.

  (a) the scene: surfjax_torch/configs/crowd_mesh.yaml compiles to the
      same tables in both packages, its first 49 objects and its lights
      are configs/crowd_demo.yaml's, and the port's plain split render of
      it at 64x36 shows the mesh and at least 10 crowd members (surfjax's
      render of the same file: tests/test_torch_split_crowd_ref.py);
  (b) the masks are conservative: for every warp and member loop, each
      member whose exact per-lane gate keeps it on some lane of the warp
      is in the warp's mask (the gates as the kernels' per-lane code takes
      them: a primary bound entry with t1 < clip2 over [t_min, t_max], an
      exact hit in range, AO's far gate on every lane, the hard shadows'
      segment skip, a penumbra factor below 1), on crowd_mesh in both
      modes, on workload.crowd_cases' "crowd + mesh" and "crowd soft", on
      rays from random origins (numpy seed), and on opposed rays (each
      point shot both ways, so that a warp's directions sum to exactly 0
      and its capsule takes the fallback axis);
  (c) the masked plain versions equal the unmasked ones bitwise on all of
      K1's 8 and K2's 2 outputs, unres included, with and without
      march_cap / shadow_march_cap, hard and soft;
  (d) the masks cut the work: on crowd_mesh at 40x23 the mean masked
      members per warp of every loop is at most 16 of the 48, and the
      culled algorithm's count_ops below 0.8 of the unculled (measured:
      primary SDF 10.4 of 42, primary analytic 1.5 of 6, AO 6.0, hard SDF
      10.1 / 5.7, hard analytic 0.9 / 0.6, soft 14.0 / 6.7; operations
      0.26-0.76 of the unculled; a warp of 32 pixels spans 44 degrees of
      this frame, 1 of a 1080p frame, where the card's plain vote reads
      0.6, 0.02, 1.7, 1.4 / 0.7, 0.13 / 0.07 and 4.4 / 0.9).

K1 and K2 are called on the rays of a 40x23 frame in the split path's
layout (a 128-lane row per image row, padded lanes repeating its last
pixel), cut to 2,931 lanes so that the last warp is ragged, and on 931
rays from random origins (466 more, each shot both ways, for the opposed
case); K2's receivers come from the plain K1 (the split path's offsets
and light rays, without the mesh merge), and the opposed case also
launches K2 on the opposed rays themselves. ao_fix is called on the
ao_fix call of the port's plain split render of crowd_mesh at 40x23 (cut
to 8,179 lanes), with the call's need (the mesh's lanes) and four others
(AO_FIX_CASES): (b) and (c) hold for each, and (d) for the mesh's lanes
(counted: 2.0 of 48 members per warp with a needing lane on the 1080p
frame, breakdown.ao_fix_votes, 7.9 here, where a warp spans a wider
patch); a member is also swept
across the ao_fix vote's boundary, as tests/test_torch_crowd_cull.py does
for KF.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import surfjax.config as sj_config  # noqa: E402

import surfjax_torch.api as pt_api  # noqa: E402
import surfjax_torch.config as pt_config  # noqa: E402
from surfjax_torch.core.camera import camera_ray_dirs_dyn  # noqa: E402
from surfjax_torch.core.math import BIG, f32, maximum  # noqa: E402
from surfjax_torch.core.scene_compile import params_to_device  # noqa: E402
from surfjax_torch.kernels import render_tile as rt  # noqa: E402
from surfjax_torch.tools import workload  # noqa: E402
from surfjax_torch.tools.kernel_check import masks_of  # noqa: E402

from tests.test_torch_pipeline import CONFIG_DIR  # noqa: E402

SIZE = (40, 23)
N_RANDOM = 931   # rays from random origins: not a multiple of 32
K1_OUT = ("t", "obj", "nx", "ny", "nz", "ao", "hit", "unres")
K2_OUT = ("vis", "unres")
CASES = ("crowd_mesh config", "crowd_mesh soft", "crowd + mesh",
         "crowd soft", "random origins", "random origins soft",
         "opposed rays")
# ao_fix on the crowd_mesh frame's own call, each with another need: the
# mesh's lanes (the call's), one needing lane per warp (lane 7w mod 32 of
# warp w), lanes 0 and 31 of every warp, no lane, every lane
AO_FIX_CASES = ("ao_fix mesh", "ao_fix one lane", "ao_fix both ends",
                "ao_fix none", "ao_fix all")


def _split_rays(cam, cut=13):
    """The camera's rays in the split path's layout (render_frame_pallas:
    each 128-lane row 128 pixels of one image row, a padded lane repeating
    the row's last pixel), flat, the last `cut` rays left off so that the
    last warp is ragged."""
    intr = cam.intrinsics
    R = torch.as_tensor(np.asarray(cam.rotation, np.float32).reshape(9))
    rows = torch.arange(intr.height, dtype=torch.float32)
    cols = torch.clamp(torch.arange(rt.LANES, dtype=torch.float32),
                       max=float(intr.width - 1))
    rr, cc = torch.meshgrid(rows, cols, indexing="ij")
    d = camera_ray_dirs_dyn(intr, R, rr, cc)
    n = rr.numel() - cut
    d = tuple(c.reshape(-1)[:n].contiguous() for c in d)
    o = tuple(torch.full((n,), float(x), dtype=torch.float32)
              for x in cam.position)
    return o, d


def _random_rays(n, seed=3):
    """Rays from scattered origins above crowd_demo's floor, each aimed at
    a random point of the crowd's field."""
    rng = np.random.default_rng(seed)
    o = rng.uniform((-3.0, 0.2, -2.5), (3.0, 2.5, 1.0), (n, 3))
    tgt = rng.uniform((-4.5, -1.0, 1.5), (4.5, 0.0, 9.0), (n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (torch.as_tensor(a.astype(np.float32)) for a in (o, d))
    return tuple(o[:, k].contiguous() for k in range(3)), \
        tuple(d[:, k].contiguous() for k in range(3))


def _opposed_rays(n, seed=5):
    """Each point shot both ways: lane 2k+1 is lane 2k's ray with its
    direction negated, so a whole warp's directions sum to exactly 0."""
    o, d = _random_rays((n + 1) // 2, seed)
    o = tuple(c.repeat_interleave(2)[:n].contiguous() for c in o)
    d = tuple(torch.stack((c, -c), 1).reshape(-1)[:n].contiguous()
              for c in d)
    return o, d


def _case(name):
    """-> (scene_t, settings with vector_objects, o, d): flat rays."""
    if name.startswith(("crowd_mesh", "random", "opposed")):
        scene, cam, st, _ = pt_config.load_config(workload.CROWD_MESH)
        st = st.with_(backend="pallas", soft_shadows=name.endswith("soft"))
        cam = workload.reframe(cam, *SIZE)
    else:
        scene, cam, st = workload.crowd_cases(pt_api, SIZE)[name]
        st = st.with_(vector_objects=True)
    static, params = scene.freeze()
    scene_t = rt.SceneTensors(static, params_to_device(params, "cpu"))
    if name.startswith("random"):
        o, d = _random_rays(N_RANDOM)
    elif name.startswith("opposed"):
        o, d = _opposed_rays(N_RANDOM)
    else:
        o, d = _split_rays(cam)
    return scene_t, st, o, d


def _shadow_args(scene_t, st, o, d, k1):
    """K2's arguments per light from K1's plain outputs, as the split path
    forms them (without the mesh merge)."""
    t, _, nx, ny, nz, _, hit_f, _ = k1
    t_sane = torch.where(hit_f > 0.5, t, 0.0)
    p_off = rt._offset(o, d, t_sane, (nx, ny, nz), st)
    out = []

    def vis_fn(l, dist_eff, soft_k):
        out.append((scene_t, st, p_off, l, dist_eff, soft_k))
        return torch.ones_like(dist_eff)

    rt._light_terms(scene_t.static, st, scene_t.params, p_off, hit_f, vis_fn)
    return out


@functools.lru_cache(maxsize=None)
def _ao_fix_frame():
    """The ao_fix call of the port's plain split render of crowd_mesh at
    40x23 (the receivers of the frame's merged hits, need where the mesh
    won), its flat arrays cut to 8,179 lanes so that the last warp is
    ragged."""
    from surfjax_torch.tools.kernel_check import capture_calls
    scene, cam, st, _ = pt_config.load_config(workload.CROWD_MESH)
    with capture_calls() as calls:
        pt_api.render(scene, workload.reframe(cam, *SIZE),
                      st.with_(backend="pallas"), device="cpu")
    (args,) = [a for k, a in calls if k == "ao_fix"]
    n = args[4].numel() - 13

    def cut(a):
        return a.reshape(-1)[:n].contiguous()

    return (scene,) + args[:2] + (tuple(map(cut, args[2])),
                                  tuple(map(cut, args[3])), cut(args[4]),
                                  cut(args[5]))


def _ao_fix_args(name, scene_t=None):
    """-> the arguments of ao_fix on the crowd_mesh frame with the need of
    the case `name` (AO_FIX_CASES); scene_t: another scene in its place."""
    _, scene_t0, st, p_off, n, need, ao_in = _ao_fix_frame()
    lane = torch.arange(need.numel()) % 32
    warp = torch.arange(need.numel()) // 32
    kind = name.split(" ", 1)[1]
    pick = {"mesh": need > 0.5, "one lane": lane == (7 * warp) % 32,
            "both ends": (lane == 0) | (lane == 31),
            "none": torch.zeros_like(need, dtype=torch.bool),
            "all": torch.ones_like(need, dtype=torch.bool)}[kind]
    return (scene_t or scene_t0, st, p_off, n,
            torch.where(pick, 1.0, 0.0), ao_in)


@functools.lru_cache(maxsize=None)
def _calls(name, cap=0):
    """-> [(kernel, args, plain outputs)] of one K1 call and the K2 call
    of every light, or of one ao_fix call (AO_FIX_CASES); cap: march_cap
    and shadow_march_cap (ao_fix takes none)."""
    if name.startswith("ao_fix"):
        args = _ao_fix_args(name)
        args = (args[0], args[1].with_(march_cap=cap,
                                       shadow_march_cap=cap)) + args[2:]
        return [("ao_fix", args, rt.ao_fix_reference(*args))]
    scene_t, st, o, d = _case(name)
    st = st.with_(march_cap=cap, shadow_march_cap=cap)
    k1_args = (scene_t, st, o, d)
    k1 = rt.render_tile_reference(*k1_args)
    calls = [("render_tile", k1_args, k1)]
    shadow = _shadow_args(scene_t, st, o, d, k1)
    if name.startswith("opposed"):
        # the opposed rays as shadow rays too: K2's capsule from them
        n = o[0].numel()
        shadow.append((scene_t, st, o, d, torch.full((n,), 6.0),
                       torch.full((n,), f32(st.soft_shadow_k))))
    for args in shadow:
        calls.append(("trace_rays", args, rt.trace_rays_reference(*args)))
    return calls


# --- (a) the scene ----------------------------------------------------------

def test_crowd_mesh_yaml_is_crowd_demo_plus_c4s_octasphere():
    """Both loaders give the same tables, camera and settings; the port's
    first 49 objects and its lights are crowd_demo's, the 50th c4's mesh
    (8192 triangles) at scale 1.5 resting on the floor."""
    sj = sj_config.load_config(workload.CROWD_MESH)
    pt = pt_config.load_config(workload.CROWD_MESH)
    ref_static, ref_params = sj[0].freeze()
    static, params = pt[0].freeze()
    assert static == ref_static
    assert sorted(params) == sorted(ref_params)
    for key, ref in ref_params.items():
        got = np.asarray(params[key])
        assert got.dtype == ref.dtype and got.shape == ref.shape, key
        assert got.tobytes() == ref.tobytes(), key
    assert (pt[1].position, pt[1].rotation) == (sj[1].position,
                                                sj[1].rotation)
    demo_scene, demo_cam, demo_st, _ = pt_config.load_config(
        os.path.join(CONFIG_DIR, "crowd_demo.yaml"))
    scene = pt[0]
    assert (pt[1].position, pt[1].rotation) == \
        (demo_cam.position, demo_cam.rotation)
    assert pt[2] == demo_st
    assert len(scene.objects) == 50
    assert scene.objects[:49] == demo_scene.objects
    assert scene.lights == demo_scene.lights
    assert static.ir.n_meshes == 1 and static.mesh_static[0].n_tris == 8192
    # the octasphere rests on the floor (y = -1), in the crowd's field
    verts = scene.objects[49].node.vertices
    assert abs(float(verts[:, 1].min()) + 1.0) < 1e-6
    assert rt.split_crowd(static, pt[2])[0].members[-1][0] < 49
    assert len(rt.split_crowd(static, pt[2])[0].members) == 48


def test_port_renders_crowd_and_mesh_through_the_split_path():
    """The port's plain split render at 64x36 (backend pallas on the CPU):
    K1 and K2 with the crowd, the mesh kernel, ao_fix; the mesh and at
    least 10 crowd members on screen."""
    from surfjax_torch.tools.kernel_check import capture_calls
    scene, cam, st, _ = pt_config.load_config(workload.CROWD_MESH)
    with capture_calls() as calls:
        fb = pt_api.render(scene, workload.reframe(cam, 64, 36),
                           st.with_(backend="pallas", tile_rows=8),
                           device="cpu")
    names = [c[0] for c in calls]
    assert names.count("render_tile") == 1 and names.count("ao_fix") == 1
    assert names.count("trace_rays") == 2 and names.count("mesh_tile") == 3
    ids = torch.unique(fb.obj_id)
    assert 49 in ids.tolist()
    assert int(((ids >= 0) & (ids < 49)).sum()) >= 10
    assert bool(torch.isfinite(fb.rgb).all())


# --- (b) conservative masks -------------------------------------------------

def _gates(kname, args):
    """key -> (lanes, members) bool: the lanes whose exact per-lane gate
    keeps the member in that loop (flat rays)."""
    scene_t, st = args[:2]
    static, params = scene_t
    lp, nparams = params["leaf_params"], params["node_params"]
    crowd = rt.split_crowd(static, st)[0]
    refs = rt._crowd_refs(static, st, lp, nparams)
    em = rt._exit_margin(st)
    sdf_end, single_end = crowd.n_sph_sdf + crowd.n_box_sdf, crowd.n_singles
    cols = {}
    if kname == "ao_fix":
        o, need = args[2], args[4] > 0.5
        gate = f32(2.0 * f32(st.ao_radius))
    elif kname == "render_tile":
        o, d = args[2], args[3]
        t, obj, leaf, hit_f, _ = rt.trace_core(static, st, lp, nparams, o, d)
        t_sane = torch.where(hit_f > 0.5, t, 0.0)
        p = tuple(o[k] + t_sane * d[k] for k in range(3))
        n = rt.normals_core(static, st, lp, nparams, p, obj, leaf, d)
        q0 = tuple(p[k] + n[k] * f32(st.shadow_eps) for k in range(3))
        t_min = torch.full_like(o[0], f32(st.t_min))
        t_max = torch.full_like(o[0], f32(st.t_max))
        gate = f32(2.0 * f32(st.ao_radius))
    else:
        o, l, dist, kf = args[2:]
        act = ~(dist <= 0.0)
        eps = f32(st.shadow_eps)
        t0 = f32(st.soft_shadow_tmin)
    for lo, hi, tag in crowd.all_ranges + crowd.pair_ranges:
        for j in range(lo, hi):
            b, sdf_j = rt._crowd_shape(crowd, refs, j, tag)
            prm = lp[int(refs[0][j, 0])]
            ana = sdf_end <= j < single_end
            if kname == "ao_fix":      # AO's far gate on the needing lanes
                dx, dy, dz = (o[k] - b[k] for k in range(3))
                cols.setdefault("ao", {})[j] = need & (rt.sqrt(
                    (dx * dx + dy * dy) + dz * dz) - b[3] <= gate)
            elif kname == "render_tile":
                if ana:
                    cols.setdefault("primary_ana", {})[j] = rt._leaf_exact_t(
                        prm, tag, o, d, f32(st.t_min), f32(st.t_max)) \
                        < BIG * 0.5
                else:
                    t1, clip2 = rt._bound_entry(b, o, d, t_min, t_max, em)
                    cols.setdefault("primary_sdf", {})[j] = t1 < clip2
                if st.ao:
                    dx, dy, dz = (q0[k] - b[k] for k in range(3))
                    cols.setdefault("ao", {})[j] = rt.sqrt(
                        (dx * dx + dy * dy) + dz * dz) - b[3] <= gate
            elif st.soft_shadows:
                if tag is True:
                    v = rt._penumbra_sphere(prm, o, l, t0, dist, kf)
                else:
                    t_lo, t_hi = rt._influence_window(b, o, l, t0, dist, kf)
                    v, _ = rt._soft_march(sdf_j, o, l, maximum(t_lo, t0),
                                          torch.minimum(dist, t_hi), kf,
                                          st.shadow_steps,
                                          relax=st.over_relax)
                cols.setdefault("soft", {})[j] = act & (v < 1.0)
            elif ana:
                cols.setdefault("hard_ana", {})[j] = act & (rt._leaf_exact_t(
                    prm, tag, o, l, eps, dist) < dist)
            else:
                cols.setdefault("hard_sdf", {})[j] = act & (rt._seg_bound_dist(
                    b, o, l, eps, dist) <= f32(em))
    out = {}
    for key, by_j in cols.items():
        g = torch.zeros((o[0].numel(), len(crowd.members)), dtype=torch.bool)
        for j, lanes in by_j.items():
            g[:, j] = lanes.reshape(-1)
        out[key] = g
    return out


@pytest.mark.parametrize("name", CASES + AO_FIX_CASES)
def test_masks_are_conservative(name):
    for kname, args, _ in _calls(name):
        masks = masks_of(kname, args)
        gates = _gates(kname, args)
        assert set(gates) <= set(masks.masks), (kname, sorted(masks.masks))
        for key, m in masks.masks.items():
            need = torch.zeros(m.shape, dtype=torch.int32)
            if key in gates:
                need.index_add_(0, masks.warp_of.reshape(-1),
                                gates[key].to(torch.int32))
            bad = ((need > 0) & ~m).nonzero().tolist()
            assert not bad, (name, kname, key, bad[:8])
        assert masks.warp_of.numel() % 32   # the last warp is ragged


def test_opposed_rays_leave_no_mean_direction():
    """Every whole warp of the opposed case sums its directions to exactly
    0 (the butterfly's order is symmetric under negation), so its K1 and
    K2 capsules take the fallback axis (1, 0, 0)."""
    _, _, o, d = _case("opposed rays")
    n = o[0].numel() // 32 * 32
    sums = [rt._warp_sum(c[:n].reshape(-1, 32)) for c in d]
    assert all(bool((c == 0.0).all()) for c in sums)
    active = torch.ones((n // 32, 32), dtype=torch.bool)
    seg = rt._warp_rays(tuple(c[:n].reshape(-1, 32) for c in o),
                        tuple(c[:n].reshape(-1, 32) for c in d),
                        torch.full((n // 32, 1), 6.0), 0.0, active)
    assert bool((seg.u[0] == 1.0).all() & (seg.u[1] == 0.0).all()
                & (seg.u[2] == 0.0).all())
    assert bool(torch.isfinite(seg.sig).all() & (seg.sig <= 2.0).all())


# --- (c) masks change nothing -----------------------------------------------

@pytest.mark.parametrize("cap", [0, 2])
@pytest.mark.parametrize("name", CASES + AO_FIX_CASES)
def test_masked_plain_equals_unmasked(name, cap):
    for kname, args, ref in _calls(name, cap):
        masks = masks_of(kname, args)
        if kname == "ao_fix":
            got = (rt.ao_fix_reference(*args, masks=masks),)
            ref = (ref,)
            names = ("ao",)
        elif kname == "render_tile":
            got = rt.render_tile_reference(*args, masks=masks)
            names = K1_OUT
        else:
            got = rt.trace_rays_reference(*args, masks=masks)
            names = K2_OUT
        assert len(got) == len(ref) == len(names)
        for label, a, b in zip(names, got, ref):
            assert torch.equal(a, b), (name, cap, kname, label)
    if cap and not name.startswith(("random", "opposed", "ao_fix")):
        # the caps cut some march off: unres is not trivially 0
        assert any(float(c[2][-1].sum()) > 0 for c in _calls(name, cap))


def test_soft_cap_keeps_every_member_where_a_window_is_whole():
    """Under a shadow march cap a warp holding a lane of kf < 1.2 (a
    window over the whole segment) keeps every member and every other warp
    votes as without a cap; the masked plain version equals the unmasked
    one with the cap, unres included."""
    _, args, _ = _calls("crowd_mesh soft")[1]
    scene_t, st, o, l, dist, kf = args
    lane = int(torch.nonzero(~(dist.reshape(-1) <= 0.0))[0])
    kf = kf.clone()
    kf.view(-1)[lane] = 1.1
    rays = (o, l, dist, kf)
    capped_st = st.with_(shadow_march_cap=4)
    capped = rt.split_warp_masks(scene_t, capped_st, None, None,
                                 shadow_rays=(rays,)).k2[0]
    free = rt.split_warp_masks(scene_t, st, None, None,
                               shadow_rays=(rays,)).k2[0]
    warp = lane // 32
    assert bool(capped.masks["soft"][warp].all())
    others = torch.arange(capped.masks["soft"].shape[0]) != warp
    assert torch.equal(capped.masks["soft"][others],
                       free.masks["soft"][others])
    assert not bool(free.masks["soft"][others].all())
    got = rt.trace_rays_reference(scene_t, capped_st, *rays, masks=capped)
    ref = rt.trace_rays_reference(scene_t, capped_st, *rays)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# --- (d) masks cut work ----------------------------------------------------

@pytest.mark.parametrize("name", ["crowd_mesh config", "crowd_mesh soft",
                                  "ao_fix mesh"])
def test_masks_cut_work(name):
    """Mean masked members per warp of each loop at most 16 of 48 on
    crowd_mesh at 40x23, and count_ops of the culled algorithm below 0.8 of
    the unculled one (module docstring has the figures). ao_fix (the
    mesh's lanes) cuts the members its needing lanes visit, each its
    warp's masked ones, below 0.8 of the 48 each visits unculled, but not
    its count_ops: each warp with a needing lane votes (the ball, one test
    per member), which costs more operations than the gates it saves."""
    for kname, args, _ in _calls(name):
        masks = masks_of(kname, args)
        for loop, (mean, top) in masks.counts().items():
            assert mean <= 16.0, (kname, loop, mean, top)
        if kname == "ao_fix":
            need = args[4].reshape(-1) > 0.5
            m = masks.masks["ao"]
            visits = int(m[masks.warp_of.reshape(-1)[need]].sum())
            assert 0 < visits < 0.8 * int(need.sum()) * m.shape[1]
            continue
        ref = rt.render_tile_reference if kname == "render_tile" else \
            rt.trace_rays_reference
        with rt.count_ops() as plain:
            ref(*args)
        with rt.count_ops() as culled:
            ref(*args, masks=masks)
        assert culled["ops"] < 0.8 * plain["ops"], kname


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


@pytest.mark.parametrize("delta", [-1.0, 0.0, 1.0])
def test_ao_fix_member_swept_across_the_boundary(delta):
    """ao_fix with need on every lane of the crowd_mesh frame: the SDF
    sphere member nearest a warp's AO test boundary (outside it) is grown
    until the test sits at delta times its slack from the boundary (-1:
    one slack outside, 0: on it, 1: one slack inside): the masks stay
    conservative and the masked plain version equal to the unmasked one."""
    args = _ao_fix_args("ao_fix all")
    masks = masks_of("ao_fix", args)
    seg, reach, rel = masks.tests["ao"]
    crowd = rt.split_crowd(args[0].static, args[1])[0]
    margin = rt.cull_margin(masks.bounds, reach, seg, rel)
    slack = rt.cull_margin(masks.bounds, reach, seg, 0.0) - margin
    sph = torch.zeros_like(margin, dtype=torch.bool)
    sph[:, :crowd.n_sph_sdf] = True
    near = torch.where(sph & seg.any & (margin > 0.0), margin, float("inf"))
    w, j = divmod(int(near.argmin()), near.shape[1])
    grow = (float(margin[w, j]) + delta * float(slack[w, j])) / (1.0 + rel)
    scene = _with_radius(_ao_fix_frame()[0], crowd.members[j][0],
                         float(masks.bounds[3][j]) + grow)
    static, params = scene.freeze()
    args = _ao_fix_args("ao_fix all", rt.SceneTensors(
        static, params_to_device(params, "cpu")))
    masks = masks_of("ao_fix", args)
    if delta:       # one slack inside: voted in; one slack outside: not
        assert bool(masks.masks["ao"][w, j]) == (delta > 0)
    gates = _gates("ao_fix", args)["ao"]
    need = torch.zeros(masks.masks["ao"].shape, dtype=torch.int32)
    need.index_add_(0, masks.warp_of, gates.to(torch.int32))
    assert not ((need > 0) & ~masks.masks["ao"]).any()
    assert torch.equal(rt.ao_fix_reference(*args),
                       rt.ao_fix_reference(*args, masks=masks))
