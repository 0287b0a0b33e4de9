"""Scenes past the CUDA route's former fixed bounds: more than 64 objects
outside the crowd, tapes of more than 32 nodes and analytic objects of more
than 16 leaves (workload.limit_cases), which surfjax's Pallas path renders
and the port's kernel route now takes too.

  * tape_rows, the host's rows of a tape: on random tapes from a seed
    (random, left-deep, right-deep, balanced and zigzag trees), surfjax's
    post-order rows up to 32 nodes and slot rows past it, at most
    floor(log2(leaves)) + 1 slots, the root's value in slot 0, each node's
    value bitwise the one surfjax's post-order gives, and the bound's
    margin rows in the post-order's order;
  * check_scene: raises only past the staged kernels' shared memory (the
    bytes of the layout and of the limit in its message), and takes every
    case;
  * the kernels' own sources built for the CPU behind the host stand-in of
    the CUDA runtime (tests/cuda_host.py): K1, K2 and ao_fix without a
    crowd (split_staged.cu, ao_fix_staged.cu) and with one (split_path.cu,
    ao_fix_crowd.cu), and the priming kernel (prime_tile.cu), on every
    call of the cases at 16x16 (the priming kernel, and ao_fix with a
    crowd beside a mesh, at 32x32), bitwise equal to their plain versions;
  * the port's pallas render of the one-object cases of 17 leaves (33
    nodes, SDF and analytic) against surfjax's Pallas path in interpret
    mode, as surfjax's own tests run it (the bounds in the test), and of
    the analytic unions of 17 and 40 leaves against surfjax's `jnp`
    backend run op by op, bitwise. The 65-leaf tapes (129 nodes) are held
    to the Pallas path in tests/test_torch_scene_limits_tape65*.py; the
    many-object cases' kernel calls to surfjax's kernel bodies op by op
    in tests/test_torch_scene_limits_bodies.py, their frames to its
    Pallas path in tests/test_torch_scene_limits_ref.py.
"""

import contextlib
import ctypes
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import surfjax.api as sj_api  # noqa: E402

import surfjax_torch.api as api  # noqa: E402
from surfjax_torch.api import (  # noqa: E402
    OP_INTERSECT, OP_LEAF, OP_SMOOTH_INTERSECT, OP_SMOOTH_SUBTRACT,
    OP_SMOOTH_UNION, OP_SUBTRACT, OP_UNION,
)
from surfjax_torch.core.camera import flat_camera_rays  # noqa: E402
from surfjax_torch.core.scene_compile import (  # noqa: E402
    NodeIR, params_to_device,
)
from surfjax_torch.kernels import _build  # noqa: E402
from surfjax_torch.kernels import render_tile as rt  # noqa: E402
from surfjax_torch.tools import workload  # noqa: E402
from surfjax_torch.tools.kernel_check import (  # noqa: E402
    KERNELS, capture_calls, flat,
)

from tests import cuda_host  # noqa: E402
from tests.test_torch_pipeline import assert_tight, gaps  # noqa: E402

SIZE = (16, 16)
CASES = workload.limit_cases(api, SIZE)
# the 65-leaf tapes take surfjax's interpret mode minutes each: they are
# held to it in files of their own (test_torch_scene_limits_tape65*.py);
# the 40-leaf union more than 25 minutes: it is held to surfjax's `jnp`
# backend run op by op, bitwise (test_analytic_unions_equal_surfjax_jnp)
ONE_OBJECT = ["smooth 17 left", "smooth 17 right", "union 17"]
SMOOTH = (OP_SMOOTH_UNION, OP_SMOOTH_INTERSECT, OP_SMOOTH_SUBTRACT)
OPS = (OP_UNION, OP_INTERSECT, OP_SUBTRACT) + SMOOTH


# --- the slot allocation ----------------------------------------------------

def _random_tape(rng, n_leaves: int, shape: str):
    """A post-order tape of n_leaves leaves in surfjax's layout (children
    left first, pslots up the post-order) -> (nodes, leaf values, k)."""
    nodes, ks = [], []

    def build(lo, hi):          # leaves [lo, hi)
        if hi - lo == 1:
            nodes.append(NodeIR(OP_LEAF, -1, -1, lo, -1))
            return len(nodes) - 1
        if shape == "left":
            mid = hi - 1
        elif shape == "right":
            mid = lo + 1
        elif shape == "balanced":
            mid = (lo + hi) // 2
        elif shape == "zigzag":
            mid = lo + 1 if (hi - lo) % 2 else hi - 1
        else:
            mid = int(rng.integers(lo + 1, hi))
        a = build(lo, mid)
        b = build(mid, hi)
        op = int(rng.choice(OPS))
        pslot = -1
        if op in SMOOTH:
            pslot = len(ks)
            ks.append(np.float32(rng.uniform(0.05, 0.5)))
        nodes.append(NodeIR(op, a, b, -1, pslot))
        return len(nodes) - 1

    build(0, n_leaves)
    vals = rng.normal(0.0, 1.0, n_leaves).astype(np.float32)
    return nodes, vals, np.asarray(ks, np.float32)


def _apply(op, a, b, k):
    """One node, as eval_obj computes it (float32 throughout)."""
    f = np.float32
    with np.errstate(over="ignore"):
        if op == OP_UNION:
            return min(a, b)
        if op == OP_INTERSECT:
            return max(a, b)
        if op == OP_SUBTRACT:
            return max(a, -b)
        sat = lambda x: f(min(max(x, f(0.0)), f(1.0)))  # noqa: E731
        if op == OP_SMOOTH_UNION:
            h = sat(f(0.5) + f(0.5) * (b - a) / k)
            return (b + (a - b) * h) - k * h * (f(1.0) - h)
        if op == OP_SMOOTH_INTERSECT:
            h = sat(f(0.5) - f(0.5) * (b - a) / k)
            return (b + (a - b) * h) + k * h * (f(1.0) - h)
        h = sat(f(0.5) - f(0.5) * (b + a) / k)
        return (a + (-b - a) * h) + k * h * (f(1.0) - h)


SHAPES = ("random", "left", "right", "balanced", "zigzag")


def _walk(rows, n_nodes, leaf_vals, ks):
    """The kernels' tape walkers on tape_rows' rows (eval_obj up to
    TAPE_NODES nodes, eval_obj_slots past it) -> (each row's value in row
    order, the root's value, the slots used)."""
    vals, got, top = {}, [], 0
    slot_rows = n_nodes > rt.TAPE_NODES
    for k, (op, a, b, leaf, pslot) in enumerate(rows):
        if op == rt.OP_MARGIN:
            assert slot_rows and a == b == leaf == -1
            continue
        if op == OP_LEAF:
            v, dst = leaf_vals[leaf], (a if slot_rows else k)
        else:
            kp = -2 - pslot if slot_rows else pslot
            v = _apply(op, vals[a], vals[b], ks[kp] if kp >= 0 else None)
            dst = leaf if slot_rows else k
            if slot_rows:   # the operands' slots are free once consumed
                del vals[max(a, b)]
        vals[dst] = v
        top = max(top, dst + 1)
        got.append(np.float32(v).tobytes())
    root = vals[0] if slot_rows else vals[len(rows) - 1]
    return got, root, top


@pytest.mark.parametrize("n_leaves", [1, 2, 3, 16, 17, 65, 300])
@pytest.mark.parametrize("shape", SHAPES)
def test_slots_bounded_and_values_bitwise(shape, n_leaves):
    """Every node's value bitwise the one surfjax's post-order gives (the
    rows keep a and b in their roles), the root's among them; past 32
    nodes at most floor(log2(leaves)) + 1 slots, and the margin rows'
    pslots in the post-order's order."""
    rng = np.random.default_rng(1000 * n_leaves + SHAPES.index(shape))
    nodes, leaf_vals, ks = _random_tape(rng, n_leaves, shape)
    by_node = []
    for nd in nodes:
        by_node.append(leaf_vals[nd.leaf] if nd.op == OP_LEAF else _apply(
            nd.op, by_node[nd.a], by_node[nd.b],
            ks[nd.pslot] if nd.pslot >= 0 else None))
    rows = rt.tape_rows(nodes)
    assert all(len(r) == rt.NODE_W for r in rows)
    got, root, n_slots = _walk(rows, len(nodes), leaf_vals, ks)
    assert np.float32(root).tobytes() == np.float32(by_node[-1]).tobytes()
    assert sorted(got) == sorted(np.float32(v).tobytes() for v in by_node)
    pslots = [nd.pslot for nd in nodes if nd.pslot >= 0]
    if len(nodes) <= rt.TAPE_NODES:
        assert rows == [list(nd) for nd in nodes]
        return
    assert n_slots <= int(math.log2(n_leaves)) + 1 <= rt.TAPE_SLOTS
    assert len(rows) == len(nodes) + len(pslots)
    # object_bound adds the k of each row with a pslot >= 0, in row order
    assert [r[4] for r in rows if r[4] >= 0] == pslots
    if shape == "right":
        # surfjax's left-first order keeps every leaf of this chain live
        assert n_slots == 2


def test_slot_values_bitwise_on_random_tapes():
    """Forty random tapes of 17 to 120 leaves: the walker's values are
    the post-order's, bitwise, node for node."""
    rng = np.random.default_rng(7)
    for trial in range(40):
        n = int(rng.integers(17, 120))
        nodes, leaf_vals, ks = _random_tape(rng, n, "random")
        by_node = []
        for nd in nodes:
            by_node.append(leaf_vals[nd.leaf] if nd.op == OP_LEAF
                           else _apply(nd.op, by_node[nd.a], by_node[nd.b],
                                       ks[nd.pslot] if nd.pslot >= 0
                                       else None))
        got, root, n_slots = _walk(rt.tape_rows(nodes), len(nodes),
                                   leaf_vals, ks)
        assert sorted(got) == sorted(np.float32(v).tobytes()
                                     for v in by_node), trial
        assert n_slots <= int(math.log2(n)) + 1


def test_mesh_objects_have_no_rows():
    assert rt.tape_rows(()) == []


# --- check_scene --------------------------------------------------------------

def _spheres(n: int):
    scene = api.Scene()
    for i in range(n):
        scene.add(api.Sphere(center=(0.01 * i, 0.0, 3.0), radius=0.1),
                  engine="sdf")
    scene.add_light(api.PointLight(position=(0.0, 3.0, 0.0)))
    return scene.freeze()[0]


@pytest.mark.parametrize("meshes", [False, True])
def test_check_scene_raises_only_past_shared_memory(meshes):
    """The fused path's layout holds the pixels' records, the split path's
    not: 1,400 single-leaf objects fit, give or take 50 (160 bytes each),
    and one more raises, naming the layout's bytes and the limit."""
    st = api.RenderSettings(backend="pallas")
    lo = 1300
    lay = rt.staged_layout(*rt._table_sizes(rt._packed(_spheres(lo),
                                                      False)[0]),
                           records=not meshes)
    per = rt.staged_layout(*rt._table_sizes(rt._packed(_spheres(lo + 100),
                                                      False)[0]),
                           records=not meshes).bytes - lay.bytes
    assert 160 * 100 <= per <= 168 * 100
    n = lo + (rt.SMEM_OPTIN_H100 - lay.bytes) // (per // 100)
    while rt.staged_layout(*rt._table_sizes(rt._packed(
            _spheres(n), False)[0]), records=not meshes).bytes > \
            rt.SMEM_OPTIN_H100:
        n -= 1
    assert 1300 <= n <= 1500
    rt.check_scene(_spheres(n), st, meshes=meshes)
    big = _spheres(n + 1)
    want = rt.staged_layout(*rt._table_sizes(rt._packed(big, False)[0]),
                            records=not meshes).bytes
    with pytest.raises(ValueError) as err:
        rt.check_scene(big, st, meshes=meshes)
    assert f"{want} bytes" in str(err.value)
    assert str(rt.SMEM_OPTIN_H100) in str(err.value)
    # a crowd stages nothing: the same scene takes the member loops
    rt.check_scene(big, st.with_(vector_objects=True), meshes=meshes)


@pytest.mark.parametrize("name", list(CASES))
def test_check_scene_takes_every_case(name):
    scene, _, st = CASES[name]
    static, _ = scene.freeze()
    rt.check_scene(static, st, meshes=True)
    if "mesh" not in name:
        rt.check_scene(static, st)


def _chain_scene(n_leaves: int, engine: str):
    scene = api.Scene()
    scene.add(workload.tape_object(api, n_leaves, True,
                                   smooth=engine == "sdf"), engine=engine)
    return scene.freeze()[0]


def test_wide_scene_only_past_the_arrays():
    """The kernels' KF_WIDE build takes a scene only past the default
    build's arrays: more than 64 objects outside the crowd, a tape of more
    than 32 nodes (an analytic object of more than 16 leaves)."""
    import os
    from surfjax_torch.config import load_config
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for cfg in ("c1_sphere", "c2_csg", "c3_sdf", "c4_mesh", "c5_anim",
                "crowd_demo"):
        static = load_config(os.path.join(root, "configs", cfg + ".yaml"))[
            0].freeze()[0]
        assert not rt.wide_scene(static, cfg == "crowd_demo"), cfg
    assert not rt.wide_scene(_spheres(63), False)
    assert rt.wide_scene(_spheres(65), False)
    assert not rt.wide_scene(_spheres(65), True)   # the crowd takes them
    for engine in ("sdf", "analytic"):
        assert not rt.wide_scene(_chain_scene(16, engine), False)
        assert rt.wide_scene(_chain_scene(17, engine), False)


# --- the kernels' sources on the host -----------------------------------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """Every split kernel's source and the priming kernel's, in the default
    and the KF_WIDE build, built for the host as one stand-in of the
    kernels' library; the launchers pass their tensors' device index,
    None on the CPU, which each entry here replaces by 0."""
    if cuda_host.gxx() is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    rays = [rt.KFTables, rt.KFSettings, rt.SplitRays]
    # entry -> (source, argument types, index of the device argument)
    entries = {
        "sp_staged_render_tile": ("split_staged", rays + [ptr, i32, ptr], 4),
        "sp_staged_trace_rays": ("split_staged", [
            rt.KFTables, rt.KFSettings, rt.KSLayout, rt.SplitRays, ptr, ptr,
            i32, ptr], 6),
        "sp_staged_ao_fix": ("ao_fix_staged", rays + [ptr, i32, ptr], 4),
        "sp_render_tile": ("split_path", rays + [i32, ptr], 3),
        "sp_trace_rays": ("split_path", rays + [i32, ptr], 3),
        "sp_ao_fix": ("ao_fix_crowd", rays + [ptr, i32, ptr], 4),
        "pt_prime_tile": ("prime_tile", [
            rt.KFTables, rt.KFSettings, rt.KSLayout, rt.PrimeArgs, ptr, i32,
            ptr], 5),
    }
    libs, fns = {}, {}
    for entry, (source, argtypes, at) in entries.items():
        for wide in ("", "_wide"):
            unit = source + wide + ".cu"
            if unit not in libs:
                libs[unit] = cuda_host.build(unit, str(
                    tmp_path_factory.mktemp(source + wide)))
            f = getattr(libs[unit], entry + wide)
            f.argtypes = argtypes

            def call(*args, f=f, at=at):
                return f(*args[:at], 0, *args[at + 1:])
            fns[entry + wide] = call
    return types.SimpleNamespace(**fns)


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """The launchers load the host library and launch on a stand-in
    stream."""
    monkeypatch.setattr(_build, "load", lambda: host_lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))


def split_calls(name: str, size=SIZE):
    """The split-path kernel calls of a case: a mesh scene's render, or
    the split path's forward over the camera's flat rays (as the fit
    renders a scene without a mesh)."""
    scene, cam, st = workload.limit_cases(api, size)[name]
    if "mesh" in name:
        with capture_calls() as calls:
            api.render(scene, cam, st, device="cpu")
        return calls
    static, params = scene.freeze()
    R = torch.as_tensor(np.asarray(cam.rotation, np.float32).reshape(9))
    pos = torch.as_tensor(np.asarray(cam.position, np.float32))
    o, d, _ = flat_camera_rays(cam.intrinsics, R, pos)
    with capture_calls() as calls:
        rt.render_rays_pallas(static, st, params_to_device(params, "cpu"),
                              o, d)
    return calls


def _hold(calls, label):
    """Each call through its kernel's launcher against its plain version,
    bitwise -> the names called."""
    names = []
    for k, (kname, args) in enumerate(calls):
        if kname in ("mesh_candidates", "mesh_tile"):
            continue
        ref = flat(KERNELS[kname][1](*args))
        launch, out = KERNELS[kname][3](*args)[:2]
        launch()
        out = flat(out)
        assert out and len(out) <= len(ref)
        for j, (a, b) in enumerate(zip(out, ref)):
            assert torch.equal(a, b), f"{label} call {k} {kname} output {j}"
        names.append(kname)
    return names


@pytest.mark.parametrize("name", list(CASES))
def test_host_split_kernels_equal_plain(on_host, name):
    calls = split_calls(name)
    names = _hold(calls, name)
    assert {"render_tile", "trace_rays"} <= set(names), names
    if "mesh" in name:
        assert "ao_fix" in names
    static = CASES[name][0].freeze()[0]
    assert rt.launches_crowd(static, CASES[name][2]) == \
        name.startswith("crowd")
    assert rt.wide_scene(static, bool(CASES[name][2].vector_objects))


@pytest.mark.parametrize("name", ["mesh + 70", "crowd 120+8+70 + mesh"])
def test_host_mesh_crowd_ao_fix_equals_plain(on_host, name):
    """ao_fix with a crowd on the frame's own call. `mesh + 70` with the
    crowd on: 70 members, the floor alone outside (the default build).
    `crowd 120+8+70 + mesh` at 32x32: 71 objects outside the crowd (the
    KF_WIDE build), the mesh among the last row of three-leaf unions, so
    that its receivers' AO takes objects past the mask's 64 (without
    them the kernel's ao differs from the plain version's)."""
    scene, cam, st = workload.limit_cases(api, (32, 32))[name]
    st = st.with_(vector_objects=True)
    static = scene.freeze()[0]
    assert rt.wide_scene(static, True) == name.startswith("crowd")
    with capture_calls() as calls:
        api.render(scene, cam, st, device="cpu")
    need = [args[4] for kname, args in calls if kname == "ao_fix"]
    assert len(need) == 1 and int((need[0] > 0.5).sum()) > 5
    names = _hold(calls, f"{name} crowd")
    assert "ao_fix" in names


@pytest.mark.parametrize("name", ["64 spheres", "smooth 65 right"])
def test_host_priming_kernel_equals_plain(on_host, name):
    scene, cam, st = workload.limit_cases(api, (32, 32))[name]
    with capture_calls() as calls:
        api.render(scene, cam, st.with_(prime=True, prime_min=32),
                   device="cpu")
    assert [k for k, _ in calls] == ["prime_tile"]
    assert _hold(calls, name) == ["prime_tile"]


# --- the port against surfjax's Pallas path ---------------------------------

@pytest.mark.parametrize("name", ONE_OBJECT)
def test_one_object_matches_surfjax_pallas(name):
    """The port's kernel route on the CPU (its plain versions) against
    surfjax's Pallas path in interpret mode on the same scene: hits and
    ids equal, depth within 1e-5 relative and normals under the North
    star's bounds; rgb within 2e-4, the bound the port's crowd tests hold
    to surfjax's interpret mode (measured: smooth 17 left 6.9e-5, union 17
    4.0e-5, smooth 17 right within 2e-5). The gap is surfjax's: XLA:CPU
    fuses the interpret-mode kernel's arithmetic (the b*b - c of a
    sphere's interval, ROADMAP's settled items; the nested smooth unions),
    and a hit point's last bits reach the normal (1.0e-4 and 1.8e-4) and
    the shading. The witness: the object's SDF through the port's tape
    and through surfjax's run op by op (jax.disable_jit), bitwise the same
    at 4096 points around it."""
    sj_scene, sj_cam, sj_st = workload.limit_cases(sj_api, SIZE)[name]
    scene, cam, st = CASES[name]
    ref = sj_api.render(sj_scene, sj_cam, sj_st)
    got = api.render(scene, cam, st, device="cpu")
    g = gaps(ref, got)
    assert g["hit_agree"] == 1.0 and g["obj_agree"] == 1.0, g
    assert g["depth_rel_max"] <= 1e-5 and g["normal_max"] < 5e-2, g
    assert g["lanes_normal_gt_1e-3"] <= 8 and g["rgb_max"] <= 2e-4, g
    assert float(got.hit.mean()) > 0.2
    assert int((got.obj_id == 0).sum()) > 10   # the object is in view
    assert sdf_witness(sj_scene, scene)


def sdf_witness(sj_scene, scene, n: int = 4096, seed: int = 65) -> bool:
    """Whether the first object's SDF through the port's tape and through
    surfjax's, run op by op, agree bitwise at n seeded points around the
    limit cases' objects."""
    import jax.numpy as jnp
    from surfjax.engines.sdf import eval_sdf as sj_eval_sdf

    from surfjax_torch.engines.sdf import eval_sdf
    pts = np.random.default_rng(seed).uniform(
        (-1.0, -0.9, 2.3), (1.0, -0.2, 4.1), (n, 3)).astype(np.float32)
    static, params = scene.freeze()
    sj_static, sj_params = sj_scene.freeze()
    mine = eval_sdf(static.ir.objects[0],
                    torch.as_tensor(params["leaf_params"]),
                    torch.as_tensor(params["node_params"]),
                    tuple(torch.as_tensor(pts[:, k]) for k in range(3)))
    with jax.disable_jit():
        theirs = sj_eval_sdf(sj_static.ir.objects[0],
                             jnp.asarray(sj_params["leaf_params"]),
                             jnp.asarray(sj_params["node_params"]),
                             tuple(jnp.asarray(pts[:, k]) for k in range(3)))
    return bool(np.array_equal(mine.numpy(), np.asarray(theirs)))


@pytest.mark.parametrize("name", ["union 17", "union 40"])
def test_analytic_unions_equal_surfjax_jnp(name):
    """An analytic union of 17 or 40 leaves over an analytic floor: the
    port's kernel route on the CPU equals surfjax's `jnp` backend run op
    by op (jax.disable_jit), bitwise in every buffer. Both take the same
    event CSG for the primary hit and for hard shadows, analytic normals,
    and AO folds the same terms; surfjax's Pallas path in interpret mode
    takes more than 25 minutes on the 40-leaf union at 16x16."""
    sj_scene, sj_cam, sj_st = workload.limit_cases(sj_api, SIZE)[name]
    scene, cam, st = CASES[name]
    with jax.disable_jit():
        ref = sj_api.render(sj_scene, sj_cam, sj_st.with_(backend="jnp"))
    got = api.render(scene, cam, st, device="cpu")
    assert gaps(ref, got)["bitwise"]
    assert int((got.obj_id == 0).sum()) > 10
