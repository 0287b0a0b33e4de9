"""The capped-march residual of the port's split path (settings.march_cap,
shadow_march_cap; surfjax's _block_residual): K1 and K2 run with their
step budgets at the cap, report the lanes the cap cut off (unres), and the
128-ray rows holding such a lane run again at the full budget over the
capped outputs (render_tile_redo, trace_rays_redo).

  * capped plus residual equals uncapped, bitwise, through the plain
    versions: c3 at 64x64 with soft shadows and AO at caps (24, 12) and
    (2, 2) (surfjax's own case, tests/test_kernels.py), a crowd scene,
    workload.mesh_soft_ao_scene, primed frames, and the hybrid forward's
    loss and pose gradient on c5;
  * the plain K1's and K2's t, vis and unres against surfjax's trace_core
    and visibility_core at the same caps, op by op (jax.disable_jit);
  * the capped port against surfjax's capped render (interpret mode);
  * csrc/split_staged.cu built for the CPU (tests/cuda_host.py) through
    the port's launcher: the capped and the residual launches bitwise the
    plain versions', on a ragged ray count.
"""

import contextlib
import ctypes
import dataclasses
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import surfjax.api as sj_api  # noqa: E402
from surfjax.kernels import render_tile as sj_rt  # noqa: E402

import surfjax_torch.api as pt_api  # noqa: E402
from surfjax_torch.config import load_config  # noqa: E402
from surfjax_torch.core.camera import flat_camera_rays  # noqa: E402
from surfjax_torch.core.scene_compile import (  # noqa: E402
    from_reference, params_to_device,
)
from surfjax_torch.diff import fit as pt_fit  # noqa: E402
from surfjax_torch.io.image import ulp_diff_f32  # noqa: E402
from surfjax_torch.kernels import _build  # noqa: E402
from surfjax_torch.kernels import render_tile as rt  # noqa: E402
from surfjax_torch.tools import workload  # noqa: E402
from surfjax_torch.tools.kernel_check import (  # noqa: E402
    capture_calls, compare,
)

from tests import cuda_host  # noqa: E402
from tests.test_torch_pipeline import gaps, load_pair  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPS = [(24, 12), (2, 2)]


def _config(name, size, **over):
    scene, cam, st, _ = load_config(os.path.join(ROOT, "configs",
                                                 name + ".yaml"))
    return scene, workload.reframe(cam, *size), st.with_(**over)


def _flat_rays(scene, cam):
    static, params = scene.freeze()
    R = torch.as_tensor(np.asarray(cam.rotation, np.float32).reshape(9))
    pos = torch.as_tensor(np.asarray(cam.position, np.float32))
    o, d, _ = flat_camera_rays(cam.intrinsics, R, pos)
    return static, params_to_device(params, "cpu"), o, d


def _capped_equals_uncapped(render, st, caps):
    """render(settings) -> FrameBuffers; capped and uncapped bitwise, and
    the residual re-ran some rows -> (the share of the rows each residual
    call re-ran by wrapper name, the capped render's kernel calls)."""
    ref = render(st)
    with capture_calls() as calls:
        got = render(st.with_(march_cap=caps[0], shadow_march_cap=caps[1]))
    for name, a, b in zip(ref._fields, got, ref):
        assert torch.equal(a, b), name
    shares = {}
    for name, args in calls:
        if name.endswith("_redo"):
            shares.setdefault(name, []).append(float(args[3].mean()))
    assert shares.get("render_tile_redo") or shares.get("trace_rays_redo")
    return shares, calls


@pytest.mark.parametrize("caps", CAPS)
def test_c3_capped_equals_uncapped(caps):
    """surfjax's own case: c3 at 64x64, tile_rows 8, soft shadows and AO,
    through render_rays_pallas on the camera's flat rays. Both caps make
    the residual re-run rows of K1 and of K2, and (2, 2) nearly all."""
    scene, cam, st = _config("c3_sdf", (64, 64), backend="pallas",
                             tile_rows=8, soft_shadows=True, ao=True)
    static, params, o, d = _flat_rays(scene, cam)
    shares, _ = _capped_equals_uncapped(
        lambda s: rt.render_rays_pallas(static, s, params, o, d), st, caps)
    assert shares["render_tile_redo"][0] > 0.0
    assert shares["trace_rays_redo"][0] > 0.0
    if caps == (2, 2):
        assert shares["render_tile_redo"][0] > 0.9


@pytest.mark.parametrize("soft", [False, True])
def test_crowd_capped_equals_uncapped(soft):
    """A crowd of SDF and analytic members (vector_objects) over a floor:
    the uncapped frame takes the fused path, the capped one the split
    path's crowd loops and the residual; the frames are equal."""
    scene, cam, st = workload.crowd_scene(pt_api, n_sdf_spheres=3,
                                          size=(32, 24), shadows=True,
                                          soft_shadows=soft)
    st = st.with_(backend="pallas", tile_rows=8, vector_objects=True)
    assert rt.split_crowd(scene.freeze()[0], st)[0] is not None
    _capped_equals_uncapped(
        lambda s: pt_api.render(scene, cam, s, device="cpu"), st, (2, 2))


@pytest.mark.parametrize("caps", CAPS)
def test_mesh_scene_capped_equals_uncapped(caps):
    """workload.mesh_soft_ao_scene (a mesh beside an SDF sphere over an
    analytic floor, AO and soft shadows): the mesh merge and ao_fix run
    on the residual's outputs as on the uncapped ones."""
    scene, cam, st = workload.mesh_soft_ao_scene(pt_api, 32)
    _capped_equals_uncapped(
        lambda s: pt_api.render(scene, cam, s, device="cpu"),
        st.with_(tile_rows=8), caps)


@pytest.mark.parametrize("name", ["c3", "mesh_soft_ao"])
def test_primed_capped_equals_uncapped(name):
    """Primed frames: the capped launch and the residual take the same
    t0; c3 uncapped takes the fused path with it."""
    if name == "c3":
        scene, cam, st = _config("c3_sdf", (64, 64), backend="pallas",
                                 tile_rows=8)
    else:
        scene, cam, st = workload.mesh_soft_ao_scene(pt_api, 32)
    st = st.with_(tile_rows=8, prime=True, prime_min=32)
    _, calls = _capped_equals_uncapped(
        lambda s: pt_api.render(scene, cam, s, device="cpu"), st, (8, 8))
    assert [n for n, _ in calls].count("prime_tile") == 1
    k1 = [a for n, a in calls if n == "render_tile_redo"]
    assert len(k1) == 1 and len(k1[0]) == 7    # t0 passed to the re-run


def test_hybrid_capped_equals_uncapped():
    """The hybrid forward (the fit's) on c5 at 48x48 with caps: the same
    loss and pose gradient to the bit."""
    scene, cam, st = _config("c5_anim", (48, 48), backend="pallas",
                             tile_rows=8)
    ref = pt_fit.pose_loss_and_grad(scene, cam, st, device="cpu")
    with capture_calls() as calls:
        got = pt_fit.pose_loss_and_grad(
            scene, cam, st.with_(march_cap=4, shadow_march_cap=4),
            device="cpu")
    assert got[0] == ref[0]
    for k in ("w", "dt"):
        np.testing.assert_array_equal(got[1][k], ref[1][k])
    names = [n for n, _ in calls]
    assert names.count("render_tile_redo") == 1
    assert names.count("trace_rays_redo") == len(scene.lights)


def _sj_port_c3(size, **over):
    """c3 with the portable log (bitwise the same DE in both packages)
    for surfjax and the port, and the camera's flat rays as numpy."""
    (sj_scene, sj_cam, sj_st), _, _ = load_pair("c3_sdf_portlog", size,
                                                n_frames=1, **over)
    static, params = sj_scene.freeze()
    pstatic, pparams = from_reference(static, params, device="cpu")
    intr = sj_cam.intrinsics
    R = torch.as_tensor(np.asarray(sj_cam.rotation, np.float32).reshape(9))
    pos = torch.as_tensor(np.asarray(sj_cam.position, np.float32))
    o, d, _ = flat_camera_rays(intr, R, pos)
    o = [c.numpy() for c in o]
    d = [c.numpy() for c in d]
    pt_st = pt_api.RenderSettings(**dataclasses.asdict(sj_st))
    return (static, params, sj_st), (pstatic, pparams, pt_st), o, d


@pytest.fixture(scope="module")
def c3_traced():
    """c3 (portable log) at 24x24 for both packages and the port's plain
    trace at march_cap 24."""
    ref, port, o, d = _sj_port_c3(24, max_steps=96)
    pstatic, pparams, pt_st = port
    ot = tuple(torch.from_numpy(c) for c in o)
    dt = tuple(torch.from_numpy(c) for c in d)
    traced = rt.trace_core(pstatic, pt_st, pparams["leaf_params"],
                           pparams["node_params"], ot, dt, march_cap=24)
    return ref, port, o, d, traced


@pytest.fixture(scope="module")
def c3_reference_traces(c3_traced):
    """surfjax's trace_core at march_cap 24 on c3_traced's rays, op by op
    (jax.disable_jit) and jitted -> (op by op, jitted), each (t, obj, leaf,
    hit, unres) as numpy."""
    (static, params, sj_st), _, o, d, _ = c3_traced
    args = (jnp.asarray(params["leaf_params"]),
            jnp.asarray(params["node_params"]),
            tuple(jnp.asarray(c) for c in o), tuple(jnp.asarray(c) for c in d))

    def core(*a):
        return sj_rt.trace_core(static, sj_st, *a, sj_st.t_min, sj_st.t_max,
                                march_cap=24)
    with jax.disable_jit():
        op = core(*args)
    jit = jax.jit(core)(*args)
    return (tuple(np.asarray(v) for v in op),
            tuple(np.asarray(v) for v in jit))


# surfjax's own op-by-op and jitted traces part by more than this on a lane
# whose march stopped a step apart inside the hit band
REFERENCE_SPLIT = 1e-3


def test_plain_k1_matches_reference_op_by_op(c3_traced, c3_reference_traces):
    """The plain trace_core at march_cap 24 against surfjax's at the same
    cap: hits, objects and unres equal to surfjax's op by op
    (jax.disable_jit) and jitted. t within 1 ULP of surfjax op by op on
    every lane but those where surfjax's own two paths split by more than
    1e-3: at most one lane (342: port 2.4411104, op by op 2.438904,
    jitted 2.4411106), where the port is within 1 ULP of jitted surfjax.
    Against jitted surfjax t differs on 26 lanes by at most 4.8e-7
    (XLA:CPU's arithmetic; ROADMAP queue 3)."""
    *_, (t, obj, _, hit, unres) = c3_traced
    op, jit = c3_reference_traces
    for a, k in ((hit, 3), (obj, 1), (unres, 4)):
        np.testing.assert_array_equal(a.numpy(), op[k])
        np.testing.assert_array_equal(a.numpy(), jit[k])
    t = t.numpy()
    split = np.abs(op[0] - jit[0]) > REFERENCE_SPLIT
    assert split.sum() <= 1
    assert ulp_diff_f32(t[~split], op[0][~split]).max() <= 1
    assert ulp_diff_f32(t[split], jit[0][split]).max(initial=0) <= 1
    assert np.abs(t - jit[0]).max() < 1e-6
    assert 0.0 < float(unres.mean()) < 0.5


def test_c3_op_by_op_gap_is_the_references_own(c3_reference_traces):
    """The 2.2e-3 gap in t between the port and surfjax op by op on
    c3-portlog at 24x24 (lane 342) is surfjax's own: its op-by-op and
    jitted traces split there by more than 2e-3 (2.438904 against
    2.4411106), a march that stopped a step apart inside the hit band."""
    op, jit = c3_reference_traces
    gap = np.abs(op[0] - jit[0])
    assert np.flatnonzero(gap > REFERENCE_SPLIT).tolist() == [342]
    assert gap[342] > 2e-3


@pytest.mark.parametrize("soft", [True, False])
def test_plain_k2_matches_reference_op_by_op(c3_traced, soft):
    """The plain visibility_core at march_cap 12 against surfjax's at the
    same cap, op by op, from the port's receivers of c3's light: unres
    equal, vis equal (hard) or within 2e-5 (soft: one lane of 576 differs,
    by 1.19e-5, in the penumbra march's arithmetic)."""
    (static, params, sj_st), port, o, d, traced = c3_traced
    pstatic, pparams, pt_st = port
    sj_st, pt_st = (st.with_(soft_shadows=soft) for st in (sj_st, pt_st))
    plp, pnp = pparams["leaf_params"], pparams["node_params"]
    t, obj, leaf, hit, _ = traced
    ot = tuple(torch.from_numpy(c) for c in o)
    dt = tuple(torch.from_numpy(c) for c in d)
    h = hit > 0.5
    t_sane = torch.where(h, t, 0.0)
    p = tuple(ot[k] + t_sane * dt[k] for k in range(3))
    n = rt.normals_core(pstatic, pt_st, plp, pnp, p, obj, leaf, dt)
    p_off = rt._offset(ot, dt, t_sane, n, pt_st)
    l, dist, soft_k = rt._light_ray(pt_st, pstatic.ir.lights[0],
                                    pparams["lights"][0], p_off)
    dist = torch.where(h, dist, 0.0)
    vis, unres = rt.visibility_core(pstatic, pt_st, plp, pnp, p_off, l,
                                    dist, soft_k=soft_k, march_cap=12)
    with jax.disable_jit():
        vis_r, unres_r = sj_rt.visibility_core(
            static, sj_st, jnp.asarray(params["leaf_params"]),
            jnp.asarray(params["node_params"]),
            *(tuple(jnp.asarray(c.numpy()) for c in a) for a in (p_off, l)),
            jnp.asarray(dist.numpy()), soft_k=jnp.asarray(soft_k.numpy()),
            march_cap=12)
    np.testing.assert_array_equal(unres.numpy(), np.asarray(unres_r))
    np.testing.assert_allclose(vis.numpy(), np.asarray(vis_r), rtol=0,
                               atol=2e-5 if soft else 0.0)
    assert float(unres.sum()) > 0.0


def test_capped_slice_matches_reference_pallas():
    """The capped split slice against surfjax's capped pallas render on the
    AO + soft-shadow mesh scene at 64x64 (tile_rows 8, caps 24 / 12), with
    the uncapped slice's bounds (tests/test_torch_split_path.py)."""
    sj_scene, sj_cam, sj_st = workload.mesh_soft_ao_scene(sj_api, 64)
    pt_scene, pt_cam, pt_st = workload.mesh_soft_ao_scene(pt_api, 64)
    caps = dict(tile_rows=8, march_cap=24, shadow_march_cap=12)
    ref = sj_api.render(sj_scene, sj_cam, sj_st.with_(**caps))
    got = pt_api.render(pt_scene, pt_cam, pt_st.with_(**caps),
                        device="cpu")
    g = gaps(ref, got)
    assert g["hit_agree"] > 0.999 and g["obj_agree"] > 0.999, g
    assert g["rgb_max"] < 1e-3 and g["normal_max"] < 1e-3, g


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if cuda_host.gxx() is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    lib = cuda_host.build("split_staged.cu",
                          str(tmp_path_factory.mktemp("caps_host")))
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    lib.sp_staged_render_tile.argtypes = [rt.KFTables, rt.KFSettings,
                                          rt.SplitRays, ptr, i32, ptr]
    lib.sp_staged_trace_rays.argtypes = [rt.KFTables, rt.KFSettings,
                                         rt.KSLayout, rt.SplitRays, ptr, ptr,
                                         i32, ptr]
    k1, k2 = lib.sp_staged_render_tile, lib.sp_staged_trace_rays
    return types.SimpleNamespace(
        sp_staged_render_tile=lambda T, S, R, prof, dev, st: k1(
            T, S, R, prof, 0, st),
        sp_staged_trace_rays=lambda T, S, L, R, prof, work, dev, st: k2(
            T, S, L, R, prof, work, 0, st))


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """The launchers load the host library and launch on a stand-in
    stream."""
    monkeypatch.setattr(_build, "load", lambda: host_lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))


@pytest.mark.parametrize("entry", ["render_tile", "trace_rays"])
def test_host_capped_and_redo_launches_equal_plain(on_host, entry):
    """K1 and K2 of c3 (portable log, soft shadows and AO) at 40x30,
    cut to the frame's rays 300 to 1200 (the last 128-ray row ragged, and
    the only one without a cut-off lane): the capped launch
    (cap 6) equals the plain version at march_cap 6, unres included; the
    residual launch over a copy of its outputs equals the plain residual
    and the uncapped plain version; a row whose flag is 0 is left as the
    capped launch wrote it. Both launches also go through the recorded
    calls' replay (kernel_check.compare)."""
    scene, cam, st = _config("c3_sdf_portlog", (40, 30), backend="pallas",
                             tile_rows=8, max_steps=64, shadow_steps=48)
    static, params, o, d = _flat_rays(scene, cam)
    with capture_calls() as calls:
        rt.render_rays_pallas(static, st.with_(march_cap=6,
                                               shadow_march_cap=6),
                              params, o, d)
    args = next(a for n, a in calls if n == entry)
    scene_t, capped = args[:2]
    n = 900

    def cut(a):
        if isinstance(a, tuple):
            return tuple(cut(c) for c in a)
        return a.reshape(-1)[300:300 + n].contiguous()
    rays = tuple(cut(a) for a in args[2:])
    plain = {"render_tile": rt.render_tile_reference,
             "trace_rays": rt.trace_rays_reference}[entry]
    ref = plain(scene_t, st, *rays, march_cap=6)
    launch, out, _ = rt.staged_split_launcher(entry, scene_t, capped, rays)
    launch()
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    redo = rt.redo_rows(out[-1])
    assert redo.tolist() == [1.0] * 7 + [0.0]
    outs = tuple(c.clone() for c in out)
    launch, got, _ = rt.staged_split_launcher(entry, scene_t, st, rays,
                                              outs=outs, redo=redo)
    launch()
    want = {"render_tile": rt.render_tile_redo_reference,
            "trace_rays": rt.trace_rays_redo_reference}[entry](
        scene_t, st, tuple(c.clone() for c in out), redo, *rays)
    full = plain(scene_t, st, *rays)
    for a, b, c in zip(got, want, full):
        assert torch.equal(a, b) and torch.equal(a, c)
    skipped = (redo < 0.5).repeat_interleave(128)[:n]
    for a, b in zip(got, out):
        assert torch.equal(a[skipped], b[skipped])
    for name, call in calls:
        if name.startswith(entry):
            err, _, _ = compare(name, call, name)
            assert err == 0.0
