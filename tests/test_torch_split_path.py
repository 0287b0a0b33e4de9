"""The port's split path (kernels/render_tile.py): the plain versions of
K1 (render_tile), K2 (trace_rays) and ao_fix against surfjax's kernels in
interpret mode, the whole split slice against surfjax's pallas render, and
the drivers and wrappers on their own.

The kernel-level tolerances are surfjax's own between its kernel and twin
(tests/test_kernels.py): t within 1e-5, AO within 1e-2, normals below
5e-2 with at most 8 lanes per 4096 above 1e-3; hits and object ids equal.
Visibility has no bound in surfjax's tests: the measured gap (XLA:CPU's
fused arithmetic in the penumbra march) is stated with each test. The
slice is held to the bounds of tests/test_mesh.py (hits agree on more than
99.9% of pixels, rgb and normals within 1e-3).
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import surfjax.api as sj_api  # noqa: E402
from surfjax.kernels import render_tile as sj_rt  # noqa: E402

import surfjax_torch.api as pt_api  # noqa: E402
from surfjax_torch.core.camera import camera_ray_dirs_dyn  # noqa: E402
from surfjax_torch.core.scene_compile import from_reference  # noqa: E402
from surfjax_torch.kernels import mesh_tile as pt_mt  # noqa: E402
from surfjax_torch.kernels import render_tile as pt_rt  # noqa: E402
from surfjax_torch.tools.workload import mesh_soft_ao_scene  # noqa: E402

from tests.test_torch_pipeline import gaps, load_pair  # noqa: E402

F32 = np.float32


def _soft_scene(size=32, **over):
    """The mesh + SDF sphere + plane scene (AO, soft shadows) for both
    packages, tile_rows 8 -> (surfjax static, params, settings), (port
    SceneTensors, settings), camera."""
    sj_scene, cam, sj_st = mesh_soft_ao_scene(sj_api, size)
    static, params = sj_scene.freeze()
    sj_st = sj_st.with_(tile_rows=8, **over)
    pt_st = pt_api.RenderSettings(**dataclasses.asdict(sj_st))
    pstatic, pparams = from_reference(static, params, device="cpu")
    return ((static, params, sj_st),
            (pt_rt.SceneTensors(pstatic, pparams), pt_st), cam)


def _camera_rays(cam):
    """The camera's rays as (rows, 128) numpy float32 components."""
    intr = cam.intrinsics
    rows = np.repeat(np.arange(intr.height, dtype=F32), intr.width)
    cols = np.tile(np.arange(intr.width, dtype=F32), intr.height)
    R = torch.from_numpy(np.asarray(cam.rotation, F32).reshape(9))
    d = camera_ray_dirs_dyn(intr, R, torch.from_numpy(rows),
                            torch.from_numpy(cols))
    o = [np.full(rows.shape, F32(c)) for c in cam.position]
    return [c.reshape(-1, 128) for c in o], \
        [c.numpy().reshape(-1, 128) for c in d]


def _k1_both(ref, port, o, d):
    static, params, sj_st = ref
    scene_t, pt_st = port
    got = pt_rt.render_tile_reference(
        scene_t, pt_st, tuple(torch.from_numpy(c) for c in o),
        tuple(torch.from_numpy(c) for c in d))
    t, obj, n, ao, hit, unres = sj_rt.render_tile_kernel(
        static, sj_st, 0, jnp.asarray(params["leaf_params"]),
        jnp.asarray(params["node_params"]),
        tuple(jnp.asarray(c) for c in o), tuple(jnp.asarray(c) for c in d))
    return [a.numpy() for a in got], \
        [np.asarray(a) for a in (t, obj, n[0], n[1], n[2], ao, hit, unres)]


def test_plain_k1_matches_reference_kernel():
    ref, port, cam = _soft_scene()
    o, d = _camera_rays(cam)
    (t, obj, nx, ny, nz, ao, hit, unres), (t_r, obj_r, nx_r, ny_r, nz_r,
                                           ao_r, hit_r, unres_r) = \
        _k1_both(ref, port, o, d)
    np.testing.assert_array_equal(hit, hit_r)
    np.testing.assert_array_equal(unres, unres_r)
    np.testing.assert_array_equal(obj, obj_r)
    h = hit > 0.5
    np.testing.assert_allclose(t[h], t_r[h], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ao, ao_r, rtol=0, atol=1e-2)
    for a, b in ((nx, nx_r), (ny, ny_r), (nz, nz_r)):
        dn = np.abs(a - b)
        assert dn.max() < 5e-2 and (dn > 1e-3).sum() <= 8, dn.max()
    assert 0.3 < h.mean() < 1.0 and (ao < 0.999).any()


def _receivers(port, o, d):
    """Offset receivers, light directions, distances and sharpness of the
    scene's point light from the port's K1 hits, as numpy arrays."""
    scene_t, pt_st = port
    t, obj, nx, ny, nz, ao, hit, _ = pt_rt.render_tile_reference(
        scene_t, pt_st, tuple(torch.from_numpy(c) for c in o),
        tuple(torch.from_numpy(c) for c in d))
    ts = torch.where(hit > 0.5, t, 0.0)
    p_off = pt_rt._offset(tuple(torch.from_numpy(c) for c in o),
                          tuple(torch.from_numpy(c) for c in d), ts,
                          (nx, ny, nz), pt_st)
    light = scene_t.params["lights"][0]
    lv = [light[k] - p_off[k] for k in range(3)]
    dist = torch.sqrt((lv[0] * lv[0] + lv[1] * lv[1]) + lv[2] * lv[2])
    l = [c / dist for c in lv]
    dist_eff = torch.where(hit > 0.5, dist, 0.0)
    soft_k = torch.full_like(dist, F32(pt_st.soft_shadow_k))
    return ([c.numpy() for c in p_off], [c.numpy() for c in l],
            dist_eff.numpy(), soft_k.numpy(), [c.numpy() for c in
                                               (nx, ny, nz)],
            ao.numpy(), hit.numpy())


@pytest.mark.parametrize("soft", [True, False])
def test_plain_k2_matches_reference_kernel(soft):
    """Visibility of the point light from the scene's hits, the same
    receivers for both. Hard shadows agree exactly; soft penumbrae within
    1e-5."""
    ref, port, cam = _soft_scene(soft_shadows=soft)
    o, d = _camera_rays(cam)
    p_off, l, dist, soft_k, _, _, hit = _receivers(port, o, d)
    scene_t, pt_st = port
    got, unres = pt_rt.trace_rays_reference(
        scene_t, pt_st, tuple(torch.from_numpy(c) for c in p_off),
        tuple(torch.from_numpy(c) for c in l), torch.from_numpy(dist),
        torch.from_numpy(soft_k))
    got = got.numpy()
    static, params, sj_st = ref
    vis_r, unres_r = sj_rt.trace_rays_kernel(
        static, sj_st, 0, jnp.asarray(params["leaf_params"]),
        jnp.asarray(params["node_params"]),
        tuple(jnp.asarray(c) for c in p_off),
        tuple(jnp.asarray(c) for c in l), jnp.asarray(dist),
        jnp.asarray(soft_k))
    np.testing.assert_allclose(got, np.asarray(vis_r), rtol=0,
                               atol=1e-5 if soft else 0.0)
    np.testing.assert_array_equal(unres.numpy(), np.asarray(unres_r))
    assert (got < 0.5).any() and (got[hit > 0.5] > 0.5).any()


def test_plain_ao_fix_matches_reference_kernel():
    """AO again at pre-offset receivers on the `need` lanes (a numpy
    random half of the hits), ao_in elsewhere."""
    ref, port, cam = _soft_scene()
    o, d = _camera_rays(cam)
    p_off, _, _, _, n, _, hit = _receivers(port, o, d)
    rng = np.random.default_rng(11)
    need = ((rng.uniform(size=hit.shape) < 0.5) & (hit > 0.5)).astype(F32)
    ao_in = rng.uniform(size=hit.shape).astype(F32)
    scene_t, pt_st = port
    got = pt_rt.ao_fix_reference(
        scene_t, pt_st, tuple(torch.from_numpy(c) for c in p_off),
        tuple(torch.from_numpy(c) for c in n), torch.from_numpy(need),
        torch.from_numpy(ao_in)).numpy()
    static, params, sj_st = ref
    ao_r = np.asarray(sj_rt.ao_fix_kernel(
        static, sj_st, jnp.asarray(params["leaf_params"]),
        jnp.asarray(params["node_params"]),
        tuple(jnp.asarray(c) for c in p_off),
        tuple(jnp.asarray(c) for c in n), jnp.asarray(need),
        jnp.asarray(ao_in)))
    np.testing.assert_allclose(got, ao_r, rtol=0, atol=1e-2)
    np.testing.assert_array_equal(got[need < 0.5], ao_in[need < 0.5])
    assert (got[need > 0.5] != ao_in[need > 0.5]).any()


def test_split_slice_matches_reference_pallas():
    """The whole split slice (render with backend="pallas" on the CPU)
    against surfjax's pallas render on the AO + soft-shadow mesh scene at
    64x64, tile_rows 8. Measured: hits and obj_id equal, rgb within
    3.3e-5, normals within 7.1e-5. (At 32x32 three pixels on a penumbra
    edge differ by up to 1.01e-3 in rgb: surfjax's jitted ray directions
    differ in the last bits (XLA:CPU's approximate rsqrt), which moves
    the hit point; ROADMAP queue 3.)"""
    sj_scene, sj_cam, sj_st = mesh_soft_ao_scene(sj_api, 64)
    pt_scene, pt_cam, pt_st = mesh_soft_ao_scene(pt_api, 64)
    ref = sj_api.render(sj_scene, sj_cam, sj_st.with_(tile_rows=8))
    got = pt_api.render(pt_scene, pt_cam, pt_st.with_(tile_rows=8),
                        device="cpu")
    g = gaps(ref, got)
    assert g["hit_agree"] > 0.999 and g["obj_agree"] > 0.999, g
    assert g["rgb_max"] < 1e-3 and g["normal_max"] < 1e-3, g
    mesh_px = got.obj_id.numpy() == 0
    assert mesh_px.any() and (got.obj_id.numpy() == 1).any()


def test_sequence_frame_equals_render():
    """Mesh scenes render frame by frame through the split path: each
    frame of a render_sequence equals render() of its camera, bitwise."""
    (_, _, _), (scene, cam, st), (Rs, ps) = load_pair(
        "c4_mesh", 24, n_frames=2, backend="pallas", tile_rows=8)
    seq = pt_api.render_sequence(scene, cam, (Rs, ps), st, device="cpu")
    for f in range(2):
        single = pt_api.render(scene, dataclasses.replace(
            cam, position=tuple(float(x) for x in ps[f])), st, device="cpu")
        for a, b in zip(single, seq):
            assert torch.equal(a, b[f])
    assert float(seq.hit.mean()) > 0.3


def test_flat_rays_equal_tiled_frame():
    """render_rays_pallas on the frame's rays in row-major order (other
    tiles, other candidate sets) gives the tiled frame's result bitwise:
    the candidate sets are conservative and a lane's result depends only
    on its own ray."""
    (_, _, _), (scene, cam, st), (Rs, ps) = load_pair(
        "c4_mesh", 24, n_frames=1, backend="pallas", tile_rows=8)
    static, params = scene.freeze()
    params = {k: torch.as_tensor(v) for k, v in params.items()}
    frame = pt_api.render(scene, cam, st, device="cpu")
    intr = cam.intrinsics
    rows = torch.arange(intr.height, dtype=torch.float32)
    cols = torch.arange(intr.width, dtype=torch.float32)
    rr, cc = torch.meshgrid(rows, cols, indexing="ij")
    R = torch.from_numpy(np.asarray(cam.rotation, F32).reshape(9))
    d = camera_ray_dirs_dyn(intr, R, rr.reshape(-1), cc.reshape(-1))
    o = tuple(torch.full_like(d[0], F32(c)) for c in cam.position)
    flat = pt_rt.render_rays_pallas(static, st, params, o, d)
    for a, b in zip(flat, frame):
        assert torch.equal(a, b.reshape(a.shape))


def test_render_runs_on_the_card_by_default():
    """render() and render_sequence() with no device run on the CUDA
    device; without one they raise instead of rendering on the CPU."""
    scene, cam, st = mesh_soft_ao_scene(pt_api, 8)
    R = np.asarray(cam.rotation, F32).reshape(1, 9)
    pos = np.asarray(cam.position, F32).reshape(1, 3)
    if torch.cuda.is_available():
        assert pt_api.render(scene, cam, st).rgb.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt_api.render(scene, cam, st)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt_api.render_sequence(scene, cam, (R, pos), st)


def test_split_wrappers_cpu_runs_plain_and_others_raise():
    """On CPU tensors each wrapper runs its plain version and counts no
    launch; a tensor on another device is refused; settings the split
    path does not take (a negative march cap, tile_rows not a multiple of
    8) raise."""
    _, (scene_t, st), cam = _soft_scene(8)
    o, d = (tuple(torch.from_numpy(c) for c in a) for a in _camera_rays(
        dataclasses.replace(cam, intrinsics=dataclasses.replace(
            cam.intrinsics, width=16))))
    wrappers = (pt_rt.render_tile, pt_rt.trace_rays, pt_rt.ao_fix)
    before = [w.launches for w in wrappers]
    got = pt_rt.render_tile(scene_t, st, o, d)
    ref = pt_rt.render_tile_reference(scene_t, st, o, d)
    # without a cap the wrapper gives no unres, as the kernel writes none
    assert got[7] is None
    assert all(torch.equal(a, b) for a, b in zip(got[:7], ref))
    ones = torch.ones_like(o[0])
    vis, unres = pt_rt.trace_rays(scene_t, st, o, d, ones, ones * 8.0)
    assert unres is None and torch.equal(vis, pt_rt.trace_rays_reference(
        scene_t, st, o, d, ones, ones * 8.0)[0])
    ao = pt_rt.ao_fix(scene_t, st, o, d, ones, ones)
    assert ao.shape == o[0].shape
    assert [w.launches for w in wrappers] == before
    meta = tuple(c.to("meta") for c in o)
    with pytest.raises(ValueError, match="unsupported device"):
        pt_rt.render_tile(scene_t, st, meta, tuple(c.to("meta") for c in d))
    with pytest.raises(ValueError, match="float32"):
        pt_rt.render_tile(scene_t, st, tuple(c.double() for c in o), d)
    for bad in (dict(march_cap=-1), dict(shadow_march_cap=-8),
                dict(tile_rows=12)):
        with pytest.raises(ValueError):
            pt_rt.render_tile(scene_t, st.with_(**bad), o, d)


def test_capture_calls_records_every_split_kernel_call():
    """capture_calls collects each kernel-wrapper call of a frame (CPU
    tensors too) and stops recording when its block ends; each recorded
    call replays through compare (here the plain version on both sides)."""
    from surfjax_torch import kernels
    from surfjax_torch.tools.kernel_check import capture_calls, compare
    scene, cam, st = mesh_soft_ao_scene(pt_api, 16)
    st = st.with_(tile_rows=8)
    with capture_calls() as calls:
        pt_api.render(scene, cam, st, device="cpu")
    assert kernels.RECORDED_CALLS is None
    assert [c[0] for c in calls] == ["render_tile", "mesh_candidates",
                                     "mesh_tile", "ao_fix", "trace_rays",
                                     "mesh_candidates", "mesh_tile"]
    for k, (name, args) in enumerate(calls):
        err, got, ref = compare(name, args, f"call {k}")
        assert err == 0.0 and len(got) == len(ref) > 0
    n = len(calls)
    pt_api.render(scene, cam, st, device="cpu")
    assert len(calls) == n


@pytest.mark.parametrize("cap, iters", [(0, [10, 0]), (4, [4, 0])])
def test_count_ops_counts_bulb_iterations_as_run(cap, iters):
    """While count_ops counts, the plain versions' leaf evaluator counts
    the Mandelbulb orbit updates each lane runs (none for a lane outside
    the bailout radius, every one up to the cap for the bulb's centre)
    and returns the same DE values to the bit; outside it the evaluator
    is the plain one."""
    from surfjax_torch.core.scene_compile import LEAF_MANDELBULB
    st = pt_api.RenderSettings()
    prm = torch.tensor([0.0, 0.0, 0.0, 1.0, 2.0])
    p = (torch.tensor([0.0, 100.0]), torch.zeros(2), torch.zeros(2))
    plain = pt_rt._fast_leaf_fn(st, cap)(LEAF_MANDELBULB, prm, p, 8, 10)
    with pt_rt.count_ops():
        de = pt_rt._fast_leaf_fn(st, cap)(LEAF_MANDELBULB, prm, p, 8, 10)
        counted = pt_rt._OPS["bulb"]
    assert torch.equal(de, plain)
    assert counted.tolist() == iters
    assert set(pt_rt._OPS.values()) == {None}


def test_huge_meshes_route_to_the_grid_dda(monkeypatch):
    """Above MAX_PACKET_TRIS a mesh goes through the grid DDA with a
    warning, as in surfjax; the frame agrees with the packet path."""
    scene, cam, st = mesh_soft_ao_scene(pt_api, 24)
    st = st.with_(tile_rows=8)
    packet = pt_api.render(scene, cam, st, device="cpu")
    monkeypatch.setattr(pt_mt, "MAX_PACKET_TRIS", 4)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        dda = pt_api.render(scene, cam, st, device="cpu")
    assert any("grid-DDA" in str(w.message) for w in caught)
    g = gaps(packet, dda)
    assert g["hit_agree"] > 0.999 and g["rgb_max"] < 1e-3, g


def test_split_slice_at_32_matches_reference_op_by_op():
    """The AO + soft-shadow mesh scene at 32x32 (ROADMAP queue 3 item 3):
    against surfjax under jit three pixels on a penumbra edge differ by up
    to 1.01e-3 in rgb (one above 1e-3); with jit disabled surfjax agrees
    with the port within 3.3e-5 everywhere, so the gap is XLA:CPU's
    rounding of the jitted program. Measured: 1.0126e-3 (jit), 3.25e-5 (op
    by op); hits and obj_id equal in both."""
    import jax
    sj_scene, sj_cam, sj_st = mesh_soft_ao_scene(sj_api, 32)
    pt_scene, pt_cam, pt_st = mesh_soft_ao_scene(pt_api, 32)
    got = pt_api.render(pt_scene, pt_cam, pt_st.with_(tile_rows=8),
                        device="cpu")
    jit_ref = sj_api.render(sj_scene, sj_cam, sj_st.with_(tile_rows=8))
    with jax.disable_jit():
        op_ref = sj_api.render(sj_scene, sj_cam, sj_st.with_(tile_rows=8))
    g_jit, g_op = gaps(jit_ref, got), gaps(op_ref, got)
    for g in (g_jit, g_op):
        assert g["hit_agree"] == 1.0 and g["obj_agree"] == 1.0, g
    assert g_jit["rgb_max"] < 1.1e-3 and g_jit["lanes_rgb_gt_1e-3"] <= 1, \
        g_jit
    assert g_op["rgb_max"] < 1e-4 and g_op["normal_max"] < 1e-4, g_op
