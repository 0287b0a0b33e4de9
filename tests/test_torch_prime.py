"""Cone-march priming in the port, on the CPU (the wrapper runs the plain
version): `prime_tile_reference` against surfjax's `prime_tile_kernel` in
interpret mode, the primed frame against the unprimed one, and the frame
functions' routing and gate.

The scene is that of surfjax's tests/test_kernels.py
::test_cone_prime_conservative (config 3 of tests/scenes.py: smooth-union
blob, Mandelbulb, analytic floor) at 96x96 with prime_min 64, built for
either package.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import surfjax.api as sj_api  # noqa: E402
from surfjax.kernels import render_tile as sj_rt  # noqa: E402

import surfjax_torch.api as pt_api  # noqa: E402
from surfjax_torch.kernels import render_tile as pt_rt  # noqa: E402
from surfjax_torch.tools import workload  # noqa: E402
from surfjax_torch.tools.kernel_check import capture_calls  # noqa: E402

SIZE = 96


def _config3(api, size=SIZE, **over):
    """tests/scenes.py::config3_sdf built with either package's api ->
    (scene, camera, settings) with the pallas backend, tile_rows 8 and
    priming on from 64 pixels a side."""
    scene = api.Scene()
    blob = api.smooth_union(
        api.Sphere(center=(-0.9, -0.35, 3.2), radius=0.55),
        api.smooth_union(api.Sphere(center=(-0.35, 0.25, 3.1), radius=0.4),
                         api.Box(center=(-0.7, -0.05, 3.4),
                                 half_extents=(0.45, 0.3, 0.3)), 0.25), 0.3)
    scene.add(blob, api.Material.blinn_phong(albedo=(0.3, 0.7, 0.5),
                                             shininess=32), engine="sdf")
    scene.add(api.Mandelbulb(center=(1.0, 0.0, 3.0), scale=0.9),
              api.Material.lambert(albedo=(0.85, 0.6, 0.3)))
    scene.add(api.Plane(normal=(0.0, 1.0, 0.0), offset=-1.0),
              api.Material.lambert(albedo=(0.5, 0.5, 0.55)))
    scene.add_light(api.PointLight(position=(3.0, 4.0, -1.0),
                                   color=(1.0, 0.98, 0.95)))
    cam = api.Camera.pinhole(size, size, fov_y_deg=45.0,
                             position=(0.0, 0.4, 0.0),
                             target=(0.0, 0.0, 3.0))
    st = api.RenderSettings(shadows=True, soft_shadows=True, ao=True,
                            ao_samples=5, backend="pallas", tile_rows=8,
                            prime=True, prime_min=64, **over)
    return scene, cam, st


@pytest.fixture(scope="module")
def primed_and_unprimed():
    scene, cam, st = _config3(pt_api)
    with capture_calls() as calls:
        primed = pt_api.render(scene, cam, st, device="cpu")
    unprimed = pt_api.render(scene, cam, st.with_(prime=False), device="cpu")
    return scene, cam, st, calls, primed, unprimed


def test_prime_reference_matches_reference_kernel(primed_and_unprimed):
    """The coarse rays `prime_frame` makes, through the port's plain
    version and through surfjax's kernel (padded to its 16-row blocks by
    repeating the last ray): t0 within 1e-5 relative (measured 3.7e-7, 85%
    of the rays equal to the bit: XLA:CPU's fused arithmetic in the DE)."""
    _, _, _, calls, _, _ = primed_and_unprimed
    assert [c[0] for c in calls] == ["prime_tile"]
    scene_t, st, k_m, o, d = calls[0][1]
    assert o[0].shape == (SIZE // 4, SIZE // 4)
    got = pt_rt.prime_tile_reference(scene_t, st, k_m, o, d).numpy()
    n = got.size
    block = 16 * 128
    n_pad = -(-n // block) * block

    def padded(c):
        flat = c.numpy().reshape(-1)
        return jnp.asarray(np.concatenate(
            [flat, np.repeat(flat[-1:], n_pad - n)]).reshape(-1, 128))

    sj_scene, _, sj_st = _config3(sj_api)
    static, params = sj_scene.freeze()
    ref = sj_rt.prime_tile_kernel(
        static, sj_st, float(k_m), 16, jnp.asarray(params["leaf_params"]),
        jnp.asarray(params["node_params"]),
        tuple(padded(c) for c in o), tuple(padded(c) for c in d))
    ref = np.asarray(ref).reshape(-1)[:n].reshape(got.shape)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
    # some rays are blocked near the camera side of the objects, some
    # run clear to t_max
    assert got.min() < 3.0 and got.max() == np.float32(st.t_max)


def test_primed_start_never_passes_the_unprimed_hit(primed_and_unprimed):
    """t0 is a safe start: on every pixel whose unprimed ray hits an SDF
    object it lies before that hit."""
    scene, cam, st, _, _, unprimed = primed_and_unprimed
    static, params = scene.freeze()
    params = {k: torch.as_tensor(v) for k, v in params.items()}
    R = torch.as_tensor(np.asarray(cam.rotation, np.float32).reshape(9))
    pos = torch.as_tensor(np.asarray(cam.position, np.float32))
    t0 = pt_rt.prime_frame(static, cam.intrinsics, st, params, R, pos)
    assert t0.shape == (SIZE, SIZE)
    sdf_hit = (unprimed.hit > 0.5) & (unprimed.obj_id < 2)
    assert int(sdf_hit.sum()) > 1000
    assert bool((t0[sdf_hit] <= unprimed.depth[sdf_hit]).all())
    # and it is worth something: most such starts are beyond half way
    assert float((t0[sdf_hit] > 0.5 * unprimed.depth[sdf_hit]).float()
                 .mean()) > 0.9


def test_cone_prime_conservative(primed_and_unprimed):
    """The port's counterpart of surfjax's test of the same name: priming
    never tunnels. Hit masks equal the unprimed render's; hit positions
    move inside the hit-epsilon band, so rgb is held on the bulk only:
    mean |difference| < 5e-3 (measured 2.1e-3), q99 < 0.1 (measured
    4.4e-2)."""
    _, _, _, _, primed, unprimed = primed_and_unprimed
    assert torch.equal(primed.hit, unprimed.hit)
    assert 0.2 < float(primed.hit.mean()) < 1.0
    d = (primed.rgb - unprimed.rgb).abs()
    assert float(d.mean()) < 5e-3
    assert float(torch.quantile(d.flatten(), 0.99)) < 0.1
    assert torch.equal(primed.obj_id, unprimed.obj_id)


def test_primed_frame_matches_reference_primed_frame(primed_and_unprimed):
    """The primed frame of the port against surfjax's primed frame: hits
    agree on more than 99.5% of the pixels and the rgb difference has q99
    below 5e-2 (the Mandelbulb carve-out of the c3 comparisons; measured
    100% and 3.1e-5, rgb 2.5e-2 at most, four lanes above 1e-3)."""
    from tests.test_torch_pipeline import gaps
    _, _, _, _, primed, _ = primed_and_unprimed
    sj_scene, sj_cam, sj_st = _config3(sj_api)
    ref = sj_api.render(sj_scene, sj_cam, sj_st)
    g = gaps(ref, primed)
    assert g["hit_agree"] > 0.995 and g["rgb_q99"] < 5e-2, g


def test_prime_gate_and_sequence_routing():
    """Priming runs only with settings.prime, an SDF object, a frame of at
    least prime_min pixels a side and no crowd; a primed sequence takes
    one priming pass over all its frames and equals render()."""
    scene, cam, st = _config3(pt_api, size=64)
    static, params = scene.freeze()
    params = {k: torch.as_tensor(v) for k, v in params.items()}
    R = torch.as_tensor(np.asarray(cam.rotation, np.float32).reshape(9))
    pos = torch.as_tensor(np.asarray(cam.position, np.float32))

    def gate(static, st):
        return pt_rt.prime_frame(static, cam.intrinsics, st, params, R, pos)

    assert gate(static, st) is not None
    assert gate(static, st.with_(prime=False)) is None
    assert gate(static, st.with_(prime_min=65)) is None
    c_scene, _, c_st = workload.crowd_cases(pt_api)["crowd soft"]
    c_static, c_params = c_scene.freeze()
    c_on = c_st.with_(prime=True, prime_min=8, vector_objects=True)
    assert pt_rt.prime_frame(
        c_static, cam.intrinsics, c_on,
        {k: torch.as_tensor(v) for k, v in c_params.items()}, R, pos) is None
    with pytest.raises(ValueError, match="does not take a crowd"):
        ones = torch.ones(4)
        pt_rt.prime_tile(pt_rt.SceneTensors(c_static, c_params), c_on, 0.01,
                         (ones,) * 3, (ones,) * 3)

    Rs, ps = workload.poses(cam, 2, np.random.default_rng(5).normal(
        0.0, 0.02, (2, 3)))
    before = pt_rt.prime_tile.launches
    with capture_calls() as calls:
        seq = pt_api.render_sequence(scene, cam, (Rs, ps), st, device="cpu")
    assert [c[0] for c in calls] == ["prime_tile"]
    assert pt_rt.prime_tile.launches == before     # CPU: the plain version
    single = pt_api.render(scene, dataclasses.replace(
        cam, position=tuple(float(x) for x in ps[1])), st, device="cpu")
    for a, b in zip(single, seq):
        assert torch.equal(a, b[1])


def test_primed_split_path_hands_t0_to_k1():
    """A mesh beside an SDF sphere takes the split path: the priming pass
    runs first and K1 receives its t0 in the tiled layout; the hit mask
    equals the unprimed frame's."""
    scene, cam, st = workload.mesh_soft_ao_scene(pt_api, 32)
    st = st.with_(tile_rows=8, prime=True, prime_min=32)
    with capture_calls() as calls:
        primed = pt_api.render(scene, cam, st, device="cpu")
    names = [c[0] for c in calls]
    assert names[:2] == ["prime_tile", "render_tile"]
    k1_args = calls[1][1]
    assert len(k1_args) == 5 and k1_args[4].shape == k1_args[2][0].shape
    t0 = k1_args[4]
    assert float(t0.min()) >= st.t_min and float(t0.max()) > 1.0
    unprimed = pt_api.render(scene, cam, st.with_(prime=False), device="cpu")
    assert torch.equal(primed.hit, unprimed.hit)
    assert torch.equal(primed.obj_id, unprimed.obj_id)
    assert float((primed.rgb - unprimed.rgb).abs().mean()) < 5e-3


def test_prime_wrapper_and_operation_count():
    """On CPU tensors the wrapper is the plain version; another device is
    refused; count_ops counts the cone march's DE evaluations."""
    scene, cam, st = _config3(pt_api, size=64)
    with capture_calls() as calls:
        pt_api.render(scene, cam, st, device="cpu")
    scene_t, st, k_m, o, d = calls[0][1]
    intr = cam.intrinsics
    assert k_m == pytest.approx(2 * 1.5 * np.sqrt(2.0) / min(intr.fx,
                                                             intr.fy))
    got = pt_rt.prime_tile(scene_t, st, k_m, o, d)
    assert torch.equal(got, pt_rt.prime_tile_reference(scene_t, st, k_m, o,
                                                       d))
    with pytest.raises(ValueError, match="unsupported device"):
        pt_rt.prime_tile(scene_t, st, k_m, tuple(c.to("meta") for c in o),
                         tuple(c.to("meta") for c in d))
    with pt_rt.count_ops() as counted:
        pt_rt.prime_tile_reference(scene_t, st, k_m, o, d)
    assert counted["ops"] > 100 * o[0].numel()
    # the proxy scene lower-bounds the true scene SDF
    proxy, sdf = pt_rt._prime_fns(scene_t, st)
    p = tuple(torch.as_tensor(np.random.default_rng(1).uniform(
        -3.0, 5.0, 512).astype(np.float32)) for _ in range(3))
    assert bool((proxy(p) <= sdf(p) + 1e-6).all())


def test_c3_yaml_primed_hit_change_is_the_references_too():
    """configs/c3_sdf.yaml at 96x96, prime_min 64 (ROADMAP queue 3 item 4):
    priming changes the hit flag of one pixel, (11, 23), in the port, and
    surfjax's primed frame changes the same pixel (jit or op by op): the
    port's primed and unprimed hit masks each equal surfjax's. The change
    is the algorithm's (a grazing ray inside the hit-epsilon band marched
    from another start), not the port's."""
    import os

    import surfjax.config as sj_config
    from surfjax_torch.config import load_config
    cfg = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "c3_sdf.yaml")
    masks = {}
    for name, api, load, kw in (("port", pt_api, load_config,
                                 {"device": "cpu"}),
                                ("surfjax", sj_api, sj_config.load_config,
                                 {})):
        scene, cam, st, _ = load(cfg)
        cam = workload.reframe(cam, SIZE, SIZE)
        st = st.with_(backend="pallas", prime=True, prime_min=64)
        masks[name] = [np.asarray(api.render(scene, cam, s, **kw).hit)
                       for s in (st, st.with_(prime=False))]
    for k in range(2):
        assert np.array_equal(masks["port"][k], masks["surfjax"][k])
    for name in masks:
        primed, unprimed = masks[name]
        assert np.argwhere(primed != unprimed).tolist() == [[11, 23]]
