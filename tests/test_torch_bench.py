"""surfjax_torch's benchmark harness, workload matrix and quickstart against
the JAX package's `bench.py`, `tools/bench_all.py`, `tools/perf_check.py`,
`tests/scenes.py` and `examples/quickstart.py`, on the CPU at small sizes.

The harnesses time different devices, so what must agree is what they
count: the pinned workload to the bit, the ray accounting, and the counts
and disclosures of a run (which follow from the frames' hits). The
quickstart takes about 30 s on one CPU thread at its own size (its 512x384
frame and 8-frame sequence with AO), so its parts are tested: its scenes
against surfjax's, the frame and sequence at 64x48, the fit in full.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
import surfjax.api as sj_api  # noqa: E402
from surfjax.core.camera import orbit_pose as sj_orbit_pose  # noqa: E402
from surfjax.io.image import ulp_diff_f32  # noqa: E402
from tests import scenes as sj_scenes  # noqa: E402
from tools import bench_all as sj_bench_all  # noqa: E402

import surfjax_torch.__main__ as cli  # noqa: E402
from surfjax_torch import bench as pb, quickstart  # noqa: E402
from surfjax_torch.config import load_config  # noqa: E402
from surfjax_torch.core.scene_compile import from_reference  # noqa: E402
from surfjax_torch.tools import bench_all, scenes  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")


def _same_scene(port_scene, ref_scene):
    """The port's frozen scene equals surfjax's, and so does surfjax's
    carried across by from_reference: SceneIR, mesh statics and every
    table bit for bit."""
    static, params = port_scene.freeze()
    ref_static, ref_params = ref_scene.freeze()
    carried_static, carried = from_reference(ref_static, ref_params,
                                             device="cpu")
    assert static == ref_static and carried_static == ref_static
    assert sorted(params) == sorted(ref_params) == sorted(carried)
    for key, ref in ref_params.items():
        for got in (np.asarray(params[key]), carried[key].numpy()):
            assert got.dtype == ref.dtype and got.shape == ref.shape, key
            assert got.tobytes() == ref.tobytes(), key


def _same_view(cam, ref_cam, st, ref_st):
    assert dataclasses.asdict(cam.intrinsics) == \
        dataclasses.asdict(ref_cam.intrinsics)
    assert tuple(cam.rotation) == tuple(ref_cam.rotation)
    assert tuple(cam.position) == tuple(ref_cam.position)
    assert dataclasses.asdict(st) == dataclasses.asdict(ref_st)


# -- the pinned workload and the ray accounting --------------------------------

@pytest.mark.parametrize("config,size", [
    ("c1_sphere", (32, 18)), ("c2_csg", (32, 32)), ("c3_sdf", (32, 18)),
    ("c4_mesh", (32, 18)), ("c4_mesh", (1920, 1080))])
def test_metric_workload_matches_bench(config, size):
    """The same scene, reframed camera (kept as it is at its own size),
    settings, rotation and jittered positions, to the bit."""
    path = os.path.join(CONFIGS, config + ".yaml")
    scene, cam, st, R_flats, positions = pb.metric_workload(
        path, *size, n_frames=5)
    ref_scene, _, _, intr, ref_st, R_flat, ref_pos = bench.metric_workload(
        path, *size, n_frames=5)
    _same_scene(scene, ref_scene)
    assert dataclasses.asdict(cam.intrinsics) == dataclasses.asdict(intr)
    assert dataclasses.asdict(st) == dataclasses.asdict(ref_st)
    assert R_flats.dtype == positions.dtype == np.float32
    assert R_flats.tobytes() == np.tile(np.asarray(R_flat), (5, 1)).tobytes()
    assert positions.tobytes() == np.asarray(ref_pos).tobytes()


@pytest.mark.parametrize("n_lights", [1, 2, 3])
def test_rays_per_frame_matches_bench(n_lights):
    """Over shadows and AO on and off, sample counts and hit counts."""
    from surfjax_torch import api as pt_api
    from surfjax_torch.core.types import RenderSettings
    from surfjax.core.types import RenderSettings as SjSettings
    pt_scene, sj_scene = pt_api.Scene(), sj_api.Scene()
    for k in range(n_lights):
        pt_scene.add_light(pt_api.PointLight(position=(k, 4.0, -1.0)))
        sj_scene.add_light(sj_api.PointLight(position=(k, 4.0, -1.0)))
    _, cam, _ = scenes.config1_sphere(24)
    for shadows in (False, True):
        for ao in (False, True):
            for samples in (1, 5, 16):
                kw = dict(shadows=shadows, ao=ao, ao_samples=samples)
                for hits in (0.0, 1.0, 17.5, 576.0, 1234.375):
                    got = pb.rays_per_frame(pt_scene, RenderSettings(**kw),
                                            cam.intrinsics, hits)
                    ref = bench.rays_per_frame(sj_scene, SjSettings(**kw),
                                               cam.intrinsics, hits)
                    assert got == ref, (kw, hits)


# -- run_bench and bench_scene against surfjax's ------------------------------

COUNT_KEYS = ("rays_per_frame", "primary_rays", "shadow_rays", "ao_rays",
              "secondary_lod_iters", "ao_lod_iters", "over_relax",
              "bulb_iter", "frames_per_dispatch", "settings_backend")
TIMING_KEYS = ("value", "value_exact", "mrays_primary_shadow",
               "mrays_primary_shadow_exact", "frames_per_sec",
               "frame_time_s", "frame_time_exact_s")
PORT_KEYS = {"device", "repeats", "frame_times_s", "device_frame_time_s"}


@pytest.mark.parametrize("config,size", [
    ("c1_sphere", (32, 18)), ("c2_csg", (32, 32)), ("c4_mesh", (32, 18))])
def test_run_bench_counts_match_bench(config, size):
    path = os.path.join(CONFIGS, config + ".yaml")
    got = pb.run_bench(path, repeats=1, width=size[0], height=size[1],
                       n_frames=2, device="cpu")
    ref = bench.run_bench(path, repeats=1, width=size[0], height=size[1],
                          n_frames=2)
    assert set(got) == set(ref) - {"vs_baseline", "vs_baseline_exact"} \
        | PORT_KEYS
    for key in COUNT_KEYS:
        assert got[key] == ref[key], key
    assert got["shadow_rays"] > 0 or config == "c1_sphere"
    for key in TIMING_KEYS:
        assert got[key] > 0, key
    assert got["unit"] == "Mrays/s/card" and "/card" in got["metric"]
    assert (got["backend"], got["device"], got["repeats"]) == ("cpu", "cpu",
                                                               1)
    assert got["devices"] == torch.cuda.device_count()
    for mode in ("value", "value_exact"):
        assert len(got["frame_times_s"][mode]) == 1
        assert got["frame_times_s"][mode][0] > 0
        # CUDA events exist only on a card
        assert got["device_frame_time_s"][mode] is None
    json.dumps(got)


def test_run_bench_overrides_are_disclosed():
    path = os.path.join(CONFIGS, "c1_sphere.yaml")
    got = pb.run_bench(path, repeats=1, width=16, height=8, n_frames=1,
                       overrides={"backend": "pallas", "max_steps": 32},
                       device="cpu")
    assert got["settings_backend"] == "pallas"
    assert got["overrides"] == {"backend": "pallas", "max_steps": "32"}


def test_bench_scene_counts_match_bench_all():
    got = bench_all.bench_scene(*scenes.config2_csg(32), 2, "c2 csg 32^2",
                                repeats=1, batch=2, device="cpu")
    ref = sj_bench_all.bench_scene(*sj_scenes.config2_csg(32), 2,
                                   "c2 csg 32^2", repeats=1, batch=2)
    assert set(got) == set(ref) | {"device", "frame_ms_repeats",
                                   "device_frame_ms"}
    for key in ("config", "resolution", "rays_per_frame"):
        assert got[key] == ref[key], key
    assert got["rays_per_frame"] > 32 * 32
    assert got["frame_ms"] > 0 and got["fps"] > 0 and got["mrays_per_s"] > 0
    assert got["frame_ms_repeats"][0] == pytest.approx(got["frame_ms"])
    assert got["device_frame_ms"] is None and got["device"] == "cpu"


# -- the scenes --------------------------------------------------------------

def _sj_crowd64():
    """The crowd of tools/perf_check.py's `crowd64` row, built with
    surfjax's api as the gate builds it."""
    from surfjax.core.types import RenderSettings
    sc = sj_api.Scene()
    rng = np.random.RandomState(7)
    for i in range(64):
        c = (float(i % 6 - 2.5), float(i // 6 - 2.0), 4.0 + float(rng.rand()))
        sc.add(sj_api.Sphere(center=c, radius=0.3),
               sj_api.Material.lambert((0.2 + 0.02 * i, 0.5, 0.8)),
               engine="sdf")
    sc.add(sj_api.Plane(normal=(0.0, 1.0, 0.0), offset=-2.5),
           sj_api.Material.lambert((0.5, 0.5, 0.5)))
    sc.add_light(sj_api.PointLight(position=(3.0, 5.0, -1.0),
                                   color=(1.0, 1.0, 1.0)))
    cam = sj_api.Camera.pinhole(256, 256, 45.0, position=(0.0, 0.0, -2.0),
                                target=(0.0, 0.0, 4.0))
    return sc, cam, RenderSettings(shadows=True, max_steps=96,
                                   vector_objects=True)


@pytest.mark.parametrize("name,args", [
    ("config1_sphere", (256,)), ("config2_csg", (512,)),
    ("config3_sdf", (1024,)), ("config4_mesh", (1920, 1080)),
    ("crowd64", ())])
def test_scenes_match_reference(name, args):
    port = getattr(scenes, name)(*args)
    ref = (_sj_crowd64() if name == "crowd64"
           else getattr(sj_scenes, name)(*args))
    _same_scene(port[0], ref[0])
    _same_view(port[1], ref[1], port[2], ref[2])
    if name == "crowd64":
        assert len(port[0].objects) == 65
    v, f = scenes.make_test_mesh()
    rv, rf = sj_scenes.make_test_mesh()
    assert v.tobytes() == rv.tobytes() and f.tobytes() == rf.tobytes()


def test_c5_orbit_poses_match_perf_check():
    """perf_check's 128-frame c5 orbit, built as `_bench_c5_sequence`
    builds it: the eye within 1 ULP (sin and cos of two libraries differ
    by 1 ULP), so the positions (eye + centre) within 1 ULP of the orbit's
    radius; R within 2 ULP but at frames 24 and 78, where the two
    normalisations after it carry the eye's last bit to 4 ULP (surfjax run
    op by op gives the same). So c5_seq's counts are held on the card,
    not against surfjax."""
    extras = load_config(os.path.join(CONFIGS, "c5_anim.yaml"))[3]
    anim = extras["animation"]
    Rs, ts = scenes.c5_orbit_poses(anim, 128)
    assert Rs.shape == (128, 9) and ts.shape == (128, 3)
    assert Rs.dtype == ts.dtype == np.float32
    center = np.asarray(anim["center"], np.float32)
    r_ulp = []
    for i in range(128):
        th = np.float32(2.0 * np.pi * i / 128)
        R, t = sj_orbit_pose(jnp.float32(anim["radius"]),
                             jnp.float32(anim["height"]), th)
        R = np.asarray(R, np.float32).reshape(9)
        t = np.asarray(t, np.float32) + center
        r_ulp.append(int(ulp_diff_f32(Rs[i], R).max()))
        assert np.abs(ts[i] - t).max() <= np.spacing(np.float32(4.0)), i
    assert max(r_ulp) <= 4
    assert [i for i, u in enumerate(r_ulp) if u > 2] == [24, 78]


# -- the command lines ---------------------------------------------------------

def test_bench_subcommand_and_module_pass_their_arguments(monkeypatch,
                                                          capsys):
    calls = []

    def stub(**kw):
        calls.append(kw)
        return {"value": 1.0, "rays_per_frame": 7}
    monkeypatch.setattr(pb, "run_bench", stub)
    cli.main(["bench"])
    cli.main(["bench", "--config", "configs/c1_sphere.yaml", "--repeats",
              "2", "--device", "cpu"])
    assert calls == [
        dict(config=None, repeats=5, device="cuda"),
        dict(config="configs/c1_sphere.yaml", repeats=2, device="cpu")]
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln) for ln in lines] == [
        {"value": 1.0, "rays_per_frame": 7}] * 2
    calls.clear()
    pb.main(["configs/c2_csg.yaml", "repeats=2", "n_frames=4", "width=32",
             "height=16", "device=cpu", "bulb_iter=std", "ao=false",
             "max_steps=64", "over_relax=1.25"])
    pb.main([])
    assert calls == [
        dict(config="configs/c2_csg.yaml", repeats=2, n_frames=4, width=32,
             height=16, device="cpu",
             overrides=dict(bulb_iter="std", ao=False, max_steps=64,
                            over_relax=1.25)),
        dict(config=None, repeats=3, n_frames=48, width=1920, height=1080,
             device="cuda", overrides=None)]
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 2 and json.loads(out[0])["rays_per_frame"] == 7


def test_bench_all_rows_and_table(monkeypatch, capsys):
    """--rows matrix and --rows gated: the rows of tools/bench_all.main and
    perf_check's gate (headline first), each printed as a JSON line, the
    gated ones tagged with their workload; then the table."""
    seen = []

    def row(name):
        return {"config": name, "resolution": [8, 8], "frame_ms": 2.0,
                "fps": 500.0, "mrays_per_s": 1.0, "rays_per_frame": 64}

    def fake_scene(scene, camera, settings, lights, name, repeats=3,
                   batch=24, device="cuda"):
        seen.append((name, lights, repeats, batch, device))
        return row(name)

    def fake_bench(**kw):
        seen.append(("run_bench", kw))
        # the values as run_bench derives them from the times below
        return {"value": 1000.0,
                "value_exact": 750.0, "rays_per_frame": 3000000,
                "frame_times_s": {"value": [0.003], "value_exact": [0.004]},
                "device_frame_time_s": {"value": None, "value_exact": None},
                "device": "cpu"}

    def fake_c5(device="cuda"):
        seen.append(("c5_seq", device))
        return row("c5 sequence")
    monkeypatch.setattr(bench_all, "bench_scene", fake_scene)
    monkeypatch.setattr(bench_all, "run_bench", fake_bench)
    monkeypatch.setattr(bench_all, "bench_c5_sequence", fake_c5)
    assert [w for w, _ in bench_all.rows("matrix")] == [
        "c1", "c2", "c3", "c3_fixture_cam", "headline", "c4_fixture",
        "c4_config"]
    assert [w for w, _ in bench_all.rows("gated")] == [
        "headline", "c2", "c4_fixture", "c4_config", "crowd64", "c5_seq"]
    with pytest.raises(ValueError):
        bench_all.rows("all")

    bench_all.main(["--rows", "matrix", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    got = [json.loads(ln) for ln in out[:8]]
    assert [r["config"] for r in got] == [
        "c1 sphere 256^2", "c2 csg 512^2", "c3 sdf 1024^2",
        "c3 FIXTURE-cam 1080p", "c3 METRIC (bench)", "c3 METRIC exact-LoD0",
        "c4 FIXTURE mesh (128 tris) 1080p",
        "c4 CONFIG mesh (8192 tris) 1080p"]
    assert got[4]["frame_ms"] == pytest.approx(3.0)
    assert got[4]["mrays_per_s"] == pytest.approx(1000.0)
    assert got[5]["mrays_per_s"] == pytest.approx(750.0)
    assert out[8] == "" and out[9].startswith("config")
    assert len(out) == 18 and all("workload" not in r for r in got)
    assert seen[:2] == [("c1 sphere 256^2", 1, 3, 64, "cpu"),
                        ("c2 csg 512^2", 2, 3, 32, "cpu")]
    assert ("run_bench", {"device": "cpu"}) in seen

    seen.clear()
    bench_all.main(["--rows", "gated", "--device", "cpu"])
    got = [json.loads(ln) for ln in
           capsys.readouterr().out.splitlines()[:7]]
    assert [r["workload"] for r in got] == [
        "headline", "headline", "c2", "c4_fixture", "c4_config", "crowd64",
        "c5_seq"]
    assert ("c2 csg 512^2", 2, 6, 128, "cpu") in seen
    assert ("crowd 65 objects 256^2", 1, 3, 24, "cpu") in seen
    assert ("c5_seq", "cpu") in seen


# -- the quickstart ------------------------------------------------------------

def _sj_quickstart_scenes():
    """examples/quickstart.py's two scenes, cameras and settings, built
    with surfjax's api as that script builds them."""
    from surfjax.core.types import RenderSettings
    a = sj_api
    scene = a.Scene()
    scene.add(a.subtract(a.Box(center=(0.6, -0.2, 3.0),
                               half_extents=(0.45, 0.45, 0.45)),
                         a.Sphere(center=(0.6, 0.1, 2.7), radius=0.4)),
              a.Material.blinn_phong(albedo=(0.2, 0.45, 0.8), shininess=64))
    scene.add(a.smooth_union(a.Sphere(center=(-0.7, -0.3, 3.2), radius=0.5),
                             a.Sphere(center=(-0.2, 0.2, 3.0), radius=0.35),
                             0.25),
              a.Material.lambert(albedo=(0.4, 0.7, 0.45)), engine="sdf")
    scene.add(a.Plane(normal=(0.0, 1.0, 0.0), offset=-0.9),
              a.Material.lambert(albedo=(0.5, 0.5, 0.55)))
    scene.add_light(a.PointLight(position=(3.0, 4.0, -1.0)))
    camera = a.Camera.pinhole(512, 384, fov_y_deg=45.0,
                              position=(0.0, 0.4, 0.0),
                              target=(0.0, 0.0, 3.0))
    fit_scene = a.Scene()
    fit_scene.add(a.smooth_union(a.Sphere(center=(-0.35, -0.1, 3.0),
                                          radius=0.6),
                                 a.Sphere(center=(0.45, 0.1, 3.0),
                                          radius=0.45), 0.3),
                  a.Material.lambert(albedo=(0.4, 0.6, 0.8)), engine="sdf")
    fit_scene.add_light(a.PointLight(position=(3.0, 4.0, -1.0)))
    return ((scene, camera, RenderSettings(shadows=True, ao=True)),
            (fit_scene, a.Camera.pinhole(96, 72, fov_y_deg=45.0),
             RenderSettings(shadows=False, max_steps=64, t_max=20.0)))


def test_quickstart_scenes_match_the_example():
    (ref, ref_cam, ref_st), (fit_ref, fit_cam, fit_st) = \
        _sj_quickstart_scenes()
    scene, cam = quickstart.demo_scene()
    _same_scene(scene, ref)
    from surfjax_torch.core.types import RenderSettings
    _same_view(cam, ref_cam, RenderSettings(shadows=True, ao=True), ref_st)
    f_scene, f_cam, f_st, init = quickstart.fit_case()
    _same_scene(f_scene, fit_ref)
    _same_view(f_cam, fit_cam, f_st, fit_st)
    np.testing.assert_array_equal(
        init[0], np.asarray([0.04, -0.03, 0.02], np.float32))
    np.testing.assert_array_equal(
        init[1], np.asarray([0.05, -0.05, 0.0], np.float32))
    Rs, ps = quickstart.dolly(cam)
    assert Rs.shape == (8, 9) and ps.shape == (8, 3)
    assert np.allclose(ps[7] - ps[0], 0.14)


def test_quickstart_frame_and_sequence_at_64x48(tmp_path, capsys):
    """Steps 1-3 through the kernels' plain versions (backend pallas):
    the frame written, the sequence's frame 0 equal to the frame."""
    fb, fbs = quickstart.render_demo(torch.device("cpu"), str(tmp_path),
                                     "pallas", size=(64, 48))
    assert (tmp_path / "frame.png").stat().st_size > 0
    assert tuple(fbs.rgb.shape) == (8, 48, 64, 3)
    assert 0.2 < float(fb.hit.mean()) < 1.0
    for field in fb._fields:
        assert torch.equal(getattr(fb, field), getattr(fbs, field)[0]), field
    assert "sequence: (8, 48, 64, 3)" in capsys.readouterr().out


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_quickstart_fit_converges(backend):
    """The fit in full: the eager pipeline, and the card's route (K1 and
    K2's plain versions through the hybrid)."""
    losses = quickstart.fit_demo(torch.device("cpu"), backend)
    assert len(losses) == 80 and losses[-1] < 0.2 * losses[0]
