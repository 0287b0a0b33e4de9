"""Two rules of surfjax_torch that are easy to break quietly:

  * the package never imports jax (nor surfjax, which imports jax);
  * a CUDA request never falls back to the CPU: without a card it raises,
    and the fused-path wrapper takes only CPU tensors (twin) or CUDA
    tensors (kernel).
"""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from surfjax_torch import api, config  # noqa: E402
from surfjax_torch.core.scene_compile import params_to_device  # noqa: E402
from surfjax_torch.kernels.render_tile import (  # noqa: E402
    SceneTensors, frame_fused,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RENDER_C1 = """
import sys
from surfjax_torch import Camera, render, render_sequence
from surfjax_torch.config import load_config
from surfjax_torch.core.camera import Intrinsics

scene, cam, st, _ = load_config("configs/c1_sphere.yaml")
cam = Camera(Intrinsics.from_fov(16, 16, 45.0), cam.rotation, cam.position)
for backend in ("jnp", "pallas"):
    fb = render(scene, cam, st.with_(backend=backend), device="cpu")
    assert tuple(fb.rgb.shape) == (16, 16, 3), fb.rgb.shape
    assert float(fb.hit.mean()) > 0.1
# the crowd loops, the priming pass and the tools the chip scripts use
from surfjax_torch import api
from surfjax_torch.tools import breakdown, kernel_check, workload
scene, cam, st = workload.crowd_scene(api, size=(16, 12), shadows=True)
fb = render(scene, cam, st.with_(vector_objects=True), device="cpu")
assert float(fb.hit.mean()) > 0.1
scene, cam, st, _ = load_config("configs/c3_sdf.yaml")
cam = Camera(Intrinsics.from_fov(16, 16, 45.0), cam.rotation, cam.position)
with kernel_check.capture_calls() as calls:
    render(scene, cam, st.with_(backend="pallas", prime=True, prime_min=16,
                                max_steps=32), device="cpu")
assert [c[0] for c in calls] == ["prime_tile"], calls
# the fit path (one hybrid gradient, two fit steps) and the tools beside it
from surfjax_torch.diff import fit_sdf, pose_loss_and_grad
from surfjax_torch.tools import fit_bench, fp32_peak
from surfjax_torch.utils import checkpoint
scene, cam, st, _ = load_config("configs/c5_anim.yaml")
cam = Camera(Intrinsics.from_fov(16, 16, 45.0), cam.rotation, cam.position)
st = st.with_(backend="pallas", tile_rows=8)
loss, g = pose_loss_and_grad(scene, cam, st, device="cpu")
assert loss > 0.0 and abs(g["w"]).max() > 0.0 and abs(g["dt"]).max() > 0.0
target = render(scene, cam, st, device="cpu").rgb
lp, losses = fit_sdf(scene, cam, target, steps=2, settings=st, device="cpu")
assert lp.shape[1] == 8 and len(losses) == 2
assert float(fp32_peak.fp32_peak_reference(
    "cheb_mix", *fp32_peak.seeds(1, 1, "cpu"), 4).mean()) > 1.0
# the golden oracles, the image I/O, the utilities and the command line
import os, tempfile
import numpy as np
import torch
from surfjax_torch import __main__ as cli
from surfjax_torch.core.camera import pose_interp
from surfjax_torch.golden import cpp_bridge, renderer as golden
from surfjax_torch.io.image import max_ulp, save_exr, save_golden
from surfjax_torch.utils import checks, profiling
scene, cam, st, _ = load_config("configs/c1_sphere.yaml")
cam = Camera(Intrinsics.from_fov(16, 16, 45.0), cam.rotation, cam.position)
g = golden.render_parallel(scene, cam, st, n_workers=2)
assert max_ulp(cpp_bridge.render(scene, cam, st)["rgb"], g["rgb"]) <= 1
fb = checks.checked(render)(scene, cam, st, device="cpu")
assert checks.validate_framebuffers(fb)["ok"]
R = torch.eye(3).reshape(9)
pose_interp((R, torch.zeros(3)), (R, torch.ones(3)), 0.5)
with tempfile.TemporaryDirectory() as tmp:
    with profiling.trace_render(tmp), profiling.annotate("c1"):
        render(scene, cam, st, device="cpu")
    save_exr(os.path.join(tmp, "g.exr"), g["rgb"])
    save_golden(os.path.join(tmp, "g.npz"), g)
    checkpoint.SequenceCheckpointer(tmp, 1).render_all(
        1, lambda s, n: g["rgb"][None])
    cli.main(["render", "--config", "configs/c1_sphere.yaml", "--golden",
              "--gbuffer", "--out", os.path.join(tmp, "c1.png")])
# the sharding layer: a frame through a gloo group of one
import torch.distributed as dist
from surfjax_torch.parallel import (
    initialize_distributed, make_mesh, render_frame_sharded,
)
from surfjax_torch.parallel import dryrun, launch, ring_mesh
os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
with tempfile.TemporaryDirectory() as tmp:
    initialize_distributed("cpu", init_method="file://" + tmp + "/store",
                           rank=0, world_size=1)
    fb = render_frame_sharded(scene, cam, st.with_(backend="pallas"),
                              make_mesh(device="cpu"), device="cpu")
    assert tuple(fb.rgb.shape) == (16, 16, 3) and float(fb.hit.mean()) > 0.1
    dist.destroy_process_group()
# the benchmark harness, the workload matrix and the quickstart
from surfjax_torch import bench, quickstart
from surfjax_torch.tools import bench_all, scenes
r = bench.run_bench("configs/c1_sphere.yaml", repeats=1, width=8, height=8,
                    n_frames=1, device="cpu")
assert r["primary_rays"] == 64 and r["device"] == "cpu"
assert len(scenes.crowd64()[0].objects) == 65
# scenes past the kernels' former fixed bounds, and compile_scaling
from surfjax_torch.tools import compile_scaling
scene, cam, st = workload.limit_cases(api, (8, 8))["smooth 17 left"]
assert float(render(scene, cam, st, device="cpu").hit.mean()) > 0.1
row = compile_scaling.measure(70, False, size=(16, 9), repeats=0,
                              device="cpu")
assert row["objects"] == 71 and row["hit_fraction"] > 0.2
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "optax", "surfjax"))
print("LOADED", loaded)
sys.exit(1 if loaded else 0)
"""


def test_package_renders_without_importing_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", _RENDER_C1], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


@pytest.mark.parametrize("command", [
    ["chip_smoke.py"], ["-m", "surfjax_torch.tools.breakdown"],
    ["-m", "surfjax_torch.tools.fp32_peak"],
    ["-m", "surfjax_torch.tools.fit_bench"], ["-m", "surfjax_torch.bench"],
    ["-m", "surfjax_torch", "bench"], ["-m", "surfjax_torch.tools.bench_all"],
    ["-m", "surfjax_torch.quickstart"],
    ["-m", "surfjax_torch.tools.compile_scaling"],
    ["-m", "surfjax_torch.parallel.dryrun", "2"]])
def test_gpu_scripts_refuse_to_run_without_a_card(command):
    """The chip scripts measure the card: without one they exit non-zero
    and print no result line, instead of measuring the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, *command], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "is_available() is false" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_dry_run_defaults_to_the_card():
    """dryrun_step, dryrun_multichip and run_world run on the card unless
    asked for the CPU: without one each raises before any rank is
    spawned."""
    import multiprocessing
    from surfjax_torch.parallel import dryrun, launch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal "
                    "without one")
    for call in (dryrun.dryrun_step, lambda: dryrun.dryrun_multichip(2),
                 lambda: launch.run_world(dryrun.dryrun_step, 2, "cpu")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert multiprocessing.active_children() == []


def _c1(size=8):
    scene, cam, st, _ = config.load_config(
        os.path.join(ROOT, "configs", "c1_sphere.yaml"))
    from surfjax_torch.core.camera import Intrinsics
    cam = api.Camera(Intrinsics.from_fov(size, size, 45.0), cam.rotation,
                     cam.position)
    return scene, cam, st


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_cuda_request_without_a_card_raises(backend):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal "
                    "without one")
    scene, cam, st = _c1()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.render(scene, cam, st.with_(backend=backend), device="cuda")


def test_fused_wrapper_takes_only_cpu_or_cuda_tensors():
    """A tensor on another device (here `meta`) is refused, not copied to
    the CPU and rendered there; nothing is counted as a kernel launch."""
    scene, cam, st = _c1()
    static, params = scene.freeze()
    scene_t = SceneTensors(static, params_to_device(params, "meta"))
    rows = torch.zeros((1, 12), dtype=torch.float32, device="meta")
    before = frame_fused.launches
    with pytest.raises(ValueError, match="unsupported device"):
        frame_fused(scene_t, st.with_(backend="pallas"), cam.intrinsics, rows)
    with pytest.raises(ValueError, match="float32"):
        frame_fused(scene_t, st, cam.intrinsics, rows.to(torch.float64))
    with pytest.raises(ValueError, match=r"\(F, 12\)"):
        frame_fused(scene_t, st, cam.intrinsics, rows[:, :9])
    assert frame_fused.launches == before


def test_prime_and_crowd_wrappers_take_only_cpu_or_cuda_tensors():
    """The priming wrapper and the split wrappers with a crowd active
    refuse a tensor on another device and count no launch."""
    from surfjax_torch.kernels import render_tile as rt
    from surfjax_torch.tools import workload
    scene, cam, st = workload.crowd_scene(api, size=(16, 8), shadows=True)
    static, params = scene.freeze()
    on = st.with_(vector_objects=True)
    assert rt.split_crowd(static, on)[0] is not None
    scene_t = SceneTensors(static, params_to_device(params, "meta"))
    rays = tuple(torch.zeros((8, 128), device="meta") for _ in range(3))
    wrappers = (rt.render_tile, rt.trace_rays, rt.ao_fix, rt.prime_tile,
                frame_fused)
    before = [w.launches for w in wrappers]
    with pytest.raises(ValueError, match="unsupported device"):
        rt.render_tile(scene_t, on, rays, rays)
    with pytest.raises(ValueError, match="unsupported device"):
        rt.trace_rays(scene_t, on, rays, rays, rays[0], rays[0])
    with pytest.raises(ValueError, match="unsupported device"):
        rt.ao_fix(scene_t, on, rays, rays, rays[0], rays[0])
    with pytest.raises(ValueError, match="unsupported device"):
        rt.prime_tile(scene_t, st, 0.01, rays, rays)
    with pytest.raises(ValueError, match="unsupported device"):
        frame_fused(scene_t, on, cam.intrinsics,
                    torch.zeros((1, 12), device="meta"))
    assert [w.launches for w in wrappers] == before


def test_candidate_wrapper_takes_only_cpu_or_cuda_tensors():
    """mesh_candidates on a tensor on neither the CPU nor a card raises and
    counts no launch; on the CPU it runs the plain version, bitwise, and
    counts none either."""
    import numpy as np

    from surfjax_torch.kernels import mesh_tile as mt
    from surfjax_torch.meshgen import octasphere
    v, f = octasphere(2)
    static, params = api.Scene().add(api.TriangleMesh(
        vertices=v * np.float32(0.8) + np.float32([0.0, 0.0, 3.0]),
        faces=f)).freeze()
    ms, tri = static.mesh_static[0], torch.as_tensor(
        params["mesh0_tri_packed"])
    o = tuple(torch.zeros((4, 128)) for _ in range(3))
    d = (torch.zeros((4, 128)), torch.zeros((4, 128)), torch.ones((4, 128)))
    before = mt.mesh_candidates.launches
    got = mt.mesh_candidates(ms, tri, o, d, 1e-3, 1e4, 2)
    ref = mt.mesh_candidates_reference(ms, tri, o, d, 1e-3, 1e4, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert int(got[1].min()) > 0
    meta = lambda ts: tuple(t.to("meta") for t in ts)  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        mt.mesh_candidates(ms, tri.to("meta"), meta(o), meta(d), 1e-3, 1e4,
                           2)
    assert mt.mesh_candidates.launches == before


def test_capped_calls_on_meta_tensors_launch_nothing():
    """A capped K1 or K2 call and their residual re-runs on a tensor on
    neither the CPU nor a card raise and count no launch: a capped call
    launches the kernels or raises, it never falls back."""
    from surfjax_torch.kernels import render_tile as rt
    from surfjax_torch.tools import workload
    scene, cam, st = workload.mesh_soft_ao_scene(api, 8)
    static, params = scene.freeze()
    scene_t = SceneTensors(static, params_to_device(params, "meta"))
    rays = tuple(torch.zeros((8, 128), device="meta") for _ in range(3))
    outs = tuple(torch.zeros((8, 128), device="meta") for _ in range(8))
    redo = torch.ones(8, device="meta")
    before = (rt.render_tile.launches, rt.trace_rays.launches)
    capped = st.with_(march_cap=8, shadow_march_cap=8)
    for call in (
            lambda: rt.render_tile(scene_t, capped, rays, rays),
            lambda: rt.trace_rays(scene_t, capped, rays, rays, rays[0],
                                  rays[0]),
            lambda: rt.render_tile_redo(scene_t, st, outs, redo, rays, rays),
            lambda: rt.trace_rays_redo(scene_t, st, outs[:2], redo, rays,
                                       rays, rays[0], rays[0])):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    assert (rt.render_tile.launches, rt.trace_rays.launches) == before


def test_fused_wrapper_refuses_what_the_kernel_does_not_take():
    scene, cam, st = _c1()
    static, params = scene.freeze()
    scene_t = SceneTensors(static, params_to_device(params, "cpu"))
    rows = torch.zeros((1, 12), dtype=torch.float32)
    for bad, exc in ((dict(march_cap=16), NotImplementedError),
                     (dict(shadow_march_cap=8), NotImplementedError),
                     (dict(bulb_iter="trig"), ValueError)):
        with pytest.raises(exc):
            frame_fused(scene_t, st.with_(**bad), cam.intrinsics, rows)
    # the crowd and priming are carried: their settings no longer raise
    for ok in (dict(vector_objects=True), dict(prime=True)):
        out = frame_fused(scene_t, st.with_(**ok), cam.intrinsics, rows)
        assert len(out) == 9 and out[0].shape == (1, 8, 8)
    with pytest.raises(ValueError, match=r"\(F, H, W\)"):
        frame_fused(scene_t, st, cam.intrinsics, rows, t0=torch.zeros(8, 8))
    bulb = api.Scene()
    bulb.add(api.Mandelbulb(power=6))
    bstatic, bparams = bulb.freeze()
    with pytest.raises(NotImplementedError, match="power=8"):
        frame_fused(SceneTensors(bstatic, params_to_device(bparams, "cpu")),
                    st, cam.intrinsics, rows)


@pytest.mark.parametrize("name", ["64 spheres", "smooth 17 right"])
def test_limit_scenes_reach_the_kernel_wrappers(name, monkeypatch):
    """A 65-object scene and a 33-node tape on backend="pallas": the fused
    path's frame goes to frame_fused, a capped frame's calls to the split
    wrappers (record_call), and nothing reaches the eager pipeline."""
    from surfjax_torch.kernels import render_tile as rt
    from surfjax_torch.pipeline import frame
    from surfjax_torch.tools import workload
    from surfjax_torch.tools.kernel_check import capture_calls

    def eager(*args, **kw):
        raise AssertionError("the eager pipeline was called")

    for fn in ("render_rays", "trace_scene", "compute_normals",
               "light_visibility"):
        monkeypatch.setattr(frame, fn, eager)
    fused = []
    real = rt.frame_fused

    def counted(*args, **kw):
        fused.append(args[1])
        return real(*args, **kw)

    monkeypatch.setattr(rt, "frame_fused", counted)
    scene, cam, st = workload.limit_cases(api, (8, 8))[name]
    fb = api.render(scene, cam, st, device="cpu")
    assert len(fused) == 1 and float(fb.hit.mean()) > 0.5
    with capture_calls() as calls:
        api.render(scene, cam, st.with_(march_cap=8), device="cpu")
    assert len(fused) == 1
    assert {"render_tile", "trace_rays"} <= {k for k, _ in calls}
