"""The priming kernel (surfjax_torch/kernels/csrc/prime_tile.cu) built for
the CPU behind the host stand-in of the CUDA runtime (tests/cuda_host.py),
launched through the port's own launcher with the library and the stream
swapped for the host's, and held bitwise against its plain version,
prime_tile_reference, on the coarse rays that prime_frame makes for:

  * c3 (configs/c3_sdf.yaml) at 96x96 with prime_min 64: a smooth-union
    blob and a Mandelbulb, both replaced by their lower spheres in the
    proxy phase;
  * a scene whose SDF objects have no proxy sphere (has_proxy 0: the march
    is the SDF phase alone), with an SDF plane beside them;
  * c3's rays cut to a ragged count, not a multiple of a block's 128 rays.

The profiling instantiation writes the same t0; its SDF evaluations equal
the plain version's (count_ops), and its steps per phase equal the plain
march's.
"""

import contextlib
import ctypes
import os
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import surfjax_torch.api as api  # noqa: E402
from surfjax_torch.config import load_config  # noqa: E402
from surfjax_torch.kernels import _build  # noqa: E402
from surfjax_torch.kernels import render_tile as rt  # noqa: E402
from surfjax_torch.tools import workload  # noqa: E402
from surfjax_torch.tools.kernel_check import capture_calls  # noqa: E402

from tests import cuda_host  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _c3():
    scene, cam, st, _ = load_config(os.path.join(ROOT, "configs",
                                                 "c3_sdf.yaml"))
    return scene, workload.reframe(cam, 96, 96), st.with_(
        backend="pallas", prime=True, prime_min=64)


def _no_proxy():
    """An SDF sphere, box and plane, each one leaf, which the proxy
    evaluates exactly: no object has a proxy sphere."""
    scene = api.Scene()
    scene.add(api.Plane(normal=(0.0, 1.0, 0.0), offset=-1.0),
              api.Material.lambert((0.5, 0.5, 0.55)), engine="sdf")
    scene.add(api.Sphere(center=(0.4, -0.3, 3.0), radius=0.6),
              api.Material.lambert((0.8, 0.3, 0.3)), engine="sdf")
    scene.add(api.Box(center=(-0.6, -0.2, 3.6), half_extents=(0.3, 0.3, 0.3)),
              api.Material.lambert((0.3, 0.7, 0.4)), engine="sdf")
    scene.add_light(api.PointLight(position=(2.0, 4.0, 0.0)))
    cam = api.Camera.pinhole(80, 72, fov_y_deg=50.0,
                             position=(0.0, 0.6, -0.5),
                             target=(0.0, -0.3, 3.0))
    st = api.RenderSettings(shadows=True, backend="pallas", prime=True,
                            prime_min=64, max_steps=96)
    return scene, cam, st


def _prime_call(scene, cam, st):
    with capture_calls() as calls:
        api.render(scene, cam, st, device="cpu")
    assert [k for k, _ in calls] == ["prime_tile"]
    return calls[0][1]


def _ragged(args, n):
    """The call's coarse rays cut to their first n, as one row."""
    o, d = (tuple(c.reshape(-1)[:n].contiguous() for c in a)
            for a in args[3:5])
    return args[:3] + (o, d)


@pytest.fixture(scope="module")
def calls():
    c3 = _prime_call(*_c3())
    return {"c3": c3, "no proxy": _prime_call(*_no_proxy()),
            "ragged": _ragged(c3, 300)}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if cuda_host.gxx() is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    lib = cuda_host.build("prime_tile.cu",
                          str(tmp_path_factory.mktemp("prime_host")))
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    lib.pt_prime_tile.argtypes = [rt.KFTables, rt.KFSettings, rt.KSLayout,
                                  rt.PrimeArgs, ptr, i32, ptr]
    fn = lib.pt_prime_tile
    # the launcher passes its tensors' device index: None on the CPU
    return types.SimpleNamespace(
        pt_prime_tile=lambda T, S, L, A, prof, dev, st: fn(T, S, L, A, prof,
                                                           0, st))


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """The launcher loads the host library and launches on a stand-in
    stream."""
    monkeypatch.setattr(_build, "load", lambda: host_lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))


def test_cases_exercise_both_phases(calls):
    """c3 has proxy spheres (both of its SDF objects), the other scene
    none."""
    proxied = {label: any(rt._proxy_bounded(oir) for _, oir in
                          rt._split(args[0].static)[1])
               for label, args in calls.items()}
    assert proxied == {"c3": True, "no proxy": False, "ragged": True}


@pytest.mark.parametrize("label", ["c3", "no proxy", "ragged"])
def test_host_kernel_equals_plain(calls, on_host, label):
    """The kernel on the case's coarse rays, twice: bitwise the plain
    version's t0."""
    args = calls[label]
    ref = rt.prime_tile_reference(*args)
    launch, (out,) = rt.prime_launcher(*args)
    for _ in range(2):
        out.fill_(-1.0)
        launch()
        assert torch.equal(out, ref), label


def _plain_steps(args, monkeypatch):
    """The plain march's lane-steps per phase: each step tallies the live
    lanes' evaluations of its phase's function (the proxy's carries
    flat_ops) -> {"proxy steps": n, "sdf steps": n}."""
    steps = {"proxy steps": 0, "sdf steps": 0}
    tally = rt._tally_de

    def counting(fn, lanes, evals=1):
        key = "proxy steps" if hasattr(fn, "flat_ops") else "sdf steps"
        steps[key] += int(lanes.sum())
        return tally(fn, lanes, evals)

    monkeypatch.setattr(rt, "_tally_de", counting)
    rt.prime_tile_reference(*args)
    monkeypatch.setattr(rt, "_tally_de", tally)
    return steps


@pytest.mark.parametrize("label", ["c3", "no proxy", "ragged"])
def test_host_profile_equals_plain_and_counts(calls, on_host, monkeypatch,
                                              label):
    """The profiling instantiation's t0, SDF evaluations and steps per
    phase against the plain version's."""
    args = calls[label]
    with rt.count_ops() as c:
        ref = rt.prime_tile_reference(*args)
    launch, (out,), prof = rt.prime_profile_launcher(*args)
    launch()
    assert torch.equal(out, ref)
    names = list(rt.PRIME_PHASE_NAMES)
    col = {name: int(prof[:, names.index(name), 2].sum()) for name in names}
    assert col["evals proxy"] + col["evals sdf"] == c["evals"], label
    scene_t = args[0]
    sdf_objs = rt._split(scene_t.static)[1]
    exact = sum(not rt._proxy_bounded(oir) for _, oir in sdf_objs)
    assert col["evals sdf"] == col["sdf steps"] * len(sdf_objs)
    assert col["evals proxy"] == col["proxy steps"] * exact
    steps = _plain_steps(args, monkeypatch)
    assert {k: col[k] for k in steps} == steps, label
    assert (steps["proxy steps"] > 0) == (label != "no proxy")
