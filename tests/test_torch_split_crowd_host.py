"""K1 and K2 with a crowd (surfjax_torch/kernels/csrc/split_path.cu) and
ao_fix with a crowd (csrc/ao_fix_crowd.cu), the member loops culled per
warp of 32 consecutive rays, built for the CPU behind the host stand-in
of the CUDA runtime (tests/cuda_host.py: each CUDA thread a std::thread,
the warp's votes and shuffles through per-warp barriers), launched
through the port's own `render_tile.split_launcher` with the library and
the stream swapped for the host's, and held bitwise against their plain
versions, unres included, on:

  * K1 and K2 (every light) on the rays of tests/test_torch_split_crowd.py
    (a 40x23 frame in the split path's layout, cut to a ragged count; 931
    rays from random origins; 466 more each shot both ways, so that a
    warp's directions sum to 0): surfjax_torch/configs/crowd_mesh.yaml in
    its own settings (hard shadows, AO) and with soft shadows, each also
    with march_cap = shadow_march_cap = 2 and then the residual re-runs
    over the rows the caps flagged;
  * workload.cull_edge_scene at 21x13, soft and capped: a point light with
    kf < 1.2 on the near receivers, where the capped launch keeps every
    member so that unres stays the plain version's.

ao_fix with a crowd is held the same way against its plain version and
the plain version that visits only the members each warp votes
(split_warp_masks' ao_fix), on the ao_fix call of the crowd_mesh frame of
tests/test_torch_split_crowd.py (40x23, cut to 8,179 lanes) with each of
its needs (the mesh's lanes, one needing lane per warp, lanes 0 and 31 of
every warp, none, all); its profiling instantiation (render_tile.
crowd_ao_fix_launcher(..., profile=True)) writes the same output and
marks as skipped exactly the warps without a needing lane.
"""

import contextlib
import ctypes
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import surfjax_torch.api as api  # noqa: E402
from surfjax_torch.core.scene_compile import params_to_device  # noqa: E402
from surfjax_torch.kernels import _build  # noqa: E402
from surfjax_torch.kernels import render_tile as rt  # noqa: E402
from surfjax_torch.tools import workload  # noqa: E402
from surfjax_torch.tools.kernel_check import (  # noqa: E402
    KERNELS, flat, fresh, masks_of,
)

from tests import cuda_host  # noqa: E402
from tests.test_torch_split_crowd import (  # noqa: E402
    AO_FIX_CASES, _ao_fix_args, _calls, _shadow_args, _split_rays,
)

ENTRIES = ("sp_render_tile", "sp_trace_rays")


def _edge_calls(cap):
    scene, cam, st = workload.cull_edge_scene(api, (21, 13), soft=True)
    st = st.with_(vector_objects=True, march_cap=cap, shadow_march_cap=cap)
    static, params = scene.freeze()
    scene_t = rt.SceneTensors(static, params_to_device(params, "cpu"))
    o, d = _split_rays(cam, cut=5)
    k1_args = (scene_t, st, o, d)
    k1 = rt.render_tile_reference(*k1_args)
    return [("render_tile", k1_args, k1)] + [
        ("trace_rays", a, rt.trace_rays_reference(*a))
        for a in _shadow_args(scene_t, st, o, d, k1)]


def _with_redo(calls):
    """The capped calls, each followed by its residual re-run over the rows
    its unres flags (the outputs it writes over: the capped plain ones)."""
    out = []
    for kname, args, ref in calls:
        out.append((kname, args))
        outs = tuple(a.clone() for a in ref)
        out.append((kname + "_redo",
                    args[:2] + (outs, rt.redo_rows(ref[-1])) + args[2:]))
    return out


CASES = {
    "crowd_mesh": lambda: _calls("crowd_mesh config"),
    "crowd_mesh soft": lambda: _calls("crowd_mesh soft"),
    "crowd_mesh capped": lambda: _with_redo(_calls("crowd_mesh config", 2)),
    "crowd_mesh soft capped": lambda: _with_redo(_calls("crowd_mesh soft",
                                                        2)),
    "random origins soft capped": lambda: _with_redo(
        _calls("random origins soft", 2)),
    "opposed rays": lambda: _calls("opposed rays"),
    "edges soft capped": lambda: _with_redo(_edge_calls(3)),
}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if cuda_host.gxx() is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    lib = cuda_host.build("split_path.cu",
                          str(tmp_path_factory.mktemp("split_crowd_host")))
    fns = {}
    for entry in ENTRIES:
        f = getattr(lib, entry)
        f.argtypes = [rt.KFTables, rt.KFSettings, rt.SplitRays,
                      ctypes.c_int, ctypes.c_void_p]
        # the launcher passes its tensors' device index: None on the CPU
        fns[entry] = (lambda f: lambda T, S, R, dev, st: f(T, S, R, 0, st))(f)
    f = cuda_host.build("ao_fix_crowd.cu", str(
        tmp_path_factory.mktemp("ao_fix_crowd_host"))).sp_ao_fix
    f.argtypes = [rt.KFTables, rt.KFSettings, rt.SplitRays, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_void_p]
    fns["sp_ao_fix"] = lambda T, S, R, prof, dev, st: f(T, S, R, prof, 0, st)
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


@pytest.mark.parametrize("label", list(CASES))
def test_host_crowd_kernels_equal_plain(on_host, label):
    calls = [c[:2] for c in CASES[label]()]
    names = {k for k, _ in calls}
    assert {"render_tile", "trace_rays"} <= names, names
    if "capped" in label:
        assert {"render_tile_redo", "trace_rays_redo"} <= names, names
    for k, (kname, args) in enumerate(calls):
        ref = flat(KERNELS[kname][1](*fresh(kname, args)))
        launch, out = KERNELS[kname][3](*fresh(kname, args))
        launch()
        out = flat(out)
        assert len(out) == len(ref) - (0 if "capped" in label else 1)
        for j, (a, b) in enumerate(zip(out, ref)):
            assert torch.equal(a, b), f"{label} call {k} {kname} output {j}"
    if "capped" in label:
        # the caps cut some lane off: the re-runs had rows to take
        assert any(float(args[3].sum()) > 0 for k, args in calls
                   if k.endswith("_redo"))


def test_host_edges_have_a_whole_window_lane():
    """The edge scene's point light gives some receiver kf < 1.2, so the
    capped soft launch's keep-all rule is exercised."""
    kf = torch.cat([a[5].reshape(-1)[~(a[4].reshape(-1) <= 0)]
                    for k, a, _ in _edge_calls(3) if k == "trace_rays"])
    assert bool((kf < 1.2).any())


@pytest.mark.parametrize("name", AO_FIX_CASES)
def test_host_crowd_ao_fix_equals_plain(on_host, name):
    args = _ao_fix_args(name)
    assert args[4].numel() % 32      # the last warp is ragged
    ref = rt.ao_fix_reference(*args)
    masks = masks_of("ao_fix", args)
    assert torch.equal(ref, rt.ao_fix_reference(*args, masks=masks))
    launch, (out,) = KERNELS["ao_fix"][3](*args)
    launch()
    assert torch.equal(out, ref), name
    launch, (out,), prof = rt.crowd_ao_fix_launcher(args[0], args[1],
                                                    args[2:], profile=True)
    launch()
    assert torch.equal(out, ref), name
    assert torch.equal(prof[:, -1] == 0, masks.hit_warps)
