"""The candidate kernel's CUDA source
(surfjax_torch/kernels/csrc/mesh_candidates.cu) built for the CPU behind
the host stand-in of the CUDA runtime (tests/cuda_host.py), launched
through the port's own launcher (mesh_candidates_launcher, with the
library and the stream swapped for the host's), and held against the
plain version, mesh_candidates_reference:

  * (cand, counts) bitwise on every mesh_candidates call of c4 in the
    `config` mode at 64x48 with tile_rows 8 (the primary and the shadow
    call), of the mesh + SDF scene and of the two-mesh scene; on c4's
    primary call cut to two tiles: with a tile whose lanes all miss the
    grid box (count 0), that case with K = 8 (a count above K, the slots
    past a count below K holding F - 1), with a triangle count that is not
    a whole number of the kernel's chunks, and with t_max a Python
    float;
  * the plain version's direction sum is a loop over each tile's lanes
    written out in numpy in the kernel's order.
"""

import contextlib
import ctypes
import os
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from surfjax_torch import api  # noqa: E402
from surfjax_torch.config import load_config  # noqa: E402
from surfjax_torch.kernels import _build  # noqa: E402
from surfjax_torch.kernels.mesh_tile import (  # noqa: E402
    MC_THREADS, McArgs, _tile_sum, mesh_candidates_launcher,
    mesh_candidates_reference,
)
from surfjax_torch.tools.kernel_check import capture_calls  # noqa: E402
from surfjax_torch.tools.workload import (  # noqa: E402
    mesh_modes, mesh_soft_ao_scene, reframe, two_mesh_scene,
)

from tests import cuda_host  # noqa: E402
from tests.test_torch_pipeline import CONFIG_DIR  # noqa: E402


def _candidate_calls(scene, cam, st):
    with capture_calls() as calls:
        api.render(scene, cam, st, device="cpu")
    out = [args for name, args in calls if name == "mesh_candidates"]
    assert out
    return out


@pytest.fixture(scope="module")
def calls():
    """label -> mesh_candidates' arguments of every case of CASES."""
    out = {}
    scene, cam, st, _ = load_config(f"{CONFIG_DIR}/c4_mesh.yaml")
    primary, shadow = _candidate_calls(
        scene, reframe(cam, 64, 48),
        mesh_modes(st)["config"].with_(tile_rows=8))
    out["c4 config primary"], out["c4 config shadow"] = primary, shadow
    for name, build in (("mesh_soft_ao", mesh_soft_ao_scene),
                        ("two_meshes", two_mesh_scene)):
        for k, args in enumerate(_candidate_calls(*build(api, 48))):
            out[f"{name} {k}"] = args
    # the primary call's first two tiles, tile 0's rays turned round: from
    # a camera outside the grid box they all leave it
    rows = 2 * primary[6]
    o2, d2 = (tuple(c[:rows] for c in primary[k]) for k in (2, 3))
    away = tuple(torch.cat([-c[:rows // 2], c[rows // 2:]]) for c in d2)
    two = primary[:2] + (o2, d2, primary[4], primary[5][:rows]) + \
        primary[6:]
    out["a tile with no valid lane"] = two[:3] + (away,) + two[4:]
    out["overflow K 8"] = out["a tile with no valid lane"][:7] + (8,)
    out["1000 triangles"] = (two[0], two[1][:1000]) + two[2:]
    out["scalar t_max"] = two[:5] + (1e4,) + two[6:]
    return out


CASES = ["c4 config primary", "c4 config shadow", "mesh_soft_ao 0",
         "mesh_soft_ao 1", "two_meshes 0", "two_meshes 1", "two_meshes 2",
         "two_meshes 3", "overflow K 8", "a tile with no valid lane",
         "1000 triangles", "scalar t_max"]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if cuda_host.gxx() is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    lib = cuda_host.build("mesh_candidates.cu",
                          str(tmp_path_factory.mktemp("candidates_host")))
    lib.mc_candidates.argtypes = [McArgs, ctypes.c_int, ctypes.c_void_p]
    # the launcher passes its tensors' device index: None on the CPU
    return types.SimpleNamespace(
        mc_candidates=lambda a, dev, s: lib.mc_candidates(a, 0, s))


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """mesh_candidates_launcher loads the host library and launches on a
    stand-in stream."""
    monkeypatch.setattr(_build, "load", lambda: host_lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))


def test_python_block_matches_the_source():
    with open(os.path.join(cuda_host.CSRC, "mesh_candidates.cu")) as fh:
        src = fh.read()
    assert int(re.search(r"#define MC_THREADS (\d+)", src).group(1)) == \
        MC_THREADS


def test_cases_cover_what_the_tests_claim(calls):
    assert sorted(calls) == sorted(CASES)
    primary = calls["c4 config primary"]
    F = primary[1].shape[0]
    assert F % MC_THREADS == 0 and 1000 % MC_THREADS != 0
    assert isinstance(calls["c4 config shadow"][5], torch.Tensor)
    _, counts = mesh_candidates_reference(*calls["a tile with no valid "
                                                 "lane"])
    assert counts.tolist()[0] == 0 and counts.tolist()[1] > 8
    cand, counts = mesh_candidates_reference(*calls["overflow K 8"])
    assert counts.tolist()[0] == 0 and counts.tolist()[1] > 8
    assert bool((cand[0] == F - 1).all())


@pytest.mark.parametrize("label", CASES)
def test_host_kernel_equals_plain(calls, on_host, label):
    args = calls[label]
    ref = mesh_candidates_reference(*args)
    launch, out = mesh_candidates_launcher(*args)
    launch()
    assert out[0].shape == ref[0].shape and out[1].shape == ref[1].shape
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def test_direction_sum_is_the_kernels_order(calls):
    """_tile_sum against a loop over each tile's lanes in numpy float32:
    thread k adds lanes k, k + MC_THREADS, ... to +0.0 in turn, each warp
    adds its threads' sums by the butterfly (offsets 16, 8, 4, 2, 1) and
    the block its warps' totals in warp order. On a tile of 3 x 128 lanes
    (not a whole number of blocks) and on c4's tiles of 8 x 128."""
    rng = np.random.default_rng(3)
    cases = [rng.standard_normal((5, 3 * 128)).astype(np.float32),
             calls["c4 config primary"][3][0].numpy().reshape(-1, 8 * 128)]
    for x in cases:
        want = np.zeros(x.shape[0], np.float32)
        for t, lanes in enumerate(x):
            s = np.zeros(MC_THREADS, np.float32)
            for k in range(MC_THREADS):
                for r in range(k, len(lanes), MC_THREADS):
                    s[k] = np.float32(s[k] + lanes[r])
            warps = s.reshape(-1, 32)
            for off in (16, 8, 4, 2, 1):
                warps = (warps + warps[:, np.arange(32) ^ off]).astype(
                    np.float32)
            total = warps[0, 0]
            for w in range(1, warps.shape[0]):
                total = np.float32(total + warps[w, 0])
            want[t] = total
        got = _tile_sum(torch.from_numpy(x)).numpy()
        assert got.tobytes() == want.tobytes()
