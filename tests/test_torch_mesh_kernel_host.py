"""The mesh kernel's CUDA source (surfjax_torch/kernels/csrc/mesh_tile.cu)
built for the CPU behind the host stand-in of the CUDA runtime
(tests/cuda_host.py), launched through the port's own launcher
(mesh_tile_launcher, with the library and the stream swapped for the
host's), and held against the plain version on the cases of
tests/test_torch_mesh_cull.py (c4 in the `config` mode):

  * the production kernel's outputs equal mesh_tile_reference's bitwise;
  * its profiling instantiation writes the same outputs, votes as
    mesh_warp_masks does, counts per lane the tests of the culled
    mesh_tile_reference(count_tests=True, masks=) and votes on the chunks
    that mesh_tile.mesh_cull_count charges to the bound.
"""

import contextlib
import ctypes
import os
import re
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from surfjax_torch.kernels import _build  # noqa: E402
from surfjax_torch.kernels.mesh_tile import (  # noqa: E402
    MT_WX, MeshTileArgs, MeshTileProf, mesh_cull_count, mesh_tile_launcher,
    mesh_tile_reference, mesh_warp_masks,
)
from surfjax_torch.tools.breakdown import mesh_profile_table  # noqa: E402
from surfjax_torch.tools.kernel_check import flat  # noqa: E402

from tests import cuda_host  # noqa: E402
from tests.test_torch_mesh_cull import CASES, case_calls  # noqa: E402

HOST_CASES = [c for c in CASES if not c.startswith("c4 ao")]


@pytest.fixture(scope="module")
def calls():
    return case_calls(c4_modes=("config",))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if cuda_host.gxx() is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    lib = cuda_host.build("mesh_tile.cu",
                          str(tmp_path_factory.mktemp("mesh_host")))
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    lib.mt_mesh_tile.argtypes = [MeshTileArgs, i32, ptr]
    lib.mt_mesh_tile_profile.argtypes = [MeshTileArgs, MeshTileProf, i32,
                                         ptr]
    # the launcher passes its tensors' device index: None on the CPU
    return types.SimpleNamespace(
        mt_mesh_tile=lambda a, dev, s: lib.mt_mesh_tile(a, 0, s),
        mt_mesh_tile_profile=lambda a, p, dev, s: lib.mt_mesh_tile_profile(
            a, p, 0, s))


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """mesh_tile_launcher loads the host library and launches on a
    stand-in stream."""
    monkeypatch.setattr(_build, "load", lambda: host_lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))


def test_python_warp_matches_the_source():
    """The plain model's warps are the kernel's."""
    with open(os.path.join(cuda_host.CSRC, "mesh_tile.cu")) as fh:
        src = fh.read()
    macros = dict(re.findall(r"#define (MT_[A-Z]+) (\d+)", src))
    assert int(macros["MT_WX"]) == MT_WX
    assert int(macros["MT_THREADS"]) == 2 * 128


def _equal(got, ref):
    return all(torch.equal(a, b) for a, b in zip(flat(got), flat(ref)))


@pytest.mark.parametrize("label", HOST_CASES)
def test_host_kernel_and_profile_equal_plain(calls, on_host, label):
    args = calls[label]
    ref = mesh_tile_reference(*args)
    launch, out = mesh_tile_launcher(*args)
    launch()
    assert _equal(out, ref)
    launch, out, (rec, tests, masks) = mesh_tile_launcher(*args,
                                                          profile=True)
    launch()
    assert _equal(out, ref)
    votes = mesh_warp_masks(*args[:7], args[9])
    assert torch.equal(masks, votes.masks)
    culled = mesh_tile_reference(*args, count_tests=True, masks=votes.masks)
    assert torch.equal(tests, culled[3].to(torch.int32))
    cand = args[1]
    table = mesh_profile_table(rec, tests, args[2], cand.shape[1],
                               args[3][0].numel() // cand.shape[0])
    count = mesh_cull_count(args, votes)
    assert table["vote_chunks"] == count["vote_chunks"]
    assert table["lane_tests"] == count["lane_tests"] == int(tests.sum())
