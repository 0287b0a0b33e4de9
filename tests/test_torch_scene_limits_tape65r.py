"""One SDF smooth union of 65 spheres built right-deep (129 nodes, a tape
the kernels' former 32-node value array refused; surfjax's left-first
post-order keeps all 65 leaves of this chain live, its slot rows two)
through the port's kernel route on the CPU (its plain versions) against
surfjax's Pallas path in interpret mode, as surfjax's own tests run it,
under the North-star tolerances. The interpret mode unrolls the tape at
every SDF evaluation site of its kernel (about 220 s at 16x16), so this
case has a file of its own."""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import surfjax.api as sj_api  # noqa: E402

import surfjax_torch.api as api  # noqa: E402
from surfjax_torch.tools import workload  # noqa: E402

from tests.test_torch_pipeline import assert_tight, gaps  # noqa: E402

SIZE = (16, 16)


def test_smooth_65_right_matches_surfjax_pallas():
    name = "smooth 65 right"
    sj_scene, sj_cam, sj_st = workload.limit_cases(sj_api, SIZE)[name]
    scene, cam, st = workload.limit_cases(api, SIZE)[name]
    assert len(scene.freeze()[0].ir.objects[0].nodes) == 129
    ref = sj_api.render(sj_scene, sj_cam, sj_st)
    got = api.render(scene, cam, st, device="cpu")
    assert_tight(gaps(ref, got), n_lanes=SIZE[0] * SIZE[1])
    assert int((got.obj_id == 0).sum()) > 10
