"""One SDF smooth union of 65 spheres built left-deep (129 nodes, a tape
the kernels' former 32-node value array refused; its slot rows keep two
values live, as surfjax's post-order does) through the port's kernel
route on the CPU (its plain versions) against surfjax's Pallas path in
interpret mode, as surfjax's own tests run it, under the North-star
tolerances but for rgb (see the test). The interpret mode unrolls the
tape at every SDF evaluation site of its kernel (about 220 s at 16x16),
so this case has a file of its own."""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import surfjax.api as sj_api  # noqa: E402

import surfjax_torch.api as api  # noqa: E402
from surfjax_torch.tools import workload  # noqa: E402

from tests.test_torch_pipeline import gaps  # noqa: E402
from tests.test_torch_scene_limits import sdf_witness  # noqa: E402

SIZE = (16, 16)


def test_smooth_65_left_matches_surfjax_pallas():
    """Hits, ids, depth and normals under the North-star tolerances; rgb
    within 2e-4 (measured 1.27e-4 on 16 of 256 lanes), the bound of
    test_torch_scene_limits' one-object cases. The gap is surfjax's: its
    interpret-mode kernel is compiled by XLA:CPU, which fuses the 64
    nested smooth unions' arithmetic, and the FD normals carry the SDF's
    last-bit differences (normals within 1.8e-4) into the shading (a
    Lambertian copy of the object still moves rgb by 6.3e-5). The witness:
    the object's SDF through the port's tape and through surfjax's run op
    by op (jax.disable_jit) is bitwise the same at 4096 points around it
    (jitted, it differs on 610 of them by up to 2.4e-7)."""
    name = "smooth 65 left"
    sj_scene, sj_cam, sj_st = workload.limit_cases(sj_api, SIZE)[name]
    scene, cam, st = workload.limit_cases(api, SIZE)[name]
    assert len(scene.freeze()[0].ir.objects[0].nodes) == 129
    ref = sj_api.render(sj_scene, sj_cam, sj_st)
    got = api.render(scene, cam, st, device="cpu")
    g = gaps(ref, got)
    assert g["hit_agree"] == 1.0 and g["obj_agree"] == 1.0, g
    assert g["depth_rel_max"] <= 1e-5 and g["normal_max"] < 5e-2, g
    assert g["lanes_normal_gt_1e-3"] <= 8 and g["rgb_max"] <= 2e-4, g
    assert int((got.obj_id == 0).sum()) > 10
    assert sdf_witness(sj_scene, scene)
