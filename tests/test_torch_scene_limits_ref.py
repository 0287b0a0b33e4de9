"""The many-object scenes of workload.limit_cases (65 to 200 objects, more
than 64 of them outside the crowd) through the port's kernel route on the
CPU (its plain versions): the whole frame against surfjax's Pallas path in
interpret mode, under the North-star tolerances, and the crowd beside 71
objects against the port's crowd off.

surfjax's Pallas path unrolls every object outside its crowd, so in
interpret mode it takes minutes on such a scene (567 s for `120+8` at
16x16, 309 s for `crowd 120+8+70`). With vector_objects its crowd takes
the single spheres and boxes through one loop with bitwise-equal geometry
(surfjax's own contract, held by its tools/crowd_parity.py), which
compiles in seconds. So the reference frame renders with the crowd on
while the port renders each object on its own (the crowd off: all of them
outside the crowd, the case the kernels' former bounds refused). surfjax's
per-object code itself holds every kernel call of these cases, the crowd
cases included, bitwise: tests/test_torch_scene_limits_bodies.py runs
surfjax's kernel bodies op by op on the port's calls. The crowd case
here is an extra check: the port's crowd on against its crowd off, depth,
normal, hit and object id bitwise, rgb within 2 ulp, as the port's crowd
tests hold the crowd."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import surfjax.api as sj_api  # noqa: E402

import surfjax_torch.api as api  # noqa: E402
from surfjax_torch.kernels import render_tile as rt  # noqa: E402
from surfjax_torch.tools import workload  # noqa: E402

from tests.test_torch_pipeline import assert_tight, gaps  # noqa: E402

SIZE = (16, 16)


@pytest.mark.parametrize("name", ["64 spheres", "120+8", "120+8 soft",
                                  "mesh + 70"])
def test_many_objects_match_surfjax_pallas(name):
    sj_scene, sj_cam, sj_st = workload.limit_cases(sj_api, SIZE)[name]
    scene, cam, st = workload.limit_cases(api, SIZE)[name]
    static = scene.freeze()[0]
    crowd, ana, sdf = rt.split_crowd(static, st)
    assert crowd is None and len(ana) + len(sdf) > 64
    ref = sj_api.render(sj_scene, sj_cam, sj_st.with_(vector_objects=True))
    got = api.render(scene, cam, st, device="cpu")
    assert_tight(gaps(ref, got), n_lanes=SIZE[0] * SIZE[1])
    assert len(torch.unique(got.obj_id)) > 20, name


def test_crowd_beside_71_objects_equals_crowd_off():
    scene, cam, st = workload.limit_cases(api, SIZE)["crowd 120+8+70"]
    static = scene.freeze()[0]
    crowd, ana, sdf = rt.split_crowd(static, st)
    assert len(crowd.members) == 128 and len(ana) + len(sdf) == 71
    on = api.render(scene, cam, st, device="cpu")
    off = api.render(scene, cam, st.with_(vector_objects=False),
                     device="cpu")
    for name in ("depth", "normal", "hit", "obj_id"):
        assert torch.equal(getattr(on, name), getattr(off, name)), name
    ulp = np.abs(on.rgb.numpy().view(np.int32).astype(np.int64)
                 - off.rgb.numpy().view(np.int32).astype(np.int64))
    assert int(ulp.max()) <= 2
    ids = torch.unique(on.obj_id)
    assert int((ids >= 128).sum()) > 5 and int((ids < 128).sum()) > 5
