"""The plain PyTorch twin of KF against surfjax: its cores against
`scene_march_twin`, and the whole fused slice (`render_sequence` with
backend="pallas" on the CPU) against surfjax's `_sequence_jit`, which runs
KF in interpret mode. c3 in both fidelity modes is in
test_torch_kernel_twin_c3.py.

surfjax gates per TPU tile (while-loop early exit over the tile, lax.cond
skips); the twin gates per lane. Every such gate is value-exact, so the
outputs agree up to XLA:CPU's fused arithmetic (multiply-add contraction,
approximate rsqrt) and do not depend on how lanes are batched.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from surfjax.core.camera import camera_ray_dirs_dyn  # noqa: E402
from surfjax.kernels.render_tile import (  # noqa: E402
    scene_march_twin as sj_scene_march_twin,
)
from surfjax.pipeline.frame import render_sequence as sj_rs  # noqa: E402

from surfjax_torch.core.scene_compile import from_reference  # noqa: E402
from surfjax_torch.kernels.render_tile import (  # noqa: E402
    SceneTensors, frame_fused, frame_fused_reference, scene_march_twin,
)
from surfjax_torch.pipeline.frame import render_sequence as pt_rs  # noqa: E402

from tests.test_torch_pipeline import (  # noqa: E402
    JIT_TOL, assert_tight, gaps, load_pair,
)


def _flat_rays(cam, pos):
    intr = cam.intrinsics
    rows = np.repeat(np.arange(intr.height, dtype=np.float32), intr.width)
    cols = np.tile(np.arange(intr.width, dtype=np.float32), intr.height)
    R = jnp.asarray(np.asarray(cam.rotation, np.float32).reshape(9))
    d = camera_ray_dirs_dyn(intr, R, jnp.asarray(rows), jnp.asarray(cols))
    o = tuple(jnp.full(rows.shape, pos[i], jnp.float32) for i in range(3))
    return o, d


def test_cores_match_scene_march_twin():
    """trace_core / normals_core / _ao_compute on c3 against surfjax's
    scene_march_twin, on identical flat rays, with the tolerances of
    tests/test_kernels.py: t within 1e-5, ao within 1e-2, normals below
    5e-2 with at most 8 lanes per 4096 above 1e-3."""
    (sj_scene, sj_cam, sj_st), _, (Rs, ps) = load_pair(
        "c3_sdf", 32, max_steps=128)
    static, params = sj_scene.freeze()
    o, d = _flat_rays(sj_cam, ps[0])
    ref = sj_scene_march_twin(static, sj_st,
                              jnp.asarray(params["leaf_params"]),
                              jnp.asarray(params["node_params"]), o, d)
    pstatic, pparams = from_reference(static, params, device="cpu")
    ot = tuple(torch.from_numpy(np.array(c)) for c in o)
    dt = tuple(torch.from_numpy(np.array(c)) for c in d)
    got = scene_march_twin(pstatic, sj_st, pparams["leaf_params"],
                           pparams["node_params"], ot, dt)
    t_r, obj_r, n_r, ao_r, hit_r = (np.asarray(a) if not isinstance(a, tuple)
                                    else a for a in ref)
    t_g, obj_g, n_g, ao_g, hit_g, _ = got
    np.testing.assert_array_equal(hit_g.numpy(), hit_r)
    np.testing.assert_array_equal(obj_g.numpy(), obj_r)
    np.testing.assert_allclose(t_g.numpy(), t_r, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ao_g.numpy(), ao_r, rtol=0, atol=1e-2)
    for a, b in zip(n_g, n_r):
        dn = np.abs(a.numpy() - np.asarray(b))
        assert dn.max() < 5e-2, dn.max()
        assert (dn > 1e-3).sum() <= 8, (dn > 1e-3).sum()
    assert hit_r.mean() > 0.3 and (ao_r < 0.999).any()


@pytest.mark.parametrize("name", ["c1_sphere", "c2_csg"])
def test_fused_slice_matches_kf(name):
    """The whole slice on analytic scenes (c2: CSG, a directional light and
    hard shadows) against KF in interpret mode. Same measured XLA:CPU gap
    as the eager pipeline (test_torch_pipeline.JIT_TOL): c1 rgb 4.0e-5,
    c2 depth 4.8e-6 relative; hit and obj_id equal on every lane."""
    (sj_scene, sj_cam, sj_st), (pt_scene, pt_cam, pt_st), poses = \
        load_pair(name, 32, backend="pallas", tile_rows=8)
    ref = sj_rs(sj_scene, sj_cam, poses, sj_st)
    got = pt_rs(pt_scene, pt_cam, poses, pt_st, device="cpu")
    assert_tight(gaps(ref, got), n_lanes=2 * 32 * 32, **JIT_TOL)


def test_twin_is_independent_of_lane_grouping():
    """Per-lane gating: a lane's result does not depend on which lanes
    share its batch. Two frames rendered together equal each rendered
    alone, and a shuffled ray batch through the cores equals the shuffle
    of the unshuffled result, bitwise (c3, both fidelity modes' gates:
    march exits, bulb escapes, FD-normal and AO far-gate skips)."""
    _, (scene, cam, st), (Rs, ps) = load_pair("c3_sdf", 16)
    static, params = scene.freeze()
    scene_t = SceneTensors(static, {k: torch.from_numpy(v)
                                    for k, v in params.items()})
    rows = torch.from_numpy(np.concatenate([Rs, ps], axis=1))
    both = frame_fused_reference(scene_t, st, cam.intrinsics, rows)
    for f in range(2):
        alone = frame_fused_reference(scene_t, st, cam.intrinsics,
                                      rows[f:f + 1])
        for a, b in zip(both, alone):
            assert torch.equal(a[f:f + 1], b)

    (sj_scene, sj_cam, _), _, _ = load_pair("c3_sdf", 16)
    o, d = _flat_rays(sj_cam, ps[0])
    ot = [torch.from_numpy(np.array(c)) for c in o]
    dt = [torch.from_numpy(np.array(c)) for c in d]
    perm = torch.from_numpy(np.random.default_rng(9).permutation(len(ot[0])))
    lp, npar = scene_t.params["leaf_params"], scene_t.params["node_params"]
    plain = scene_march_twin(static, st, lp, npar, tuple(ot), tuple(dt))
    shuf = scene_march_twin(static, st, lp, npar,
                            tuple(c[perm] for c in ot),
                            tuple(c[perm] for c in dt))
    for a, b in zip(plain, shuf):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x[perm], y)


def test_frame_fused_cpu_runs_the_twin_without_counting():
    """On CPU tensors the wrapper runs the plain twin: the same tensors as
    frame_fused_reference, and no kernel launch is counted."""
    _, (scene, cam, st), (Rs, ps) = load_pair("c2_csg", 8, n_frames=1)
    static, params = scene.freeze()
    scene_t = SceneTensors(static, {k: torch.from_numpy(v)
                                    for k, v in params.items()})
    rows = torch.from_numpy(np.concatenate([Rs, ps], axis=1))
    before = frame_fused.launches
    out = frame_fused(scene_t, st, cam.intrinsics, rows)
    ref = frame_fused_reference(scene_t, st, cam.intrinsics, rows)
    assert frame_fused.launches == before
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert all(a.shape == (1, 8, 8) for a in out)
