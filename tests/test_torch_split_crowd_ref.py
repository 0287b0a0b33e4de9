"""surfjax_torch/configs/crowd_mesh.yaml (crowd_demo's 49 objects and c4's
octasphere) rendered by the port's split path with the crowd on (its
plain versions on the CPU: K1 and K2 with the crowd's member loops, the
mesh kernel, ao_fix) against surfjax's render of the same file (its Pallas
kernels in interpret mode, as its own tests run them), at 64x36.

Hits and object ids are equal everywhere and normals hold the North star
(below 5e-2, at most 8 lanes per 4096 above 1e-3; measured 5.9e-4, none
above 1e-3). Depth (1e-5 relative) and rgb (2e-5) hold it on every lane
but a few (measured: 10 of 2304, depth 1.48e-5 relative at most, rgb
4.2e-4, q99 9.6e-6). On those lanes surfjax's K1 kernel body is compiled
by XLA:CPU even in interpret mode, and its contraction of b*b - c into a
fused multiply-add moves a grazing analytic sphere entry (lane (15, 20):
11.661551 in the kernel, 11.661379 evaluated op by op); so the test
holds the port's plain K1 on exactly those lanes bitwise against
surfjax's own K1 body (trace_core, normals_core, _ao_compute with the
crowd's tables) evaluated op by op under jax.disable_jit, and bounds them
by the crowd rows' 1e-4 x max(1, t) in depth and 1e-3 in rgb. This file
takes about 100 s on one thread, most of it surfjax's compile.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import surfjax.api as sj_api  # noqa: E402
import surfjax.config as sj_config  # noqa: E402
from surfjax.core.camera import Intrinsics as SjIntrinsics  # noqa: E402
from surfjax.kernels import render_tile as sj_rt  # noqa: E402

import surfjax_torch.api as pt_api  # noqa: E402
import surfjax_torch.config as pt_config  # noqa: E402
from surfjax_torch.core.camera import Intrinsics as PtIntrinsics  # noqa
from surfjax_torch.core.camera import camera_ray_dirs_dyn  # noqa: E402
from surfjax_torch.core.scene_compile import params_to_device  # noqa: E402
from surfjax_torch.kernels import render_tile as pt_rt  # noqa: E402
from surfjax_torch.tools import workload  # noqa: E402

from tests.test_torch_pipeline import gaps  # noqa: E402

SIZE = (64, 36)
OFF_LANES_MAX = 0.01   # share of the frame off the North star


def _load(mod, intrinsics):
    scene, cam, st, _ = mod.load_config(workload.CROWD_MESH)
    intr = cam.intrinsics
    fov = 2.0 * float(np.degrees(np.arctan(0.5 * intr.height / intr.fy)))
    cam = dataclasses.replace(cam, intrinsics=intrinsics.from_fov(*SIZE, fov))
    return scene, cam, st.with_(backend="pallas", tile_rows=8)


def _port_k1(scene, cam, st, lanes):
    """The port's plain K1 on the camera rays of the pixels `lanes`
    ((n, 2) rows and columns) -> (o, d, (t, nx, ny, nz, ao))."""
    R = torch.as_tensor(np.asarray(cam.rotation, np.float32).reshape(9))
    rr = torch.as_tensor(lanes[:, 0].astype(np.float32)).reshape(1, -1)
    cc = torch.as_tensor(lanes[:, 1].astype(np.float32)).reshape(1, -1)
    d = camera_ray_dirs_dyn(cam.intrinsics, R, rr, cc)
    o = tuple(torch.full_like(rr, float(x)) for x in cam.position)
    static, params = scene.freeze()
    k1 = pt_rt.render_tile_reference(
        pt_rt.SceneTensors(static, params_to_device(params, "cpu")), st, o,
        d)
    return o, d, tuple(k1[k].numpy() for k in (0, 2, 3, 4, 5))


def _surfjax_k1_op_by_op(scene, st, o, d):
    """surfjax's K1 body (_k1_body's trace_core, normals_core and
    _ao_compute, with the crowd's tables) evaluated op by op, outside the
    Pallas kernel -> (t, nx, ny, nz, ao)."""
    static, params = scene.freeze()
    lp, nparams = (jnp.asarray(params[k])
                   for k in ("leaf_params", "node_params"))
    o, d = (tuple(jnp.asarray(c.numpy()) for c in v) for v in (o, d))
    with jax.disable_jit():
        refs = (sj_rt.crowd_meta(static, st), lp, nparams)
        t, obj, leaf, hit_f, _ = sj_rt.trace_core(
            static, st, lp, nparams, o, d, st.t_min, st.t_max,
            crowd_refs=refs)
        t_sane = jnp.where(hit_f > 0.5, t, 0.0)
        p = tuple(o[k] + t_sane * d[k] for k in range(3))
        n = sj_rt.normals_core(static, st, lp, nparams, p, obj, leaf, d,
                               crowd_refs=refs)
        ao = sj_rt._ao_compute(static, st, lp, nparams, p, n,
                               crowd_refs=refs)
    return tuple(np.asarray(a) for a in (t,) + tuple(n) + (ao,))


def test_crowd_mesh_matches_reference_pallas():
    sj_scene, sj_cam, sj_st = _load(sj_config, SjIntrinsics)
    pt_scene, pt_cam, pt_st = _load(pt_config, PtIntrinsics)
    assert sj_st.vector_objects and pt_st.vector_objects
    ref = sj_api.render(sj_scene, sj_cam, sj_st)
    got = pt_api.render(pt_scene, pt_cam, pt_st, device="cpu")
    g = gaps(ref, got)
    assert g["hit_agree"] == 1.0 and g["obj_agree"] == 1.0, g
    assert g["normal_max"] < 5e-2, g
    assert g["lanes_normal_gt_1e-3"] <= 8 * max(1, SIZE[0] * SIZE[1] // 4096)
    ids = np.unique(np.asarray(got.obj_id))
    assert 49 in ids and int(((ids >= 0) & (ids < 49)).sum()) >= 10

    depth_ref = np.asarray(ref.depth).astype(np.float64)
    depth_rel = np.abs(got.depth.numpy() - depth_ref) / \
        np.maximum(1.0, np.abs(depth_ref))
    rgb_gap = np.abs(got.rgb.numpy() - np.asarray(ref.rgb)).max(axis=-1)
    off = (depth_rel > 1e-5) | (rgb_gap > 2e-5)
    lanes = np.argwhere(off)
    # the North star on every other lane; the crowd rows' bounds on these
    assert len(lanes) <= OFF_LANES_MAX * off.size, len(lanes)
    assert float(depth_rel.max()) <= 1e-4, g
    assert g["rgb_max"] <= 1e-3, g

    if not len(lanes):
        return
    # each lane off the North star: the port's K1 is surfjax's own K1 body
    # op by op, to the bit, and the frame's depth there is K1's t
    o, d, port = _port_k1(pt_scene, pt_cam, pt_st, lanes)
    witness = _surfjax_k1_op_by_op(sj_scene, sj_st, o, d)
    for name, a, b in zip(("t", "nx", "ny", "nz", "ao"), port, witness):
        assert np.array_equal(a.reshape(-1), b.reshape(-1)), name
    depth_off = got.depth.numpy()[off]
    assert np.array_equal(depth_off, port[0].reshape(-1))
