"""The port's eager pipeline (backend="jnp") against surfjax's jnp path.

Two comparisons:
  * op by op (`jax.disable_jit()`): each JAX op rounds on its own, exactly
    as each torch op does, and the port follows surfjax's association, so
    the two must agree to the bit;
  * as surfjax's own tests run it (jit): XLA:CPU fuses the frame, contracts
    multiply-adds and uses an approximate rsqrt, so a measured gap remains;
    each tolerance below states it (ROADMAP queue 3 records them).

Also holds the helpers that the kernel-twin tests share.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import surfjax.config as sj_config  # noqa: E402
from surfjax.core.camera import Intrinsics as SjIntrinsics  # noqa: E402
from surfjax.pipeline.frame import frame_step  # noqa: E402
from surfjax.pipeline.frame import render_sequence as sj_rs  # noqa: E402

import surfjax_torch.config as pt_config  # noqa: E402
from surfjax_torch.core.camera import Intrinsics as PtIntrinsics  # noqa: E402
from surfjax_torch.pipeline.frame import render_sequence as pt_rs  # noqa: E402

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "configs")


def load_pair(name, size, n_frames=2, seed=0, **overrides):
    """The same config through both loaders, reframed to size x size at the
    config's fov, plus n_frames poses jittered with numpy from `seed`.
    -> (surfjax (scene, cam, settings), port (scene, cam, settings),
        (R_flats, positions))."""
    path = os.path.join(CONFIG_DIR, name + ".yaml")
    out = []
    for mod, Intr in ((sj_config, SjIntrinsics), (pt_config, PtIntrinsics)):
        scene, cam, st, _ = mod.load_config(path)
        intr = cam.intrinsics
        fov = 2.0 * float(np.degrees(np.arctan(0.5 * intr.height / intr.fy)))
        cam = dataclasses.replace(cam,
                                  intrinsics=Intr.from_fov(size, size, fov))
        out.append((scene, cam, st.with_(**overrides)))
    cam = out[0][1]
    R = np.asarray(cam.rotation, np.float32).reshape(1, 9)
    jitter = np.random.default_rng(seed).normal(0.0, 1e-3, (n_frames, 3))
    pos = (np.asarray(cam.position, np.float32)[None, :]
           + jitter.astype(np.float32))
    return out[0], out[1], (np.repeat(R, n_frames, axis=0), pos)


def gaps(ref, got):
    """FrameBuffers (numpy or tensors) -> dict of comparison numbers."""
    ref = [np.asarray(a) for a in ref]
    got = [a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
           for a in got]
    rgb, depth, normal, hit, obj = (
        np.abs(g.astype(np.float64) - r) for g, r in zip(got, ref))
    return {
        "hit_agree": float((got[3] == ref[3]).mean()),
        "obj_agree": float((got[4] == ref[4]).mean()),
        "depth_rel_max": float((depth / np.maximum(1.0, np.abs(ref[1])))
                               .max()),
        "rgb_max": float(rgb.max()),
        "rgb_q99": float(np.quantile(rgb, 0.99)),
        "normal_max": float(normal.max()),
        "lanes_normal_gt_1e-3": int((normal.max(axis=-1) > 1e-3).sum()),
        "lanes_rgb_gt_1e-3": int((rgb.max(axis=-1) > 1e-3).sum()),
        "bitwise": all(np.array_equal(g, r) for g, r in zip(got, ref)),
    }


def assert_tight(g, rgb=2e-5, depth_rel=1e-5, normal_max=5e-2,
                 normal_lanes_per_4096=8, n_lanes=4096):
    """The North-star tight set: hit and obj_id equal, depth within
    depth_rel*max(1, depth), rgb within `rgb`, normals below 5e-2 with at
    most 8 lanes per 4096 above 1e-3."""
    assert g["hit_agree"] == 1.0 and g["obj_agree"] == 1.0, g
    assert g["depth_rel_max"] <= depth_rel, g
    assert g["rgb_max"] <= rgb, g
    assert g["normal_max"] < normal_max, g
    assert g["lanes_normal_gt_1e-3"] <= \
        normal_lanes_per_4096 * max(1, n_lanes // 4096), g


@pytest.mark.parametrize("name", ["c1_sphere", "c2_csg", "c5_anim"])
def test_eager_pipeline_bitwise_op_by_op(name):
    """With XLA's fusion out of the way, the eager port is bitwise."""
    (sj_scene, sj_cam, sj_st), (pt_scene, pt_cam, pt_st), (Rs, ps) = \
        load_pair(name, 16, n_frames=1)
    static, params = sj_scene.freeze()
    with jax.disable_jit():
        ref = frame_step(static, sj_cam.intrinsics, sj_st,
                         {k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(Rs[0]), jnp.asarray(ps[0]))
    got = pt_rs(pt_scene, pt_cam, (Rs, ps), pt_st, device="cpu")
    g = gaps(ref, [a[0] for a in got])
    assert g["bitwise"], g


@pytest.mark.parametrize("name", ["c1_sphere", "c2_csg", "c5_anim"])
def test_eager_pipeline_bitwise_op_by_op_at_jit_size(name):
    """The same at the size the jit gaps below were measured at (32x32, 2
    frames): the port is bitwise equal to surfjax with jit disabled on
    every frame, so those gaps are XLA:CPU's fusion of surfjax's own
    path, not the port's."""
    (sj_scene, sj_cam, sj_st), (pt_scene, pt_cam, pt_st), (Rs, ps) = \
        load_pair(name, 32, n_frames=2)
    static, params = sj_scene.freeze()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    got = pt_rs(pt_scene, pt_cam, (Rs, ps), pt_st, device="cpu")
    for f in range(len(ps)):
        with jax.disable_jit():
            ref = frame_step(static, sj_cam.intrinsics, sj_st, params,
                             jnp.asarray(Rs[f]), jnp.asarray(ps[f]))
        g = gaps(ref, [a[f] for a in got])
        assert g["bitwise"], (f, g)


# Measured against surfjax's jit-compiled jnp path at 32x32 x 2 frames
# (gap = XLA:CPU multiply-add contraction and approximate rsqrt): c1 rgb
# 4.0e-5, depth 3.4e-5 relative at grazing silhouette rays, normals 7.9e-5;
# c2 rgb 7.9e-6, depth 4.8e-6 relative (grazing far-floor hits at t~370);
# c5 rgb 9.9e-5, normals 1.4e-4 (FD normals divide a t shift by
# normal_eps). Tolerances: twice the largest of these.
JIT_TOL = dict(rgb=2e-4, depth_rel=1e-4, normal_max=5e-4)


@pytest.mark.parametrize("name", ["c1_sphere", "c2_csg", "c5_anim"])
def test_eager_pipeline_matches_jit_jnp_path(name):
    (sj_scene, sj_cam, sj_st), (pt_scene, pt_cam, pt_st), poses = \
        load_pair(name, 32)
    ref = sj_rs(sj_scene, sj_cam, poses, sj_st)
    got = pt_rs(pt_scene, pt_cam, poses, pt_st, device="cpu")
    g = gaps(ref, got)
    assert_tight(g, n_lanes=2 * 32 * 32, **JIT_TOL)


def test_eager_pipeline_c3_carve_out():
    """c3 (Mandelbulb, soft shadows, AO) against the jit jnp path. Measured
    at 32x32 x 2 frames: hits and obj_id agree on every lane, depth within
    3.8e-6, rgb q99 2.4e-5 but max 3.8e-4, so the rgb part of the tight
    set does not hold and the c3 carve-out is asserted: more than 99.5% of
    hits agree and the rgb difference has q99 below 5e-2."""
    (sj_scene, sj_cam, sj_st), (pt_scene, pt_cam, pt_st), poses = \
        load_pair("c3_sdf", 32)
    ref = sj_rs(sj_scene, sj_cam, poses, sj_st)
    got = pt_rs(pt_scene, pt_cam, poses, pt_st, device="cpu")
    g = gaps(ref, got)
    assert g["hit_agree"] > 0.995, g
    assert g["rgb_q99"] < 5e-2, g
    assert float(np.asarray(ref.hit).mean()) > 0.3   # the scene is in view
