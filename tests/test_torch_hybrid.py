"""The port's kernel-forward differentiable render (diff/hybrid.py):
counterparts of the five cases of tests/test_hybrid.py inside the port, and
the same losses and gradients against surfjax's hybrid, whose Pallas
kernels run in interpret mode here. The port runs its kernels' plain
versions (CPU tensors).

Measured (48x48 c5 scene, tile_rows 8, pose probe): the port's hybrid
against surfjax's hybrid: loss 3.4e-7 relative, gradient relative L2
1.05e-4, cosine 1 - 4e-9; the port's hybrid against the port's eager
pipeline: 9.3e-6, 2.54e-2, 0.99981, which is also what surfjax shows between
its own two backends (1.0e-5, 2.55e-2, 0.99981), so the bounds of
tests/test_hybrid.py (2e-3, 0.1, 0.995) apply there unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import surfjax.api as sj_api  # noqa: E402
from surfjax.core.camera import flat_camera_rays as sj_flat_rays  # noqa: E402
from surfjax.core.types import RenderSettings as SjSettings  # noqa: E402

import surfjax_torch.api as pt_api  # noqa: E402
from surfjax_torch.core.camera import flat_camera_rays  # noqa: E402
from surfjax_torch.core.scene_compile import from_reference  # noqa: E402
from surfjax_torch.diff import fit as pt_fit  # noqa: E402
from surfjax_torch.diff.hybrid import _splice, render_rays_hybrid  # noqa: E402
from surfjax_torch.kernels import render_tile as pt_rt  # noqa: E402
from surfjax_torch.pipeline.frame import _pose_tensors  # noqa: E402

from tests.scenes import config5_anim_scene  # noqa: E402

F32 = np.float32


class Frozen:
    """A scene frozen by surfjax, as the port's entry points take one:
    freeze() -> (the port's static, surfjax's numpy tables), so that both
    packages render the very same parameters."""

    def __init__(self, scene):
        self.static, self.params = scene.freeze()

    def freeze(self):
        return (from_reference(self.static, self.params, device="cpu")[0],
                self.params)


def port_settings(sj_st, **over):
    return pt_api.RenderSettings(**dataclasses.asdict(sj_st)).with_(**over)


def _port_rays(scene, cam):
    pstatic, pparams = from_reference(*scene.freeze(), device="cpu")
    R, t = _pose_tensors(cam, "cpu")
    o, d, _ = flat_camera_rays(cam.intrinsics, R, t)
    return pstatic, pparams, o, d


def grad_gap(g, ref):
    a = np.concatenate([g["w"], g["dt"]]).astype(np.float64)
    b = np.concatenate([ref["w"], ref["dt"]]).astype(np.float64)
    rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)
    cos = float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))
    return rel, cos


def test_hybrid_value_bitwise_vs_pallas():
    """The hybrid's forward equals the port's render_rays_pallas to the
    bit, with and without a graph, AO and soft shadows included."""
    scene, cam, sj_st = config5_anim_scene(48)
    pstatic, pparams, o, d = _port_rays(scene, cam)
    for over in ({}, dict(ao=True, ao_samples=5, soft_shadows=True)):
        st = port_settings(sj_st, backend="pallas", tile_rows=8, **over)
        with torch.no_grad():
            fb_p = pt_rt.render_rays_pallas(pstatic, st, pparams, o, d)
        lp = pparams["leaf_params"].clone().requires_grad_(True)
        fb_h = render_rays_hybrid(pstatic, st,
                                  dict(pparams, leaf_params=lp), o, d)
        assert fb_h.rgb.requires_grad and fb_h.depth.requires_grad
        for field in ("hit", "depth", "rgb", "normal", "obj_id"):
            assert torch.equal(getattr(fb_h, field).detach(),
                               getattr(fb_p, field)), (over, field)
        assert 0.2 < float(fb_p.hit.mean()) < 1.0


def test_splice_keeps_the_value_and_takes_the_other_gradient():
    value = torch.tensor([1.5, -2.25, 0.1])
    x = torch.tensor([0.3, 0.7, -0.2], requires_grad=True)
    out = _splice(x * x, value)
    assert torch.equal(out.detach(), value)
    g, = torch.autograd.grad(out.sum(), x)
    assert torch.equal(g, 2 * x.detach())


def _sphere_depth_case(api):
    scene = api.Scene()
    scene.add(api.Sphere(center=(0.0, 0.0, 3.0), radius=0.8),
              api.Material.lambert((0.6, 0.4, 0.3)), engine="sdf")
    scene.add_light(api.PointLight(position=(2.0, 3.0, -1.0)))
    cam = api.Camera.pinhole(24, 24, 45.0, position=(0.0, 0.0, 0.0),
                             target=(0.0, 0.0, 3.0))
    return scene, cam


def test_hybrid_ift_matches_finite_differences():
    """Central finite differences of a smooth observable (mean hit depth
    over the central 8x8 pixels of one SDF sphere) against the hybrid's
    gradient to the sphere's leaf parameters, and that gradient against
    jax.grad of surfjax's hybrid."""
    from surfjax.diff.hybrid import render_rays_hybrid as sj_hybrid
    scene, cam = _sphere_depth_case(sj_api)
    sj_st = SjSettings(backend="pallas", tile_rows=8, shadows=False)
    st = port_settings(sj_st)
    pstatic, pparams, o, d = _port_rays(scene, cam)
    w = np.zeros((24, 24), F32)
    w[8:16, 8:16] = 1.0
    w = (w.reshape(-1) / w.sum()).astype(F32)
    w_t = torch.from_numpy(w)

    def depth_loss(lp):
        fb = render_rays_hybrid(pstatic, st, dict(pparams, leaf_params=lp),
                                o, d)
        return (fb.depth * w_t).sum()

    lp0 = pparams["leaf_params"]
    lp = lp0.clone().requires_grad_(True)
    g, = torch.autograd.grad(depth_loss(lp), lp)
    v = np.zeros(tuple(lp0.shape), F32)
    v[0, :4] = np.random.default_rng(3).standard_normal(4).astype(F32)
    v = torch.from_numpy(v / np.linalg.norm(v))
    h = 1e-3
    with torch.no_grad():
        fd = (float(depth_loss(lp0 + h * v))
              - float(depth_loss(lp0 - h * v))) / (2 * h)
    an = float((g * v).sum())
    assert abs(fd - an) <= 2e-3 * max(abs(fd), abs(an), 1e-6), (fd, an)

    static, params = scene.freeze()
    jparams = {k: jnp.asarray(v_) for k, v_ in params.items()}
    R = jnp.asarray(np.asarray(cam.rotation, F32).reshape(9))
    o_j, d_j, _ = sj_flat_rays(cam.intrinsics, R,
                               jnp.asarray(np.asarray(cam.position, F32)))
    g_j = jax.jit(jax.grad(lambda lp_: jnp.sum(sj_hybrid(
        static, sj_st, dict(jparams, leaf_params=lp_), o_j, d_j).depth
        * jnp.asarray(w))))(jparams["leaf_params"])
    gap = np.abs(g.numpy() - np.asarray(g_j)).max() / np.abs(g_j).max()
    assert gap < 1e-6, gap      # measured 1.1e-7 of the largest entry


def test_hybrid_pose_grads_match_jnp_pipeline():
    """The hybrid's pose loss and gradient against the eager pipeline's
    inside the port (the marches stop at different points inside the hit
    band: the bounds of tests/test_hybrid.py), and against surfjax's
    hybrid on the same frozen scene, at about twice the measured gap
    (module docstring): loss within 1e-6 relative, gradient relative L2
    < 2.5e-4, cosine > 0.9999999; what is left is XLA:CPU's fused
    arithmetic inside the float32 finite-difference normals."""
    from surfjax.diff.fit import pose_loss_and_grad as sj_loss_and_grad
    scene, cam, sj_st = config5_anim_scene(48)
    st = port_settings(sj_st, tile_rows=8)
    l_h, g_h = pt_fit.pose_loss_and_grad(
        Frozen(scene), cam, st.with_(backend="pallas"), device="cpu")
    l_j, g_j = pt_fit.pose_loss_and_grad(
        Frozen(scene), cam, st.with_(backend="jnp"), device="cpu")
    assert abs(l_h - l_j) / max(abs(l_j), 1e-12) < 2e-3
    rel, cos = grad_gap(g_h, g_j)
    assert rel < 0.1, rel
    assert cos > 0.995, cos

    l_s, g_s = sj_loss_and_grad(scene, cam,
                                sj_st.with_(backend="pallas", tile_rows=8))
    assert abs(l_h - l_s) / max(abs(l_s), 1e-12) < 1e-6, (l_h, l_s)
    rel, cos = grad_gap(g_h, g_s)
    assert rel < 2.5e-4, rel
    assert cos > 0.9999999, cos


def test_fit_pose_converges_with_hybrid_forward():
    scene, cam, sj_st = config5_anim_scene(32)
    st = port_settings(sj_st, backend="pallas", tile_rows=8)
    frozen = Frozen(scene)
    target = pt_api.render(frozen, cam, st, device="cpu").rgb
    init = (F32([0.03, -0.02, 0.01]), F32([0.02, 0.01, -0.02]))
    before = [w.launches for w in (pt_rt.render_tile, pt_rt.trace_rays)]
    _, _, losses = pt_fit.fit_pose(frozen, cam, target, steps=12, lr=3e-2,
                                   settings=st, init=init, device="cpu")
    assert losses[-1] < 0.3 * losses[0], losses
    # CPU tensors run the plain versions: no kernel launch is counted
    assert [w.launches for w in (pt_rt.render_tile, pt_rt.trace_rays)] \
        == before


def test_hybrid_rejects_crowd():
    scene = pt_api.Scene()
    for i in range(30):
        scene.add(pt_api.Sphere(center=(i * 0.2 - 3.0, 0.0, 4.0),
                                radius=0.08),
                  pt_api.Material.lambert((0.5, 0.5, 0.5)), engine="sdf")
    scene.add_light(pt_api.PointLight(position=(0.0, 4.0, 0.0)))
    cam = pt_api.Camera.pinhole(16, 16, 45.0)
    static, params = scene.freeze()
    from surfjax_torch.core.scene_compile import params_to_device
    params = params_to_device(params, "cpu")
    R, t = _pose_tensors(cam, "cpu")
    o, d, _ = flat_camera_rays(cam.intrinsics, R, t)
    st = pt_api.RenderSettings(backend="pallas", vector_objects=True,
                               tile_rows=8)
    with pytest.raises(NotImplementedError, match="crowd"):
        render_rays_hybrid(static, st, params, o, d)
    fb = render_rays_hybrid(static, st.with_(vector_objects=False), params,
                            o, d)
    assert tuple(fb.rgb.shape) == (256, 3)
