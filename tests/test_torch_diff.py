"""The port's differentiable sphere trace and eager render (counterparts of
tests/test_diff.py), each also against `jax.grad` of surfjax on the same
inputs.

Both packages run the same eager march. Run op by op (jit disabled)
surfjax's gradients agree with the port's within 1e-4 relative; under jit
XLA:CPU contracts multiply-adds and approximates rsqrt, which moves the
float32 finite-difference normals, and surfjax's own jitted gradient then
differs from its op-by-op one by 2.3e-4 of the largest entry on the full
render (measured; the port's differs from the jitted one by the same
2.3e-4), so that comparison is held to 5e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import surfjax.api as sj_api  # noqa: E402
from surfjax.core.types import RenderSettings as SjSettings  # noqa: E402
from surfjax.engines import sdf as sj_sdf  # noqa: E402
from surfjax.pipeline.frame import render_rays as sj_render_rays  # noqa: E402

import surfjax_torch.api as pt_api  # noqa: E402
from surfjax_torch.core.scene_compile import from_reference  # noqa: E402
from surfjax_torch.engines import sdf as pt_sdf  # noqa: E402
from surfjax_torch.pipeline.frame import render_rays  # noqa: E402

F32 = np.float32
MARCH = (1e-3, 1e4, 256, 1e-5)     # t_min, t_max, max_steps, hit_eps


def _sphere_pair():
    """One SDF sphere frozen by surfjax -> (surfjax ObjectIR, jnp params,
    port ObjectIR, port params)."""
    s = sj_api.Scene().add(sj_api.Sphere((0.0, 0.0, 5.0), 1.0),
                           sj_api.Material.lambert(), engine="sdf")
    static, params = s.freeze()
    pstatic, pparams = from_reference(static, params, device="cpu")
    return (static.ir.objects[0], {k: jnp.asarray(v)
                                   for k, v in params.items()},
            pstatic.ir.objects[0], pparams)


def _with_radius(lp, r):
    """leaf_params with entry [0, 3] replaced by the 0-d tensor r."""
    pick = torch.zeros_like(lp)
    pick[0, 3] = 1.0
    return lp * (1.0 - pick) + pick * r


def _port_t_sum(oir, pparams, o, d, r):
    t, hit = pt_sdf.sphere_trace(oir, _with_radius(pparams["leaf_params"], r),
                                 pparams["node_params"], o, d, *MARCH)
    return torch.where(hit, t, 0.0).sum()


def _jax_t_sum(oir, params, o, d, r):
    lp = params["leaf_params"].at[0, 3].set(r)
    t, hit = sj_sdf.sphere_trace(oir, lp, params["node_params"], o, d, *MARCH)
    return jnp.sum(jnp.where(hit, t, 0.0))


def _rays(ang):
    n = len(ang)
    return ([np.zeros(n, F32)] * 3,
            [np.sin(ang).astype(F32), np.zeros(n, F32),
             np.cos(ang).astype(F32)])


def test_ift_gradient_head_on():
    """A ray straight at the centre: t = dist - r, so dt/dr is -1."""
    sj_oir, params, pt_oir, pparams = _sphere_pair()
    o, d = _rays(np.zeros(1, F32))
    r = torch.tensor(1.0, requires_grad=True)
    total = _port_t_sum(pt_oir, pparams, tuple(map(torch.from_numpy, o)),
                        tuple(map(torch.from_numpy, d)), r)
    g, = torch.autograd.grad(total, r)
    np.testing.assert_allclose(float(g), -1.0, atol=1e-3)
    g_j = jax.grad(lambda r: _jax_t_sum(
        sj_oir, params, tuple(map(jnp.asarray, o)),
        tuple(map(jnp.asarray, d)), r))(jnp.float32(1.0))
    np.testing.assert_allclose(float(g), float(g_j), rtol=1e-4)


def test_ift_gradient_matches_finite_difference():
    """The IFT adjoint against central finite differences on oblique rays,
    and against surfjax's adjoint."""
    sj_oir, params, pt_oir, pparams = _sphere_pair()
    o, d = _rays(np.linspace(-0.12, 0.12, 8).astype(F32))
    o_t = tuple(map(torch.from_numpy, o))
    d_t = tuple(map(torch.from_numpy, d))
    r = torch.tensor(1.0, requires_grad=True)
    g, = torch.autograd.grad(_port_t_sum(pt_oir, pparams, o_t, d_t, r), r)
    eps = 1e-3
    with torch.no_grad():
        fd = (float(_port_t_sum(pt_oir, pparams, o_t, d_t,
                                torch.tensor(1.0 + eps)))
              - float(_port_t_sum(pt_oir, pparams, o_t, d_t,
                                  torch.tensor(1.0 - eps)))) / (2 * eps)
    np.testing.assert_allclose(float(g), fd, rtol=0.05)
    g_j = jax.grad(lambda r: _jax_t_sum(
        sj_oir, params, tuple(map(jnp.asarray, o)),
        tuple(map(jnp.asarray, d)), r))(jnp.float32(1.0))
    np.testing.assert_allclose(float(g), float(g_j), rtol=1e-4)


def test_ift_gradient_reaches_rays_and_skips_misses():
    """Gradients to o and d follow dt/do = -grad f / (grad f . d) and
    dt/dd = t dt/do; a lane that misses gets none; t_max gets none."""
    _, _, pt_oir, pparams = _sphere_pair()
    ang = np.asarray([0.0, 0.1, 1.2], F32)           # the last one misses
    o, d = _rays(ang)
    o_t = tuple(torch.from_numpy(c).requires_grad_(True) for c in o)
    d_t = tuple(torch.from_numpy(c).requires_grad_(True) for c in d)
    t_max = torch.full((3,), 1e4, requires_grad=True)
    t, hit = pt_sdf.sphere_trace(
        pt_oir, pparams["leaf_params"], pparams["node_params"], o_t, d_t,
        1e-3, t_max, 256, 1e-5)
    assert hit.tolist() == [True, True, False]
    grads = torch.autograd.grad(torch.where(hit, t, 0.0).sum(),
                                o_t + d_t + (t_max,), allow_unused=True)
    g_o, g_d, g_tmax = grads[:3], grads[3:6], grads[6]
    assert g_tmax is None or not bool(g_tmax.any())
    # head-on lane: moving the origin along +z shortens t one for one
    np.testing.assert_allclose(float(g_o[2][0]), -1.0, atol=1e-3)
    for k in range(3):
        assert float(g_o[k][2]) == 0.0 and float(g_d[k][2]) == 0.0
        np.testing.assert_allclose(g_d[k][:2].numpy(),
                                   (t[:2] * g_o[k][:2]).detach().numpy(),
                                   rtol=1e-6)


def test_grad_through_full_render():
    """End to end: the gradient of an image loss to the SDF parameters is
    finite and nonzero, and agrees with jax.grad of surfjax's render_rays
    on the same rays."""
    s = sj_api.Scene().add(
        sj_api.smooth_union(sj_api.Sphere((-0.4, -0.1, 3.0), 0.6),
                            sj_api.Sphere((0.5, 0.1, 3.0), 0.45), 0.3),
        sj_api.Material.lambert(), engine="sdf")
    s.add_light(sj_api.PointLight(position=(3.0, 4.0, -1.0)))
    static, params = s.freeze()
    sj_st = SjSettings(shadows=True, max_steps=64)
    pt_st = pt_api.RenderSettings(**dataclasses.asdict(sj_st))
    pstatic, pparams = from_reference(static, params, device="cpu")

    n = 32 * 32
    ang = np.random.default_rng(1).uniform(-0.3, 0.3, (2, n)).astype(F32)
    d = [np.sin(ang[0]), np.sin(ang[1]),
         np.sqrt(1 - np.sin(ang[0])**2 - np.sin(ang[1])**2)]
    o = [np.zeros(n, F32)] * 3

    lp = pparams["leaf_params"].clone().requires_grad_(True)
    fb = render_rays(pstatic, pt_st, dict(pparams, leaf_params=lp),
                     tuple(map(torch.from_numpy, o)),
                     tuple(map(torch.from_numpy, d)))
    loss = (fb.rgb * fb.rgb).mean()
    g, = torch.autograd.grad(loss, lp)
    g = g.numpy()
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 1e-6

    jparams = {k: jnp.asarray(v) for k, v in params.items()}

    def jax_loss(lp_):
        fb_ = sj_render_rays(static, sj_st, dict(jparams, leaf_params=lp_),
                             tuple(map(jnp.asarray, o)),
                             tuple(map(jnp.asarray, d)))
        return jnp.mean(fb_.rgb * fb_.rgb)

    l_j, g_j = jax.jit(jax.value_and_grad(jax_loss))(jparams["leaf_params"])
    np.testing.assert_allclose(float(loss.detach()), float(l_j), rtol=1e-5)
    assert np.abs(g - np.asarray(g_j)).max() < 5e-4 * np.abs(g_j).max()
    with jax.disable_jit():
        g_e = np.asarray(jax.grad(jax_loss)(jparams["leaf_params"]))
    assert np.abs(g - g_e).max() < 1e-4 * np.abs(g_e).max()


def test_soft_shadow_visibility_carries_no_gradient():
    """With soft shadows the penumbra march is cut at its inputs and at the
    scene parameters, as in surfjax: the image still has a gradient (through
    the hit, the normal and the shading), and it equals surfjax's."""
    s = sj_api.Scene()
    s.add(sj_api.Sphere((0.0, 0.2, 3.0), 0.5), sj_api.Material.lambert(),
          engine="sdf")
    s.add(sj_api.Plane(normal=(0.0, 1.0, 0.0), offset=-0.5),
          sj_api.Material.lambert(), engine="sdf")
    s.add_light(sj_api.PointLight(position=(1.5, 3.0, 1.5), radius=0.2))
    static, params = s.freeze()
    sj_st = SjSettings(shadows=True, soft_shadows=True, max_steps=96,
                       shadow_steps=24, t_max=20.0)
    pt_st = pt_api.RenderSettings(**dataclasses.asdict(sj_st))
    pstatic, pparams = from_reference(static, params, device="cpu")
    ang = np.random.default_rng(2).uniform(-0.35, 0.35, (2, 256)).astype(F32)
    d = [np.sin(ang[0]), np.sin(ang[1]) - F32(0.1),
         np.sqrt(1 - np.sin(ang[0])**2 - np.sin(ang[1])**2)]
    norm = np.sqrt(d[0]**2 + d[1]**2 + d[2]**2)
    d = [(c / norm).astype(F32) for c in d]
    o = [np.zeros(256, F32)] * 3

    lp = pparams["leaf_params"].clone().requires_grad_(True)
    fb = render_rays(pstatic, pt_st, dict(pparams, leaf_params=lp),
                     tuple(map(torch.from_numpy, o)),
                     tuple(map(torch.from_numpy, d)))
    g, = torch.autograd.grad((fb.rgb * fb.rgb).mean(), lp)
    g = g.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 1e-6

    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    g_j = jax.jit(jax.grad(lambda lp_: jnp.mean(sj_render_rays(
        static, sj_st, dict(jparams, leaf_params=lp_),
        tuple(map(jnp.asarray, o)), tuple(map(jnp.asarray, d))).rgb ** 2)))(
            jparams["leaf_params"])
    gap = np.abs(g - np.asarray(g_j)).max() / np.abs(g_j).max()
    assert gap < 2e-4, gap       # measured 9.6e-5 of the largest entry


@pytest.mark.parametrize("name", ["maximum", "minimum"])
@pytest.mark.parametrize("scalar_first", [False, True])
def test_tie_gradients_match_jnp(name, scalar_first):
    """core.math.maximum / minimum against a Python number, at exact ties
    and off them: values bitwise and gradients equal to jax.grad of
    jnp.maximum / jnp.minimum (half the gradient at a tie)."""
    from surfjax_torch.core import math as pt_math
    x = np.array([0.5, 1.0, 2.0, 1.0, -0.0, 0.0], F32)
    bound = 1.0 if name == "maximum" else 0.0
    jfn = getattr(jnp, name)
    pfn = getattr(pt_math, name)

    def jloss(v):
        out = jfn(F32(bound), v) if scalar_first else jfn(v, F32(bound))
        return jnp.sum(out * jnp.arange(1, 7, dtype=jnp.float32))

    xt = torch.tensor(x, requires_grad=True)
    out = pfn(bound, xt) if scalar_first else pfn(xt, bound)
    (out * torch.arange(1, 7, dtype=torch.float32)).sum().backward()
    want_val = np.asarray(jfn(F32(bound), x) if scalar_first
                          else jfn(x, F32(bound)))
    clamp = (torch.clamp(xt, min=bound) if name == "maximum"
             else torch.clamp(xt, max=bound)).detach().numpy()
    assert np.array_equal(out.detach().numpy().view(np.int32),
                          clamp.view(np.int32))    # the values as before
    np.testing.assert_array_equal(out.detach().numpy(), want_val)
    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    ties = x == F32(bound)
    assert ties.any() and np.all(np.abs(want[ties]) ==
                                 0.5 * np.arange(1, 7)[ties])
