"""surfjax_torch engines against surfjax's, on seeded random points and rays.

JAX's eager ops each round on their own, so where surfjax runs op by op
the port must agree to the bit (or to the ULPs of a transcendental). Where
surfjax compiles a loop (`lax.while_loop`), XLA:CPU contracts multiply-adds
and uses an approximate rsqrt inside it; those comparisons carry a stated
tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import surfjax.api as sj_api  # noqa: E402
import surfjax.engines.analytic as sj_ana  # noqa: E402
import surfjax.engines.sdf as sj_sdf  # noqa: E402
from surfjax.io.image import ulp_diff_f32  # noqa: E402

import surfjax_torch.engines.analytic as pt_ana  # noqa: E402
import surfjax_torch.engines.sdf as pt_sdf  # noqa: E402
from surfjax_torch.core.scene_compile import from_reference  # noqa: E402

N = 2048


def _points(seed, lo=-2.0, hi=2.0, n=N):
    pts = np.random.default_rng(seed).uniform(lo, hi, (3, n)).astype(
        np.float32)
    return (tuple(jnp.asarray(c) for c in pts),
            tuple(torch.from_numpy(c) for c in pts))


def _rays(seed, n=N):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (3, n)).astype(np.float32)
    o[2] -= 1.0
    d = rng.normal(size=(3, n)) + np.array([[0.0], [0.0], [3.0]])
    d = (d / np.sqrt((d * d).sum(0))).astype(np.float32)
    return ((tuple(jnp.asarray(c) for c in o),
             tuple(jnp.asarray(c) for c in d)),
            (tuple(torch.from_numpy(c) for c in o),
             tuple(torch.from_numpy(c) for c in d)))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


LEAF_PRM = np.array([0.3, -0.2, 0.1, 0.7, 0.5, 0.4, 0.0, 0.0], np.float32)
BULB_PRM = np.array([0.1, 0.0, -0.1, 0.9, 2.0, 0.0, 0.0, 0.0], np.float32)


@pytest.mark.parametrize("name", ["sdf_sphere", "sdf_plane", "sdf_box"])
def test_leaf_sdfs_bitwise(name):
    """Same association, exact sqrt: bitwise."""
    pj, pt = _points(1)
    ref = getattr(sj_sdf, name)(jnp.asarray(LEAF_PRM), pj)
    got = getattr(pt_sdf, name)(torch.from_numpy(LEAF_PRM), pt)
    np.testing.assert_array_equal(_np(got), _np(ref))


def test_bulb_eager_form_within_2ulp():
    """The eager power-8 DE: only the final log differs between the two
    libraries (measured 2 ULP on the DE)."""
    pj, pt = _points(2)
    ref = sj_sdf.sdf_mandelbulb(jnp.asarray(BULB_PRM), pj, 8, 8)
    got = pt_sdf.sdf_mandelbulb(torch.from_numpy(BULB_PRM), pt, 8, 8)
    assert ulp_diff_f32(_np(got), _np(ref)).max() <= 2


@pytest.mark.parametrize("form", ["std", "cheb"])
@pytest.mark.parametrize("iters", [8, 2])
def test_bulb_while_forms(form, iters):
    """The fused-path DE, full (8) and LoD-capped (2) iterations, both logs.
    surfjax runs it inside a compiled while loop with XLA's approximate
    rsqrt and contracted multiply-adds; the port uses an exact 1/sqrt, as
    the CUDA kernel does. Measured abs diff <= 2.2e-6 on O(1) DE values;
    tolerance 1e-5 absolute."""
    pj, pt = _points(3)
    for log in ("hw", "portable"):
        ref = sj_sdf.make_bulb_while(form, log)(jnp.asarray(BULB_PRM), pj, 8,
                                                iters)
        got = pt_sdf.make_bulb_while(form, log)(torch.from_numpy(BULB_PRM),
                                                pt, 8, iters)
        np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=1e-5)


def _ops_scene():
    """One SDF object per CSG op (all six), leaves of every kind."""
    S, B, P = sj_api.Sphere, sj_api.Box, sj_api.Plane
    a = S((0.2, 0.1, 0.0), 0.8)
    b = B((-0.3, 0.0, 0.2), (0.5, 0.4, 0.6))
    scene = sj_api.Scene()
    for node in (sj_api.union(a, b), sj_api.intersect(a, b),
                 sj_api.subtract(a, b), sj_api.smooth_union(a, b, 0.3),
                 sj_api.smooth_intersect(a, b, 0.2),
                 sj_api.smooth_subtract(a, P((0.0, 1.0, 0.0), 0.1), 0.25),
                 sj_api.smooth_union(sj_api.Mandelbulb((0.0, 0.0, 0.0), 0.9),
                                     a, 0.2)):
        scene.add(node, engine="sdf")
    return scene.freeze()


def test_eval_sdf_all_six_ops():
    """Every CSG op of the tape, bitwise on sphere/box/plane leaves; the
    object with a bulb leaf within the eager DE's log ULPs."""
    static, params = _ops_scene()
    pstatic, pparams = from_reference(static, params, device="cpu")
    pj, pt = _points(4)
    ops = set()
    for oir, poir in zip(static.ir.objects, pstatic.ir.objects):
        ops.update(nd.op for nd in oir.nodes)
        ref = sj_sdf.eval_sdf(oir, jnp.asarray(params["leaf_params"]),
                              jnp.asarray(params["node_params"]), pj)
        got = pt_sdf.eval_sdf(poir, pparams["leaf_params"],
                              pparams["node_params"], pt)
        if any(lf.kind == 3 for lf in oir.leaves):
            assert ulp_diff_f32(_np(got), _np(ref)).max() <= 2
        else:
            np.testing.assert_array_equal(_np(got), _np(ref))
    assert ops == set(range(7))   # the leaf op and all six CSG ops


def _csg_scene():
    S, B, P = sj_api.Sphere, sj_api.Box, sj_api.Plane
    scene = sj_api.Scene()
    scene.add(P((0.0, 1.0, 0.0), -1.5))
    scene.add(sj_api.subtract(B((-0.4, 0.0, 3.0), (0.8, 0.8, 0.8)),
                              S((-0.4, 0.0, 2.2), 0.9)))
    scene.add(sj_api.intersect(S((0.5, 0.0, 3.0), 0.9),
                               S((1.1, 0.0, 3.0), 0.9)))
    scene.add(sj_api.union(S((0.0, 0.6, 4.0), 0.7), B((0.0, -0.4, 4.0),
                                                      (0.3, 0.3, 0.3))))
    return scene.freeze()


def test_analytic_intervals_and_event_csg_bitwise():
    """Leaf intervals of all three kinds and the event CSG of union,
    intersect and subtract trees, with analytic normals: bitwise."""
    static, params = _csg_scene()
    pstatic, pparams = from_reference(static, params, device="cpu")
    (oj, dj), (ot, dt) = _rays(5)
    lpj = jnp.asarray(params["leaf_params"])
    hits = 0
    for oir, poir in zip(static.ir.objects, pstatic.ir.objects):
        for lf in oir.leaves:
            prm = pparams["leaf_params"][lf.slot]
            for a, b in zip(
                    sj_ana.leaf_interval(lf.kind, lpj[lf.slot], oj, dj),
                    pt_ana.leaf_interval(lf.kind, prm, ot, dt)):
                np.testing.assert_array_equal(_np(b), _np(a))
        t_ref, leaf_ref = sj_ana.intersect_analytic(oir, lpj, oj, dj, 1e-3,
                                                    1e4)
        t_got, leaf_got = pt_ana.intersect_analytic(
            poir, pparams["leaf_params"], ot, dt, 1e-3, 1e4)
        np.testing.assert_array_equal(_np(t_got), _np(t_ref))
        np.testing.assert_array_equal(_np(leaf_got), _np(leaf_ref))
        hits += int((_np(t_ref) < 1e29).sum())
        tj = jnp.where(t_ref < 1e29, t_ref, 0.0)
        pj = tuple(o + tj * d for o, d in zip(oj, dj))
        tt = torch.from_numpy(np.array(tj))
        p_t = tuple(o + tt * d for o, d in zip(ot, dt))
        for a, b in zip(sj_ana.object_normal_analytic(oir, lpj, pj, leaf_ref),
                        pt_ana.object_normal_analytic(
                            poir, pparams["leaf_params"], p_t, leaf_got)):
            np.testing.assert_array_equal(_np(b), _np(a))
    assert hits > N // 2  # the rays really hit the CSG objects


def test_soft_shadow_march_and_ao_probes():
    """The eager soft-shadow march (surfjax compiles its while loop: XLA
    contracts multiply-adds there; measured <= 1e-6) and the AO probes (op
    by op on both sides: bitwise), on the smooth-union object."""
    static, params = _ops_scene()
    pstatic, pparams = from_reference(static, params, device="cpu")
    oir, poir = static.ir.objects[3], pstatic.ir.objects[3]
    lpj = jnp.asarray(params["leaf_params"])
    npj = jnp.asarray(params["node_params"])

    def fj(p):
        return sj_sdf.eval_sdf(oir, lpj, npj, p)

    def ft(p):
        return pt_sdf.eval_sdf(poir, pparams["leaf_params"],
                               pparams["node_params"], p)

    rng = np.random.default_rng(6)
    o = rng.uniform(-1.5, 1.5, (3, N)).astype(np.float32)
    o[1] = -1.2
    lpos = np.array([[2.0], [4.0], [-1.0]], np.float32)
    lv = lpos - o
    dist = np.sqrt((lv * lv).sum(0)).astype(np.float32)
    l = (lv / dist).astype(np.float32)
    vis_ref = sj_sdf.soft_shadow_march(
        fj, tuple(map(jnp.asarray, o)), tuple(map(jnp.asarray, l)), 0.02,
        jnp.asarray(dist), 8.0, 64)
    vis_got = pt_sdf.soft_shadow_march(
        ft, tuple(map(torch.from_numpy, o)), tuple(map(torch.from_numpy, l)),
        0.02, torch.from_numpy(dist), 8.0, 64)
    np.testing.assert_allclose(_np(vis_got), _np(vis_ref), rtol=0, atol=1e-5)
    assert _np(vis_ref).min() < 0.5   # penumbrae actually darkened

    n = rng.normal(size=(3, N))
    n = (n / np.sqrt((n * n).sum(0))).astype(np.float32)
    ao_ref = sj_sdf.ao_probes(fj, tuple(map(jnp.asarray, o)),
                              tuple(map(jnp.asarray, n)), 5, 0.5, 1.0)
    ao_got = pt_sdf.ao_probes(ft, tuple(map(torch.from_numpy, o)),
                              tuple(map(torch.from_numpy, n)), 5, 0.5, 1.0)
    np.testing.assert_array_equal(_np(ao_got), _np(ao_ref))
    assert _np(ao_ref).min() < 0.9   # some receivers are occluded
