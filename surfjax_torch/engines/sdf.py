"""SDF engine: leaf SDFs, the CSG tape, the bounded sphere tracer with its
implicit-function-theorem adjoint, FD normals, the soft-shadow march and the
AO probes.

Counterpart of `surfjax/engines/sdf.py`. Masked loops stop as soon as
every lane is done; updates to a done lane are identity, so a lane's
result does not depend on which other lanes share its batch.
"""

from __future__ import annotations

import torch

from surfjax_torch.api import (
    OP_INTERSECT, OP_LEAF, OP_SMOOTH_INTERSECT, OP_SMOOTH_SUBTRACT,
    OP_SMOOTH_UNION, OP_SUBTRACT, OP_UNION,
)
from surfjax_torch.core.math import (
    BIG, clamp, f32, fdiv, maximum, minimum, mix, portable_log, saturate,
    sqrt, vdot, vnormalize, vsub,
)
from surfjax_torch.core.scene_compile import (
    LEAF_BOX, LEAF_MANDELBULB, LEAF_PLANE, LEAF_SPHERE, ObjectIR,
)

POWER8_ONLY_MSG = (
    "Mandelbulb: the fused path specializes power=8; render general "
    "powers with RenderSettings(backend='jnp').")


# ---------------------------------------------------------------------------
# Leaf SDFs
# ---------------------------------------------------------------------------

def sdf_sphere(prm, p):
    c = (prm[0], prm[1], prm[2])
    q = vsub(p, c)
    return sqrt(vdot(q, q)) - prm[3]


def sdf_plane(prm, p):
    n = (prm[0], prm[1], prm[2])
    return vdot(n, p) - prm[3]


def sdf_box(prm, p):
    c = (prm[0], prm[1], prm[2])
    h = (prm[3], prm[4], prm[5])
    qx = torch.abs(p[0] - c[0]) - h[0]
    qy = torch.abs(p[1] - c[1]) - h[1]
    qz = torch.abs(p[2] - c[2]) - h[2]
    ox = maximum(qx, 0.0)
    oy = maximum(qy, 0.0)
    oz = maximum(qz, 0.0)
    outside = sqrt((ox * ox + oy * oy) + oz * oz)
    inside = minimum(maximum(qx, maximum(qy, qz)), 0.0)
    return outside + inside


def _bulb_canonical(prm, p):
    c = (prm[0], prm[1], prm[2])
    scale = prm[3]
    bailout2 = prm[4] * prm[4] * 16.0
    inv_s = 1.0 / scale
    px = (p[0] - c[0]) * inv_s
    py = (p[1] - c[1]) * inv_s
    pz = (p[2] - c[2]) * inv_s
    return scale, bailout2, px, py, pz


def _far_guard(de, px, py, pz, scale):
    """Far-field lower bound: the set lies in a ball of radius 1.25
    (canonical units), so stepping by (r0 - 1.35) + 0.1 is always safe."""
    r0 = sqrt((px * px + py * py) + pz * pz)
    far = r0 - f32(1.35)
    de = torch.where(far > 0.0, minimum(de, far + f32(0.1)), de)
    return de * scale


def sdf_mandelbulb_general(prm, p, power: int, iterations: int):
    """General power-n Mandelbulb DE via the triplex trig form (eager
    pipeline only)."""
    scale, bailout2, px, py, pz = _bulb_canonical(prm, p)
    n = float(power)
    wx, wy, wz = px, py, pz
    m = (wx * wx + wy * wy) + wz * wz
    dz = torch.ones_like(m)
    escaped = m > bailout2
    tiny = f32(1e-12)
    for _ in range(iterations):
        active = ~escaped
        r = sqrt(maximum(m, tiny))
        rp1 = torch.exp(float(power - 1) * torch.log(r))
        dz_new = n * rp1 * dz + 1.0
        theta = torch.arccos(clamp(wz / r, -1.0, 1.0)) * n
        phi = torch.atan2(wy, wx) * n
        zr = rp1 * r
        st = torch.sin(theta)
        wx_new = px + zr * (st * torch.cos(phi))
        wy_new = py + zr * (st * torch.sin(phi))
        wz_new = pz + zr * torch.cos(theta)
        wx = torch.where(active, wx_new, wx)
        wy = torch.where(active, wy_new, wy)
        wz = torch.where(active, wz_new, wz)
        dz = torch.where(active, dz_new, dz)
        m = torch.where(active, (wx * wx + wy * wy) + wz * wz, m)
        escaped = escaped | (m > bailout2)
    r = sqrt(maximum(m, tiny))
    de = 0.25 * torch.log(maximum(m, tiny)) * r / dz
    return _far_guard(de, px, py, pz, scale)


def sdf_mandelbulb(prm, p, power: int, iterations: int):
    """Mandelbulb DE, eager form: the expanded trigless degree-8 update
    with an exact 1/sqrt; other powers take the general trig form."""
    if power != 8:
        return sdf_mandelbulb_general(prm, p, power, iterations)
    scale, bailout2, px, py, pz = _bulb_canonical(prm, p)
    wx, wy, wz = px, py, pz
    m = (wx * wx + wy * wy) + wz * wz
    dz = torch.ones_like(m)
    escaped = m > bailout2
    new_w = _new_w_std(px, py, pz, f32(1e-4))  # k3^7 must not underflow
    for _ in range(iterations):
        active = ~escaped
        if not bool(active.any()):
            break
        m2 = m * m
        m4 = m2 * m2
        dz_new = 8.0 * sqrt((m4 * m2) * m) * dz + 1.0
        wx_new, wy_new, wz_new = new_w(wx, wy, wz)
        wx = torch.where(active, wx_new, wx)
        wy = torch.where(active, wy_new, wy)
        wz = torch.where(active, wz_new, wz)
        dz = torch.where(active, dz_new, dz)
        m = torch.where(active, (wx * wx + wy * wy) + wz * wz, m)
        escaped = escaped | (m > bailout2)
    r = sqrt(m)
    de = 0.25 * torch.log(maximum(m, f32(1e-30))) * r / dz
    return _far_guard(de, px, py, pz, scale)


def _bulb_orbit(px, py, pz, bailout2, iterations: int, new_w_builder):
    """The DE loop of the fused path: at most `iterations` power-8 updates
    of the orbit seeded at (px, py, pz), a lane frozen once m > bailout2
    -> (wx, wy, wz, dz, m). The rsqrt of the reference is an exact 1/sqrt
    here, as in the CUDA kernels (csrc/frame_fused.cuh::bulb_substep)."""
    new_w = new_w_builder(px, py, pz, f32(1e-4))
    wx, wy, wz = px, py, pz
    m = (px * px + py * py) + pz * pz
    dz = torch.ones_like(m)
    for _ in range(iterations):
        active = m <= bailout2
        if not bool(active.any()):
            break
        m2 = m * m
        m4 = m2 * m2
        dz_new = 8.0 * ((m4 * (1.0 / sqrt(maximum(m, f32(1e-30)))))
                        * dz) + 1.0
        wx_new, wy_new, wz_new = new_w(wx, wy, wz)
        wx = torch.where(active, wx_new, wx)
        wy = torch.where(active, wy_new, wy)
        wz = torch.where(active, wz_new, wz)
        dz = torch.where(active, dz_new, dz)
        m = torch.where(active, (wx * wx + wy * wy) + wz * wz, m)
    return wx, wy, wz, dz, m


def _bulb_while_driver(prm, p, power: int, iterations: int, new_w_builder,
                       log_fn=None):
    """Fused-path Mandelbulb DE: each lane runs at most `iterations`
    updates and stops once it escapes (m > bailout2)."""
    if power != 8:
        raise NotImplementedError(POWER8_ONLY_MSG)
    scale, bailout2, px, py, pz = _bulb_canonical(prm, p)
    m0 = (px * px + py * py) + pz * pz
    _, _, _, dz, m = _bulb_orbit(px, py, pz, bailout2, iterations,
                                 new_w_builder)
    r = sqrt(m)
    log_fn = log_fn or torch.log
    de = 0.25 * log_fn(maximum(m, f32(1e-30))) * r / dz
    r0 = sqrt(m0)
    far = r0 - f32(1.35)
    de = torch.where(far > 0.0, minimum(de, far + f32(0.1)), de)
    return de * scale


def _new_w_std(px, py, pz, tiny):
    """The expanded trigless degree-8 triplex power (oracle arithmetic)."""
    def new_w(x, y, z):
        x2 = x * x
        x4 = x2 * x2
        y2 = y * y
        y4 = y2 * y2
        z2 = z * z
        z4 = z2 * z2
        k3 = x2 + z2
        k3s = maximum(k3, tiny)
        k37 = ((k3s * k3s) * (k3s * k3s)) * ((k3s * k3s) * k3s)
        k2 = 1.0 / sqrt(k37)
        k1 = ((x4 + y4) + z4) - 6.0 * (y2 * z2) \
            - 6.0 * (x2 * y2) + 2.0 * (z2 * x2)
        k4 = (x2 - y2) + z2
        wx_new = px + 64.0 * ((((x * y) * z) * (x2 - z2)) * k4) \
            * ((x4 - 6.0 * (x2 * z2)) + z4) * k1 * k2
        wy_new = py + (-16.0 * (y2 * k3) * (k4 * k4) + k1 * k1)
        wz_new = pz + -8.0 * (y * k4) \
            * ((((x4 * x4) - 28.0 * ((x4 * x2) * z2))
                + 70.0 * (x4 * z4))
               - 28.0 * ((x2 * z2) * z4) + (z4 * z4)) * k1 * k2
        return wx_new, wy_new, wz_new
    return new_w


def _new_w_cheb(px, py, pz, tiny):
    """Restructured power-8 update: Re/Im((x+iz)^8) by three complex
    squarings and k1 = (k3-3y^2)^2 - 8y^4 (the same identities as
    surfjax's cheb form, in the same association)."""
    def new_w(x, y, z):
        x2 = x * x
        y2 = y * y
        z2 = z * z
        y4 = y2 * y2
        k3 = x2 + z2
        k3s = maximum(k3, tiny)
        k37 = ((k3s * k3s) * (k3s * k3s)) * ((k3s * k3s) * k3s)
        k2 = 1.0 / sqrt(k37)
        t13 = k3 - 3.0 * y2
        k1 = t13 * t13 - 8.0 * y4
        k4 = (x2 - y2) + z2
        a1 = x2 - z2
        b1 = 2.0 * (x * z)
        a2 = a1 * a1 - b1 * b1
        b2 = 2.0 * (a1 * b1)
        re8 = a2 * a2 - b2 * b2
        im8 = 2.0 * (a2 * b2)
        s8 = ((8.0 * y) * k4) * (k1 * k2)
        wx_new = px + s8 * im8
        wy_new = py + (-16.0 * (y2 * k3) * (k4 * k4) + k1 * k1)
        wz_new = pz - s8 * re8
        return wx_new, wy_new, wz_new
    return new_w


def leaf_sdf(kind: int, prm, p, p0: int = 0, p1: int = 0):
    if kind == LEAF_SPHERE:
        return sdf_sphere(prm, p)
    if kind == LEAF_PLANE:
        return sdf_plane(prm, p)
    if kind == LEAF_BOX:
        return sdf_box(prm, p)
    if kind == LEAF_MANDELBULB:
        return sdf_mandelbulb(prm, p, p0, p1)
    raise ValueError(f"sdf engine: unsupported leaf kind {kind}")


def make_bulb_while(bulb_iter: str = "std", bulb_log: str = "hw"):
    """Fused-path bulb DE: iteration form (std | cheb) x epilogue log
    (hw | portable)."""
    new_w = _new_w_cheb if bulb_iter == "cheb" else _new_w_std
    log_fn = portable_log if bulb_log == "portable" else None

    def bulb(prm, p, power, iterations):
        return _bulb_while_driver(prm, p, power, iterations, new_w,
                                  log_fn=log_fn)
    return bulb


def make_leaf_fast(bulb_iter: str = "std", bulb_log: str = "hw",
                   cap: int = 0):
    """Fused-path leaf evaluator; cap > 0 limits fractal iterations (the
    secondary-ray level of detail)."""
    bulb = make_bulb_while(bulb_iter, bulb_log)

    def leaf_fn(kind, prm, p, p0=0, p1=0):
        if kind == LEAF_MANDELBULB:
            return bulb(prm, p, p0, min(p1, cap) if cap else p1)
        return leaf_sdf(kind, prm, p, p0, p1)
    return leaf_fn


# ---------------------------------------------------------------------------
# CSG tape over SDF values (polynomial smooth-min blends)
# ---------------------------------------------------------------------------

def eval_sdf(oir: ObjectIR, leaf_params, node_params, p, leaf_fn=None):
    """Object SDF at points p = (x, y, z) by walking the post-order tape."""
    leaf_fn = leaf_fn or leaf_sdf
    vals = []
    for nd in oir.nodes:
        if nd.op == OP_LEAF:
            lf = oir.leaves[nd.leaf]
            vals.append(leaf_fn(lf.kind, leaf_params[lf.slot], p,
                                lf.p0, lf.p1))
        elif nd.op == OP_UNION:
            vals.append(minimum(vals[nd.a], vals[nd.b]))
        elif nd.op == OP_INTERSECT:
            vals.append(maximum(vals[nd.a], vals[nd.b]))
        elif nd.op == OP_SUBTRACT:
            vals.append(maximum(vals[nd.a], -vals[nd.b]))
        elif nd.op == OP_SMOOTH_UNION:
            a, b = vals[nd.a], vals[nd.b]
            k = node_params[nd.pslot, 0]
            h = saturate(0.5 + 0.5 * (b - a) / k)
            vals.append(mix(b, a, h) - k * h * (1.0 - h))
        elif nd.op == OP_SMOOTH_INTERSECT:
            a, b = vals[nd.a], vals[nd.b]
            k = node_params[nd.pslot, 0]
            h = saturate(0.5 - 0.5 * (b - a) / k)
            vals.append(mix(b, a, h) + k * h * (1.0 - h))
        elif nd.op == OP_SMOOTH_SUBTRACT:
            a, b = vals[nd.a], vals[nd.b]
            k = node_params[nd.pslot, 0]
            h = saturate(0.5 - 0.5 * (b + a) / k)
            vals.append(mix(a, -b, h) + k * h * (1.0 - h))
        else:
            raise ValueError(f"unknown op {nd.op}")
    return vals[-1]


# ---------------------------------------------------------------------------
# Bounded sphere tracer, with the implicit-function-theorem adjoint
# ---------------------------------------------------------------------------
#
# The march defines t(theta, o, d) implicitly by f_theta(o + t d) = 0 at the
# hit. Its backward does not unroll the loop; it is the IFT at the hit point:
#   dt/dtheta = -(df/dtheta) / (grad f . d),
#   dt/do     = -grad f / (grad f . d),
#   dt/dd     = -t grad f / (grad f . d).
# Miss lanes get zero gradient. At silhouettes grad f . d -> 0, so its
# magnitude is clamped from below: a lane there scales its cotangent by at
# most 1/clamp (the usual bias of inverse rendering through SDFs). The value
# is surfjax's default.
_IFT_DENOM_CLAMP = 1e-2


def _sphere_trace_march(oir: ObjectIR, leaf_params, node_params, o, d,
                        t_min, t_max, max_steps: int, hit_eps: float,
                        eps_scale: float = 0.0):
    """Masked bounded march -> (t, hit_mask); miss: t == BIG. t_max may be
    a per-ray tensor."""
    eps = f32(hit_eps)
    es = f32(eps_scale)
    if not isinstance(t_max, torch.Tensor):
        t_max = f32(t_max)
    t = torch.full_like(o[0], f32(t_min))
    done = torch.zeros_like(o[0], dtype=torch.bool)
    hit = torch.zeros_like(o[0], dtype=torch.bool)
    for _ in range(max_steps):
        if bool(done.all()):
            break
        px = o[0] + t * d[0]
        py = o[1] + t * d[1]
        pz = o[2] + t * d[2]
        h = eval_sdf(oir, leaf_params, node_params, (px, py, pz))
        hit_now = h < (eps + es * t)
        over = t > t_max
        done_new = done | hit_now | over
        t = torch.where(done_new, t, t + h)
        hit = hit | (hit_now & (~done))
        done = done_new
    t = torch.where(hit, t, BIG)
    return t, hit


def _grads_or_zeros(outputs, inputs, cotangent, retain_graph: bool):
    """torch.autograd.grad with zeros for the inputs the output does not
    reach (or when nothing of it requires grad)."""
    if not outputs.requires_grad:
        return [torch.zeros_like(x) for x in inputs]
    grads = torch.autograd.grad(outputs, inputs, cotangent,
                                retain_graph=retain_graph, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(grads, inputs)]


def ift_adjoint(f, leaf_params, node_params, o, d, t, hit, g_t,
                plane_normal=None):
    """The IFT backward of a hit distance: f(lp, nparams, p) is the
    defining function (evaluated once at the hit points, with autograd on),
    g_t the cotangent of t -> (g_lp, g_nparams, g_o tuple, g_d tuple).

    plane_normal, if given, is (mask, (nx, ny, nz)): on `mask` lanes the
    defining function is the plane of that (constant) normal through the
    hit point, which has no parameters, instead of f."""
    t_safe = torch.where(hit, t, 0.0)
    o = tuple(c.detach() for c in o)
    d = tuple(c.detach() for c in d)
    with torch.enable_grad():
        lp = leaf_params.detach().requires_grad_(True)
        nparams = node_params.detach().requires_grad_(True)
        p = tuple((o[k] + t_safe * d[k]).requires_grad_(True)
                  for k in range(3))
        val = f(lp, nparams, p)
    gx, gy, gz = _grads_or_zeros(val, p, torch.ones_like(t), True)
    if plane_normal is not None:
        on_plane, n_geom = plane_normal
        gx = torch.where(on_plane, n_geom[0], gx)
        gy = torch.where(on_plane, n_geom[1], gy)
        gz = torch.where(on_plane, n_geom[2], gz)
    denom = (gx * d[0] + gy * d[1]) + gz * d[2]
    clamp_ = f32(_IFT_DENOM_CLAMP)
    denom = torch.where(denom.abs() < clamp_,
                        torch.where(denom >= 0.0, clamp_, -clamp_), denom)
    scale = torch.where(hit, -g_t / denom, 0.0)
    scale_f = scale
    if plane_normal is not None:
        scale_f = torch.where(on_plane, 0.0, scale)
    g_lp, g_np, sgx, sgy, sgz = _grads_or_zeros(
        val, (lp, nparams) + p, scale_f, False)
    if plane_normal is not None:
        scale_m = torch.where(on_plane, scale, 0.0)
        sgx = sgx + scale_m * n_geom[0]
        sgy = sgy + scale_m * n_geom[1]
        sgz = sgz + scale_m * n_geom[2]
    g_o = (sgx, sgy, sgz)
    g_d = (t_safe * sgx, t_safe * sgy, t_safe * sgz)
    return g_lp, g_np, g_o, g_d


class _SphereTrace(torch.autograd.Function):
    """sphere_trace as a differentiable function of (leaf_params,
    node_params, o, d): the forward is the march under no_grad, the
    backward the IFT adjoint at the hit points (t_max gets no gradient)."""

    @staticmethod
    def forward(ctx, oir, t_min, t_max, max_steps, hit_eps, eps_scale,
                leaf_params, node_params, ox, oy, oz, dx, dy, dz):
        t, hit = _sphere_trace_march(
            oir, leaf_params, node_params, (ox, oy, oz), (dx, dy, dz),
            t_min, t_max, max_steps, hit_eps, eps_scale)
        ctx.oir = oir
        ctx.save_for_backward(leaf_params, node_params, ox, oy, oz,
                              dx, dy, dz, t, hit)
        ctx.mark_non_differentiable(hit)
        return t, hit

    @staticmethod
    def backward(ctx, g_t, _g_hit):
        lp, nparams, ox, oy, oz, dx, dy, dz, t, hit = ctx.saved_tensors
        oir = ctx.oir
        g_lp, g_np, g_o, g_d = ift_adjoint(
            lambda lp_, np_, p: eval_sdf(oir, lp_, np_, p),
            lp, nparams, (ox, oy, oz), (dx, dy, dz), t, hit, g_t)
        return (None,) * 6 + (g_lp, g_np) + tuple(g_o) + tuple(g_d)


def sphere_trace(oir: ObjectIR, leaf_params, node_params, o, d,
                 t_min, t_max, max_steps: int, hit_eps: float,
                 eps_scale: float = 0.0):
    """Masked bounded march -> (t, hit_mask); miss: t == BIG. t_max may be
    a per-ray tensor. Differentiable in leaf_params, node_params, o and d
    through the IFT adjoint (`ift_adjoint`); with no input that requires
    grad it is the plain march."""
    tensors = (leaf_params, node_params) + tuple(o) + tuple(d)
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        return _SphereTrace.apply(oir, t_min, t_max, max_steps, hit_eps,
                                  eps_scale, *tensors)
    with torch.no_grad():
        return _sphere_trace_march(oir, leaf_params, node_params, o, d,
                                   t_min, t_max, max_steps, hit_eps,
                                   eps_scale)


def normal_fd(oir: ObjectIR, leaf_params, node_params, p, eps: float,
              live=None):
    """4-tap tetrahedron finite-difference normal.

    live: the lanes whose normal the caller keeps (bool mask), or None for
    all. Far from the object the four float32 taps can be equal, which
    makes the normal 0/0; the caller's `where` hides that value but not
    its gradient (0 * inf). On the other lanes the difference vector is
    therefore replaced by a unit vector before it is normalised: values on
    the live lanes are untouched, and no gradient is non-finite."""
    e = f32(eps)
    s0 = eval_sdf(oir, leaf_params, node_params,
                  (p[0] + e, p[1] - e, p[2] - e))
    s1 = eval_sdf(oir, leaf_params, node_params,
                  (p[0] - e, p[1] - e, p[2] + e))
    s2 = eval_sdf(oir, leaf_params, node_params,
                  (p[0] - e, p[1] + e, p[2] - e))
    s3 = eval_sdf(oir, leaf_params, node_params,
                  (p[0] + e, p[1] + e, p[2] + e))
    nx = ((s0 - s1) - s2) + s3
    ny = ((-s0 - s1) + s2) + s3
    nz = ((-s0 + s1) - s2) + s3
    if live is not None:
        nx = torch.where(live, nx, 0.0)
        ny = torch.where(live, ny, 0.0)
        nz = torch.where(live, nz, 1.0)
    return vnormalize((nx, ny, nz))


def soft_shadow_march(sdf_fn, o, d, t_min, t_max, k, steps: int):
    """Penumbra factor in [0, 1] marching toward the light (classic k*h/t
    accumulator with a res-aware adaptive step). k and t_max may be
    per-ray tensors."""
    kf = k if isinstance(k, torch.Tensor) else f32(k)
    t = torch.full_like(o[0], f32(t_min))
    res = torch.ones_like(o[0])
    # a light nearer than t_min leaves no shadow segment: visibility 1
    done = t > t_max
    for _ in range(steps):
        if bool(done.all()):
            break
        px = o[0] + t * d[0]
        py = o[1] + t * d[1]
        pz = o[2] + t * d[2]
        h = sdf_fn((px, py, pz))
        res_new = minimum(res, kf * h / t)
        s_allowed = (kf * h - res_new * t) / (kf + res_new)
        step = clamp(h, f32(1e-3), maximum(s_allowed, 0.5))
        t_new = t + step
        done_new = done | (res_new < f32(0.004)) | (t_new > t_max)
        res = torch.where(done, res, res_new)
        t = torch.where(done, t, t_new)
        done = done_new
    return saturate(res)


# Deterministic hemisphere probe directions around +z, rotated into the
# normal frame at run time.
_AO_DIRS = (
    (0.0, 0.0, 1.0),
    (0.7, 0.0, 0.7141428),
    (-0.7, 0.0, 0.7141428),
    (0.0, 0.7, 0.7141428),
    (0.0, -0.7, 0.7141428),
    (0.5, 0.5, 0.7071068),
    (-0.5, 0.5, 0.7071068),
    (0.5, -0.5, 0.7071068),
    (-0.5, -0.5, 0.7071068),
)


def ao_frame(n):
    """Orthonormal frame (t1, t2) around n; branch on |n.y| > 0.9."""
    big_y = torch.abs(n[1]) > f32(0.9)
    hx = torch.where(big_y, 1.0, 0.0)
    hy = torch.where(big_y, 0.0, 1.0)
    t1 = vnormalize((hy * n[2], -hx * n[2], hx * n[1] - hy * n[0]))
    t2 = (n[1] * t1[2] - n[2] * t1[1],
          n[2] * t1[0] - n[0] * t1[2],
          n[0] * t1[1] - n[1] * t1[0])
    return t1, t2


def ao_tap_points(p, n, samples: int, radius: float):
    """Yields (az, r, tap point) for every AO tap, in tap order."""
    samples = min(samples, len(_AO_DIRS))
    t1, t2 = ao_frame(n)
    rad = f32(radius)
    for s in range(samples):
        ax, ay, az = (f32(c) for c in _AO_DIRS[s])
        dx = (ax * t1[0] + ay * t2[0]) + az * n[0]
        dy = (ax * t1[1] + ay * t2[1]) + az * n[1]
        dz = (ax * t1[2] + ay * t2[2]) + az * n[2]
        for tap in range(1, 5):
            r = f32(f32(rad * float(tap)) * 0.25)
            yield az, r, (p[0] + dx * r, p[1] + dy * r, p[2] + dz * r)


def ao_tap_term(az: float, r: float, h):
    """Occlusion of one tap: how far the SDF falls short of the
    tangent-plane response az*r, over r."""
    return fdiv(maximum(f32(az * r) - h, 0.0), r)


def ao_probe_terms(sdf_fn, p, n, samples: int, radius: float):
    """Per-tap AO occlusion terms, in tap order (see ao_probes). Terms of
    several object groups combine exactly by elementwise max."""
    return [ao_tap_term(az, r, sdf_fn(q))
            for az, r, q in ao_tap_points(p, n, samples, radius)]


def ao_terms_to_factor(terms, samples: int, strength: float):
    """Tap terms -> ao factor, summed in tap order."""
    samples = min(samples, len(_AO_DIRS))
    occ = terms[0]
    for t in terms[1:]:
        occ = occ + t
    occ = fdiv(occ, float(samples * 4))
    return saturate(1.0 - f32(strength) * occ)


def ao_probes(sdf_fn, p, n, samples: int, radius: float, strength: float):
    """Hemisphere ambient-occlusion probes -> ao factor in [0, 1]."""
    terms = ao_probe_terms(sdf_fn, p, n, samples, radius)
    return ao_terms_to_factor(terms, samples, strength)
