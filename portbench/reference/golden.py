"""The plain reference renderer: the renderer's semantics in plain PyTorch.

A ray-by-ray renderer over the reference's own scene (reference/scene.py),
written after the repository's NumPy golden oracle and imports nothing of
the program: analytic leaves by their intervals with event CSG, SDF
objects by a plain sphere trace (no over-relaxation, no level of detail),
meshes by testing every triangle, finite-difference SDF normals, hard or
SDF soft shadows, fixed-direction AO, Lambert / Blinn-Phong shading.

It renders any set of rays, so the harness hands it only the pixels it
checks: `render_rays(scene, settings, o, d, dtype)`. Every value is held
in `dtype`: float32 is the reference, bfloat16 the lower-precision
control. Scalars are rounded to float32 first, as the configuration
states its numbers in float32, so the two differ only in what the tensors
hold.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.scene import (
    Box, CSG, DirectionalLight, Mandelbulb, Mesh, OP_INTERSECT, OP_LEAF,
    OP_SMOOTH_INTERSECT, OP_SMOOTH_SUBTRACT, OP_SMOOTH_UNION, OP_SUBTRACT,
    OP_UNION, Plane, PointLight, SMOOTH_OPS, Sphere,
)

BIG = 1e30
TRI_CHUNK = 1024     # triangles tested at once against a block of rays
AO_DIRS = ((0.0, 0.0, 1.0), (0.7, 0.0, 0.7141428), (-0.7, 0.0, 0.7141428),
           (0.0, 0.7, 0.7141428), (0.0, -0.7, 0.7141428),
           (0.5, 0.5, 0.7071068), (-0.5, 0.5, 0.7071068),
           (0.5, -0.5, 0.7071068), (-0.5, -0.5, 0.7071068))


def f(x) -> float:
    """A scalar rounded to float32, as a Python float (exact)."""
    return float(np.float32(x))


def dot(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def normalize(v):
    inv = 1.0 / torch.sqrt(dot(v, v))
    return (v[0] * inv, v[1] * inv, v[2] * inv)


def cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def saturate(x):
    return x.clamp(0.0, 1.0)


def full(like, value):
    return torch.full_like(like, value)


def pow_int(x, n: int):
    if n == 0:
        return torch.ones_like(x)
    result, base = None, x
    while n:
        if n & 1:
            result = base if result is None else result * base
        n >>= 1
        if n:
            base = base * base
    return result


def _unit(v):
    """A direction of the configuration normalised in float64, then float32
    (as the scene's tables hold it) -> (3 floats, the float64 length)."""
    a = np.asarray(v, np.float64)
    ln = float(np.sqrt(np.dot(a, a)))
    return tuple(f(x) for x in (a / ln)), ln


class Obj:
    """One scene object flattened: its leaves with their signs and its node
    list in post order (op, a, b, leaf, k)."""

    def __init__(self, so):
        self.material = so.material
        self.mesh = so.node if isinstance(so.node, Mesh) else None
        self.leaves, self.nodes = [], []
        self.is_sdf = False
        if self.mesh is None:
            self._walk(so.node, 1)
            self.is_sdf = so.engine == "sdf" or self._needs_sdf(so.node)

    def _needs_sdf(self, n) -> bool:
        if isinstance(n, Mandelbulb):
            return True
        if isinstance(n, CSG):
            return (n.op in SMOOTH_OPS or self._needs_sdf(n.a)
                    or self._needs_sdf(n.b))
        return False

    def _walk(self, n, sign: int) -> int:
        if isinstance(n, CSG):
            ia = self._walk(n.a, sign)
            flip = -sign if n.op in (OP_SUBTRACT, OP_SMOOTH_SUBTRACT) \
                else sign
            ib = self._walk(n.b, flip)
            self.nodes.append((n.op, ia, ib, -1, float(n.k)))
        else:
            self.leaves.append((n, sign))
            self.nodes.append((OP_LEAF, -1, -1, len(self.leaves) - 1, 0.0))
        return len(self.nodes) - 1


# ---------------------------------------------------------------- analytic

def _quad_roots(b_half, c):
    disc = b_half * b_half - c
    has = disc >= 0.0
    sq = torch.sqrt(disc.clamp_min(0.0))
    s = torch.where(b_half >= 0.0, 1.0, -1.0).to(b_half.dtype)
    q = -(b_half + s * sq)
    r1 = torch.where(q != 0.0, c / torch.where(q != 0.0, q, 1.0), -b_half)
    t0 = torch.minimum(q, r1)
    t1 = torch.maximum(q, r1)
    return (torch.where(has, t0, BIG).to(q.dtype),
            torch.where(has, t1, -BIG).to(q.dtype))


def _leaf_interval(n, o, d):
    if isinstance(n, Sphere):
        c = tuple(f(v) for v in n.center)
        oc = (o[0] - c[0], o[1] - c[1], o[2] - c[2])
        r = np.float32(n.radius)
        return _quad_roots(dot(oc, d), dot(oc, oc) - float(r * r))
    if isinstance(n, Plane):
        nrm, ln = _unit(n.normal)
        off = f(n.offset / ln)
        denom = (nrm[0] * d[0] + nrm[1] * d[1]) + nrm[2] * d[2]
        no = (nrm[0] * o[0] + nrm[1] * o[1]) + nrm[2] * o[2]
        t_star = (off - no) / torch.where(denom == 0.0, 1.0, denom)
        inside = (no - off) < 0.0
        lo, hi = full(t_star, -BIG), full(t_star, BIG)
        t0 = torch.where(denom < 0.0, t_star, lo)
        t1 = torch.where(denom < 0.0, hi, t_star)
        t0 = torch.where(denom == 0.0, torch.where(inside, lo, hi), t0)
        t1 = torch.where(denom == 0.0, torch.where(inside, hi, lo), t1)
        return t0, t1
    if isinstance(n, Box):
        c = tuple(f(v) for v in n.center)
        h = tuple(f(v) for v in n.half_extents)
        t0, t1 = full(o[0], -BIG), full(o[0], BIG)
        for ax in range(3):
            dz = d[ax] == 0.0
            inv = 1.0 / torch.where(dz, 1.0, d[ax])
            lo = (f(np.float32(c[ax]) - np.float32(h[ax])) - o[ax]) * inv
            hi = (f(np.float32(c[ax]) + np.float32(h[ax])) - o[ax]) * inv
            tn, tf = torch.minimum(lo, hi), torch.maximum(lo, hi)
            in_slab = torch.abs(o[ax] - c[ax]) <= h[ax]
            big, small = full(tn, BIG), full(tn, -BIG)
            tn = torch.where(dz, torch.where(in_slab, small, big), tn)
            tf = torch.where(dz, torch.where(in_slab, big, small), tf)
            t0, t1 = torch.maximum(t0, tn), torch.minimum(t1, tf)
        empty = t0 > t1
        return (torch.where(empty, BIG, t0).to(t0.dtype),
                torch.where(empty, -BIG, t1).to(t0.dtype))
    raise TypeError(f"analytic reference: unsupported leaf "
                    f"{type(n).__name__}")


def _bool_tree(obj: Obj, st):
    vals = []
    for op, a, b, leaf, _k in obj.nodes:
        if op == OP_LEAF:
            vals.append(st[leaf])
        elif op == OP_UNION:
            vals.append(vals[a] | vals[b])
        elif op == OP_INTERSECT:
            vals.append(vals[a] & vals[b])
        elif op == OP_SUBTRACT:
            vals.append(vals[a] & ~vals[b])
        else:
            raise ValueError("smooth op in an analytic object")
    return vals[-1]


def _intersect_analytic(obj: Obj, o, d, t_min, t_max):
    iv = [_leaf_interval(n, o, d) for n, _s in obj.leaves]
    if len(obj.leaves) == 1 and len(obj.nodes) == 1:
        t0, t1 = iv[0]
        e0 = (t0 > t_min) & (t0 < t_max)
        e1 = (t1 > t_min) & (t1 < t_max)
        t = torch.where(e0, t0, torch.where(e1, t1, full(t1, BIG)))
        return t, torch.zeros_like(t, dtype=torch.int32)
    t_best = full(o[0], BIG)
    leaf_best = torch.zeros_like(o[0], dtype=torch.int32)
    for li in range(len(obj.leaves)):
        for end in range(2):
            t_e = iv[li][end]
            before, after = [], []
            for lj in range(len(obj.leaves)):
                if lj == li:
                    shaped = torch.full_like(t_e, end == 1, dtype=torch.bool)
                    before.append(shaped)
                    after.append(~shaped)
                else:
                    inside = (iv[lj][0] < t_e) & (t_e < iv[lj][1])
                    before.append(inside)
                    after.append(inside)
            flip = _bool_tree(obj, before) ^ _bool_tree(obj, after)
            better = flip & (t_e > t_min) & (t_e < t_max) & (t_e < t_best)
            t_best = torch.where(better, t_e, t_best)
            leaf_best = torch.where(better, li, leaf_best).to(torch.int32)
    return t_best, leaf_best


def _leaf_normal(n, p):
    if isinstance(n, Sphere):
        c = tuple(f(v) for v in n.center)
        return normalize((p[0] - c[0], p[1] - c[1], p[2] - c[2]))
    if isinstance(n, Plane):
        nrm, _ln = _unit(n.normal)
        return tuple(full(p[0], v) for v in nrm)
    if isinstance(n, Box):
        c = tuple(f(v) for v in n.center)
        h = tuple(f(v) for v in n.half_extents)
        q = (p[0] - c[0], p[1] - c[1], p[2] - c[2])
        dd = [torch.abs(q[k]) - h[k] for k in range(3)]
        sg = [torch.where(q[k] >= 0.0, 1.0, -1.0).to(p[0].dtype)
              for k in range(3)]
        xw = (dd[0] >= dd[1]) & (dd[0] >= dd[2])
        yw = ~xw & (dd[1] >= dd[2])
        zero = torch.zeros_like(dd[0])
        return (torch.where(xw, sg[0], zero), torch.where(yw, sg[1], zero),
                torch.where(xw | yw, zero, sg[2]))
    raise TypeError(f"reference normal: unsupported leaf {type(n).__name__}")


# --------------------------------------------------------------------- SDF

def _leaf_sdf(n, p):
    if isinstance(n, Sphere):
        c = tuple(f(v) for v in n.center)
        q = (p[0] - c[0], p[1] - c[1], p[2] - c[2])
        return torch.sqrt(dot(q, q)) - f(n.radius)
    if isinstance(n, Plane):
        nrm, ln = _unit(n.normal)
        return ((nrm[0] * p[0] + nrm[1] * p[1]) + nrm[2] * p[2]) \
            - f(n.offset / ln)
    if isinstance(n, Box):
        c = tuple(f(v) for v in n.center)
        h = tuple(f(v) for v in n.half_extents)
        q = [torch.abs(p[k] - c[k]) - h[k] for k in range(3)]
        o = [x.clamp_min(0.0) for x in q]
        outside = torch.sqrt((o[0] * o[0] + o[1] * o[1]) + o[2] * o[2])
        inside = torch.maximum(q[0], torch.maximum(q[1], q[2])).clamp_max(
            0.0)
        return outside + inside
    if isinstance(n, Mandelbulb):
        return _mandelbulb(n, p)
    raise TypeError(f"reference sdf: unsupported leaf {type(n).__name__}")


def _mandelbulb(n: Mandelbulb, p):
    """The power-n Mandelbulb's distance estimate: power 8 by its
    polynomial (triplex) form, any other power by its trigonometric
    form; escaped lanes keep their last value."""
    c = tuple(f(v) for v in n.center)
    scale = np.float32(n.scale)
    bailout2 = float(np.float32(n.bailout) * np.float32(n.bailout)
                     * np.float32(16.0))
    inv_s = float(np.float32(1.0) / scale)
    px, py, pz = ((p[k] - c[k]) * inv_s for k in range(3))
    wx, wy, wz = px, py, pz
    m = (wx * wx + wy * wy) + wz * wz
    dz = torch.ones_like(m)
    escaped = m > bailout2
    for _ in range(n.iterations):
        active = ~escaped
        if n.power == 8:
            m2 = m * m
            m4 = m2 * m2
            dz_new = 8.0 * torch.sqrt((m4 * m2) * m) * dz + 1.0
            x, y, z = wx, wy, wz
            x2, y2, z2 = x * x, y * y, z * z
            x4, y4, z4 = x2 * x2, y2 * y2, z2 * z2
            k3 = x2 + z2
            k3s = k3.clamp_min(f(1e-4))
            k37 = ((k3s * k3s) * (k3s * k3s)) * ((k3s * k3s) * k3s)
            k2 = 1.0 / torch.sqrt(k37)
            k1 = ((x4 + y4) + z4) - 6.0 * (y2 * z2) - 6.0 * (x2 * y2) \
                + 2.0 * (z2 * x2)
            k4 = (x2 - y2) + z2
            wx_new = px + 64.0 * ((((x * y) * z) * (x2 - z2)) * k4) \
                * ((x4 - 6.0 * (x2 * z2)) + z4) * k1 * k2
            wy_new = py + (-16.0 * (y2 * k3) * (k4 * k4) + k1 * k1)
            wz_new = pz + -8.0 * (y * k4) \
                * ((((x4 * x4) - 28.0 * ((x4 * x2) * z2))
                    + 70.0 * (x4 * z4))
                   - 28.0 * ((x2 * z2) * z4) + (z4 * z4)) * k1 * k2
        else:
            pw = float(n.power)
            r = torch.sqrt(m.clamp_min(f(1e-12)))
            rp1 = torch.exp(float(n.power - 1) * torch.log(r))
            dz_new = pw * rp1 * dz + 1.0
            theta = torch.arccos((wz / r).clamp(-1.0, 1.0)) * pw
            phi = torch.atan2(wy, wx) * pw
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
    if n.power == 8:
        de = 0.25 * torch.log(m.clamp_min(f(1e-30))) * torch.sqrt(m) / dz
    else:
        mm = m.clamp_min(f(1e-12))
        de = 0.25 * torch.log(mm) * torch.sqrt(mm) / dz
    far = torch.sqrt((px * px + py * py) + pz * pz) - f(1.35)
    de = torch.where(far > 0.0, torch.minimum(de, far + f(0.1)), de)
    return de * float(scale)


def eval_sdf(obj: Obj, p):
    vals = []
    for op, a, b, leaf, k in obj.nodes:
        if op == OP_LEAF:
            vals.append(_leaf_sdf(obj.leaves[leaf][0], p))
            continue
        va, vb = vals[a], vals[b]
        if op == OP_UNION:
            vals.append(torch.minimum(va, vb))
        elif op == OP_INTERSECT:
            vals.append(torch.maximum(va, vb))
        elif op == OP_SUBTRACT:
            vals.append(torch.maximum(va, -vb))
        elif op == OP_SMOOTH_UNION:
            h = saturate(0.5 + 0.5 * (vb - va) / f(k))
            vals.append((vb + (va - vb) * h) - f(k) * h * (1.0 - h))
        elif op == OP_SMOOTH_INTERSECT:
            h = saturate(0.5 - 0.5 * (vb - va) / f(k))
            vals.append((vb + (va - vb) * h) + f(k) * h * (1.0 - h))
        elif op == OP_SMOOTH_SUBTRACT:
            h = saturate(0.5 - 0.5 * (vb + va) / f(k))
            vals.append((va + (-vb - va) * h) + f(k) * h * (1.0 - h))
        else:
            raise ValueError(f"unknown op {op}")
    return vals[-1]


def sphere_trace(obj: Obj, o, d, t_min, t_max, max_steps, hit_eps,
                 eps_scale):
    t = full(o[0], f(t_min))
    done = torch.zeros_like(o[0], dtype=torch.bool)
    hit = torch.zeros_like(done)
    for _ in range(max_steps):
        if bool(done.all()):
            break
        h = eval_sdf(obj, (o[0] + t * d[0], o[1] + t * d[1],
                           o[2] + t * d[2]))
        hit_now = h < (f(hit_eps) + f(eps_scale) * t)
        done_new = done | hit_now | (t > t_max)
        t = torch.where(done_new, t, t + h)
        hit = hit | (hit_now & ~done)
        done = done_new
    return torch.where(hit, t, full(t, BIG)), hit


def normal_fd(obj: Obj, p, eps):
    e = f(eps)
    s0 = eval_sdf(obj, (p[0] + e, p[1] - e, p[2] - e))
    s1 = eval_sdf(obj, (p[0] - e, p[1] - e, p[2] + e))
    s2 = eval_sdf(obj, (p[0] - e, p[1] + e, p[2] - e))
    s3 = eval_sdf(obj, (p[0] + e, p[1] + e, p[2] + e))
    return normalize((((s0 - s1) - s2) + s3, ((-s0 - s1) + s2) + s3,
                      ((-s0 + s1) - s2) + s3))


# -------------------------------------------------------------------- mesh

class MeshTables:
    """A mesh's triangles as tensors, and its area-weighted vertex normals
    worked out on the host in float32."""

    def __init__(self, mesh: Mesh, device, dtype):
        v = np.asarray(mesh.vertices, np.float32)
        fc = np.asarray(mesh.faces, np.int64)
        v0, v1, v2 = v[fc[:, 0]], v[fc[:, 1]], v[fc[:, 2]]
        gn = np.cross(v1 - v0, v2 - v0)
        vn = np.zeros_like(v)
        for k in range(3):
            np.add.at(vn, fc[:, k], gn)
        vn = vn / np.maximum(np.sqrt((vn * vn).sum(-1, keepdims=True)),
                             np.float32(1e-20))
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                      device=device).to(dtype)
        self.smooth = mesh.smooth
        self.v0, self.e1, self.e2 = t(v0), t(v1 - v0), t(v2 - v0)
        self.faces = torch.as_tensor(fc, device=device)
        self.vn = t(vn.astype(np.float32))
        self.count = len(fc)

    def intersect(self, o, d, t_min, t_max):
        """Nearest hit over every triangle (Moller-Trumbore, determinant
        guard 1e-7); ties go to the lower triangle index."""
        t_best = full(o[0], BIG)
        tri_best = torch.zeros_like(o[0], dtype=torch.int64)
        oc = [x[:, None] for x in o]
        dc = [x[:, None] for x in d]
        if isinstance(t_max, torch.Tensor):
            t_max = t_max[:, None]
        for s in range(0, self.count, TRI_CHUNK):
            sl = slice(s, s + TRI_CHUNK)
            v0 = [self.v0[sl, k][None, :] for k in range(3)]
            e1 = [self.e1[sl, k][None, :] for k in range(3)]
            e2 = [self.e2[sl, k][None, :] for k in range(3)]
            pv = cross(dc, e2)
            det = dot(e1, pv)
            ok = torch.abs(det) > f(1e-7)
            inv_det = 1.0 / torch.where(ok, det, 1.0)
            tv = (oc[0] - v0[0], oc[1] - v0[1], oc[2] - v0[2])
            u = dot(tv, pv) * inv_det
            qv = cross(tv, e1)
            v = dot(dc, qv) * inv_det
            t = dot(e2, qv) * inv_det
            okf = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                   & (t > t_min) & (t < t_max))
            t = torch.where(okf, t, BIG)
            tmin, arg = t.min(dim=1)
            better = tmin < t_best
            t_best = torch.where(better, tmin, t_best)
            tri_best = torch.where(better, arg + s, tri_best)
        return t_best, tri_best

    def corners(self, tri):
        return ([self.v0[tri, k] for k in range(3)],
                [self.e1[tri, k] for k in range(3)],
                [self.e2[tri, k] for k in range(3)])

    def normal(self, p, tri):
        """Barycentric mix of the vertex normals (smooth) or the face
        normal."""
        v0, e1, e2 = self.corners(tri)
        if not self.smooth:
            return normalize(cross(e1, e2))
        w = (p[0] - v0[0], p[1] - v0[1], p[2] - v0[2])
        d11, d12, d22 = dot(e1, e1), dot(e1, e2), dot(e2, e2)
        dw1, dw2 = dot(w, e1), dot(w, e2)
        den = d11 * d22 - d12 * d12
        den = torch.where(torch.abs(den) < f(1e-20), f(1e-20), den)
        u = (d22 * dw1 - d12 * dw2) / den
        v = (d11 * dw2 - d12 * dw1) / den
        wb = (1.0 - u) - v
        n0, n1, n2 = (self.vn[self.faces[tri, k]] for k in range(3))
        return normalize(tuple((wb * n0[:, k] + u * n1[:, k]) + v * n2[:, k]
                               for k in range(3)))

    def face_normal(self, tri):
        _v0, e1, e2 = self.corners(tri)
        return normalize(cross(e1, e2))


# ------------------------------------------------------- secondary effects

def soft_shadow(sdf_fn, o, d, t_min, t_max, k, steps):
    t = full(o[0], f(t_min))
    res = torch.ones_like(o[0])
    done = t > t_max
    for _ in range(steps):
        if bool(done.all()):
            break
        h = sdf_fn((o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2]))
        res_new = torch.minimum(res, k * h / t)
        allowed = (k * h - res_new * t) / (k + res_new)
        step = torch.minimum(torch.maximum(h, full(h, f(1e-3))),
                             allowed.clamp_min(0.5))
        t_new = t + step
        done_new = done | (res_new < f(0.004)) | (t_new > t_max)
        res = torch.where(done, res, res_new)
        t = torch.where(done, t, t_new)
        done = done_new
    return saturate(res)


def ambient_occlusion(sdf_fn, p, n, samples, radius, strength):
    samples = min(samples, len(AO_DIRS))
    big_y = torch.abs(n[1]) > f(0.9)
    hx = torch.where(big_y, 1.0, 0.0).to(n[0].dtype)
    hy = torch.where(big_y, 0.0, 1.0).to(n[0].dtype)
    t1 = normalize((hy * n[2], -hx * n[2], hx * n[1] - hy * n[0]))
    t2 = cross(n, t1)
    occ = torch.zeros_like(p[0])
    rad = np.float32(radius)
    for si in range(samples):
        ax, ay, az = (f(x) for x in AO_DIRS[si])
        dx = (ax * t1[0] + ay * t2[0]) + az * n[0]
        dy = (ax * t1[1] + ay * t2[1]) + az * n[1]
        dz = (ax * t1[2] + ay * t2[2]) + az * n[2]
        for tap in range(1, 5):
            rr = float(rad * np.float32(tap) * np.float32(0.25))
            h = sdf_fn((p[0] + dx * rr, p[1] + dy * rr, p[2] + dz * rr))
            occ = occ + (float(np.float32(az) * np.float32(rr)) - h
                         ).clamp_min(0.0) / rr
    occ = occ / float(samples * 4)
    return saturate(1.0 - f(strength) * occ)


# ------------------------------------------------------------------ frame

def render_rays(scene, settings: dict, o, d, dtype=torch.float32):
    """Rays (o, d: tuples of three (N,) tensors) through `scene` -> dict
    of (N, ...) tensors rgb, depth, normal, hit, obj_id, every value held
    in `dtype` (obj_id int32)."""
    S = settings
    o = tuple(x.to(dtype) for x in o)
    d = tuple(x.to(dtype) for x in d)
    dev = o[0].device
    objs = [Obj(so) for so in scene.objects]
    meshes = {i: MeshTables(ob.mesh, dev, dtype)
              for i, ob in enumerate(objs) if ob.mesh is not None}

    def trace(o, d, t_min, t_max):
        t_best = full(o[0], BIG)
        obj_best = torch.full_like(o[0], -1, dtype=torch.int32)
        leaf_best = torch.zeros_like(o[0], dtype=torch.int64)
        for i, ob in enumerate(objs):
            if ob.mesh is not None:
                t_i, leaf_i = meshes[i].intersect(o, d, t_min, t_max)
            elif ob.is_sdf:
                t_i, _ = sphere_trace(ob, o, d, t_min, t_max,
                                      S["max_steps"], S["hit_eps"],
                                      S["hit_eps_scale"])
                leaf_i = torch.zeros_like(leaf_best)
            else:
                t_i, leaf_i = _intersect_analytic(ob, o, d, t_min, t_max)
                leaf_i = leaf_i.to(torch.int64)
            better = t_i < t_best
            t_best = torch.where(better, t_i, t_best)
            obj_best = torch.where(better, i, obj_best).to(torch.int32)
            leaf_best = torch.where(better, leaf_i, leaf_best)
        return t_best, obj_best, leaf_best, t_best < BIG * 0.5

    t_raw, obj_id, leaf_id, mask = trace(o, d, f(S["t_min"]), f(S["t_max"]))
    t = torch.where(mask, t_raw, 0.0).to(dtype)
    p = tuple(o[k] + t * d[k] for k in range(3))

    nrm = [torch.zeros_like(p[0]), torch.zeros_like(p[0]),
           torch.ones_like(p[0])]

    def put(vec, sel, new):
        for k in range(3):
            vec[k] = torch.where(sel, new[k], vec[k])

    def tri_of(i):
        return torch.where(obj_id == i, leaf_id, 0).clamp(
            0, meshes[i].count - 1)

    for i, ob in enumerate(objs):
        sel = obj_id == i
        if not bool(sel.any()):
            continue
        if ob.mesh is not None:
            n_i = meshes[i].normal(p, tri_of(i))
        elif not ob.is_sdf and S["normals"] == "auto":
            n_i = [torch.zeros_like(p[0]) for _ in range(3)]
            for li, (leaf, sign) in enumerate(ob.leaves):
                n_l = _leaf_normal(leaf, p)
                put(n_i, leaf_id == li, tuple(x * float(sign) for x in n_l))
        else:
            n_i = normal_fd(ob, p, S["normal_eps"])
        put(nrm, sel, n_i)
    s = torch.where(dot(nrm, d) > 0.0, -1.0, 1.0).to(dtype)
    n = tuple(x * s for x in nrm)

    # secondary origins leave meshes along the geometric normal
    n_off = list(n)
    for i in meshes:
        gn = meshes[i].face_normal(tri_of(i))
        gs = torch.where(dot(gn, d) > 0.0, -1.0, 1.0).to(dtype)
        put(n_off, obj_id == i, tuple(x * gs for x in gn))
    eps = f(S["shadow_eps"])
    p_off = tuple(p[k] + n_off[k] * eps for k in range(3))

    nonmesh = [ob for ob in objs if ob.mesh is None]

    def scene_sdf(q):
        v = eval_sdf(nonmesh[0], q)
        for ob in nonmesh[1:]:
            v = torch.minimum(v, eval_sdf(ob, q))
        return v

    light_terms = []
    for lt in scene.lights:
        if isinstance(lt, PointLight):
            lp = tuple(f(v) for v in lt.position)
            lv = tuple(lp[k] - p_off[k] for k in range(3))
            dist = torch.sqrt(dot(lv, lv))
            inv = 1.0 / dist
            l = tuple(x * inv for x in lv)
        else:
            dd, _ln = _unit(lt.direction)
            l = tuple(full(p_off[0], -x) for x in dd)
            dist = full(p_off[0], f(S["t_max"]))
        lcol = tuple(f(v) for v in lt.color)
        vis = torch.ones_like(p_off[0])
        if S["shadows"] and objs:
            if S["soft_shadows"] and nonmesh:
                radius = lt.radius if isinstance(lt, PointLight) else 0.0
                k = dist / f(radius) if radius > 0.0 else \
                    full(dist, f(S["soft_shadow_k"]))
                vis = vis * soft_shadow(scene_sdf, p_off, l,
                                        S["soft_shadow_tmin"], dist, k,
                                        S["shadow_steps"])
                for i in meshes:
                    t_i, _ = meshes[i].intersect(p_off, l, eps, dist)
                    vis = vis * torch.where(t_i < dist, 0.0, 1.0).to(dtype)
            else:
                t_s, _, _, m_s = trace(p_off, l, eps, dist)
                vis = vis * torch.where(m_s & (t_s < dist), 0.0, 1.0
                                        ).to(dtype)
        light_terms.append((l, lcol, vis))

    if S["ao"] and nonmesh:
        ao = ambient_occlusion(scene_sdf, p_off, n, S["ao_samples"],
                               S["ao_radius"], S["ao_strength"])
    else:
        ao = torch.ones_like(p[0])

    v = tuple(-x for x in d)
    amb = tuple(f(x) for x in scene.ambient)
    rgb = [full(p[0], f(S["background"][k])) for k in range(3)]
    for i, ob in enumerate(objs):
        m = ob.material
        alb = tuple(np.float32(x) for x in m.albedo)
        spc = tuple(f(x) for x in m.specular_color)
        ka, kd, ks = np.float32(m.ka), f(m.kd), f(m.ks)
        col = [float(ka * alb[k] * np.float32(amb[k])) * ao
               for k in range(3)]
        for l, lc, vis in light_terms:
            diff = kd * dot(n, l).clamp_min(0.0)
            hh = tuple(l[k] + v[k] for k in range(3))
            inv_h = 1.0 / torch.sqrt(dot(hh, hh).clamp_min(f(1e-20)))
            h = tuple(x * inv_h for x in hh)
            spec = ks * pow_int(dot(n, h).clamp_min(0.0), m.shininess)
            for k in range(3):
                col[k] = col[k] + vis * lc[k] * (diff * float(alb[k])
                                                 + spec * spc[k])
        put(rgb, mask & (obj_id == i), col)
    hitf = mask.to(dtype)
    return {"rgb": torch.stack(rgb, dim=-1),
            "depth": t,
            "normal": torch.stack([x * hitf for x in n], dim=-1),
            "hit": hitf,
            "obj_id": torch.where(mask, obj_id, -1).to(torch.int32)}


def camera_rays(intr, R_flats, positions, frame, rows, cols, dtype):
    """Rays of pixels (rows, cols) of frames `frame` (index tensors of one
    shape): frame f seen from R_flats[f] (row-major world_from_cam) and
    positions[f] -> (o, d) tuples of three tensors in `dtype`."""
    R = R_flats.to(dtype)[frame]
    P = positions.to(dtype)[frame]
    xc = ((cols.to(dtype) + 0.5) - f(intr.cx)) / f(intr.fx)
    yc = ((rows.to(dtype) + 0.5) - f(intr.cy)) / f(intr.fy)
    dx = (R[:, 0] * xc + R[:, 1] * yc) + R[:, 2]
    dy = (R[:, 3] * xc + R[:, 4] * yc) + R[:, 5]
    dz = (R[:, 6] * xc + R[:, 7] * yc) + R[:, 8]
    return (P[:, 0], P[:, 1], P[:, 2]), normalize((dx, dy, dz))
