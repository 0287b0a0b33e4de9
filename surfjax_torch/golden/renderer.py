"""Golden CPU reference renderer: the NumPy oracle (SURVEY.md §2
component 21), a copy of `surfjax/golden/renderer.py` over this package's
`api` scene graph.

An *independent* NumPy implementation of the renderer semantics: the
pixel-exactness oracle (<=1 ULP shading error, BASELINE.json:5). It walks
the `surfjax_torch.api` scene graph itself and deliberately imports none of
the port's math, engines, pipeline or kernels, so a bit-level agreement
between this module and the device renderer is meaningful evidence
(SURVEY.md §3.5: "independent implementation is what makes <=1-ULP
comparison meaningful").

It runs in NumPy on the host, never on the card: it is the oracle the
card's frames are held against, not a device path (`render --golden`).

FP discipline is the shared *definition* both implementations follow:
float32 throughout, dot products associated as ((x*x + y*y) + z*z),
normalize = v * (1/sqrt(dot)), integer specular powers by repeated squaring.
Deliberately boring, never optimized.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from surfjax_torch import api
from surfjax_torch.core.types import RenderSettings

F = np.float32
BIG = np.float32(1e30)

# local opcode aliases (shared *data model* with api, not shared math code)
OP_LEAF = api.OP_LEAF
OP_UNION = api.OP_UNION
OP_INTERSECT = api.OP_INTERSECT
OP_SUBTRACT = api.OP_SUBTRACT
OP_SMOOTH_UNION = api.OP_SMOOTH_UNION
OP_SMOOTH_INTERSECT = api.OP_SMOOTH_INTERSECT
OP_SMOOTH_SUBTRACT = api.OP_SMOOTH_SUBTRACT
_SMOOTH = (OP_SMOOTH_UNION, OP_SMOOTH_INTERSECT, OP_SMOOTH_SUBTRACT)


def _dot(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _normalize(v):
    inv = F(1.0) / np.sqrt(_dot(v, v))
    return (v[0] * inv, v[1] * inv, v[2] * inv)


def _pow_int(x, n: int):
    n = int(n)
    if n == 0:
        return np.ones_like(x)
    result = None
    base = x
    while n:
        if n & 1:
            result = base if result is None else result * base
        n >>= 1
        if n:
            base = base * base
    return result


def _saturate(x):
    return np.minimum(np.maximum(x, F(0.0)), F(1.0))


def _clamp(x, lo, hi):
    return np.minimum(np.maximum(x, lo), hi)


def _mix(a, b, t):
    return a + (b - a) * t


# ---------------------------------------------------------------------------
# Scene flattening (golden-local; mirrors the data model only)
# ---------------------------------------------------------------------------

class _Leaf:
    def __init__(self, node, sign):
        self.node = node
        self.sign = sign


class _Obj:
    def __init__(self, scene_obj: api.SceneObject):
        self.material = scene_obj.material
        self.is_mesh = isinstance(scene_obj.node, api.TriangleMesh)
        self.mesh = scene_obj.node if self.is_mesh else None
        self.leaves: List[_Leaf] = []
        self.nodes: List[Tuple[int, int, int, int, float]] = []
        self.is_sdf = False
        if not self.is_mesh:
            self._walk(scene_obj.node, +1)
            self.is_sdf = (scene_obj.engine == "sdf") or self._needs_sdf(
                scene_obj.node)

    def _needs_sdf(self, n):
        if isinstance(n, api.Mandelbulb):
            return True
        if isinstance(n, api.CSG):
            if n.op in _SMOOTH:
                return True
            return self._needs_sdf(n.a) or self._needs_sdf(n.b)
        return False

    def _walk(self, n, sign):
        if isinstance(n, api.CSG):
            ia = self._walk(n.a, sign)
            flip = -sign if n.op in (OP_SUBTRACT, OP_SMOOTH_SUBTRACT) else sign
            ib = self._walk(n.b, flip)
            self.nodes.append((n.op, ia, ib, -1, float(n.k)))
            return len(self.nodes) - 1
        self.leaves.append(_Leaf(n, sign))
        self.nodes.append((OP_LEAF, -1, -1, len(self.leaves) - 1, 0.0))
        return len(self.nodes) - 1


# ---------------------------------------------------------------------------
# Analytic leaf intervals + event CSG (mirrors engines/analytic.py semantics)
# ---------------------------------------------------------------------------

def _quad_roots(b_half, c):
    disc = b_half * b_half - c
    has = disc >= F(0.0)
    sq = np.sqrt(np.maximum(disc, F(0.0)))
    s = np.where(b_half >= F(0.0), F(1.0), F(-1.0))
    q = -(b_half + s * sq)
    r0 = q
    r1 = np.where(q != F(0.0), c / q, -b_half)
    t0 = np.minimum(r0, r1)
    t1 = np.maximum(r0, r1)
    t0 = np.where(has, t0, BIG)
    t1 = np.where(has, t1, -BIG)
    return t0, t1


def _leaf_interval(leaf: _Leaf, o, d):
    n = leaf.node
    if isinstance(n, api.Sphere):
        c = tuple(F(v) for v in n.center)
        r = F(n.radius)
        oc = (o[0] - c[0], o[1] - c[1], o[2] - c[2])
        b = _dot(oc, d)
        cc = _dot(oc, oc) - r * r
        return _quad_roots(b, cc)
    if isinstance(n, api.Plane):
        nrm = np.asarray(n.normal, np.float64)
        ln = np.sqrt(np.dot(nrm, nrm))
        nrm = (nrm / ln).astype(np.float32)
        # offset rescales with the normal (see scene_compile._leaf_row)
        off = F(float(n.offset) / ln)
        denom = _dot((F(nrm[0]), F(nrm[1]), F(nrm[2])), d)
        no = _dot((F(nrm[0]), F(nrm[1]), F(nrm[2])), o)
        safe = np.where(denom == F(0.0), F(1.0), denom)
        t_star = (off - no) / safe
        inside = (no - off) < F(0.0)
        t0 = np.where(denom < F(0.0), t_star, -BIG)
        t1 = np.where(denom < F(0.0), BIG, t_star)
        t0 = np.where(denom == F(0.0), np.where(inside, -BIG, BIG), t0)
        t1 = np.where(denom == F(0.0), np.where(inside, BIG, -BIG), t1)
        return t0, t1
    if isinstance(n, api.Box):
        c = tuple(F(v) for v in n.center)
        h = tuple(F(v) for v in n.half_extents)
        t0 = np.full_like(o[0], -BIG)
        t1 = np.full_like(o[0], BIG)
        for ax in range(3):
            dz = d[ax] == F(0.0)
            safe = np.where(dz, F(1.0), d[ax])
            inv = F(1.0) / safe
            lo = (c[ax] - h[ax] - o[ax]) * inv
            hi = (c[ax] + h[ax] - o[ax]) * inv
            tn = np.minimum(lo, hi)
            tf = np.maximum(lo, hi)
            in_slab = np.abs(o[ax] - c[ax]) <= h[ax]
            tn = np.where(dz, np.where(in_slab, -BIG, BIG), tn)
            tf = np.where(dz, np.where(in_slab, BIG, -BIG), tf)
            t0 = np.maximum(t0, tn)
            t1 = np.minimum(t1, tf)
        empty = t0 > t1
        t0 = np.where(empty, BIG, t0)
        t1 = np.where(empty, -BIG, t1)
        return t0, t1
    raise TypeError(f"analytic golden: unsupported leaf {type(n).__name__}")


def _eval_bool_tree(obj: _Obj, statuses):
    vals = []
    for (op, a, b, leaf, _k) in obj.nodes:
        if op == OP_LEAF:
            vals.append(statuses[leaf])
        elif op == OP_UNION:
            vals.append(vals[a] | vals[b])
        elif op == OP_INTERSECT:
            vals.append(vals[a] & vals[b])
        elif op == OP_SUBTRACT:
            vals.append(vals[a] & (~vals[b]))
        else:
            raise ValueError("smooth op in analytic golden")
    return vals[-1]


def _intersect_analytic(obj: _Obj, o, d, t_min, t_max):
    n_leaves = len(obj.leaves)
    intervals = [_leaf_interval(lf, o, d) for lf in obj.leaves]
    if n_leaves == 1 and len(obj.nodes) == 1:
        t0, t1 = intervals[0]
        e0 = (t0 > t_min) & (t0 < t_max)
        e1 = (t1 > t_min) & (t1 < t_max)
        t = np.where(e0, t0, np.where(e1, t1, BIG))
        return t, np.zeros_like(t, np.int32)
    t_best = np.full_like(o[0], BIG)
    leaf_best = np.zeros_like(o[0], dtype=np.int32)
    for li in range(n_leaves):
        for endpoint in range(2):
            t_e = intervals[li][endpoint]
            statuses_before = []
            statuses_after = []
            for lj in range(n_leaves):
                if lj == li:
                    before = endpoint == 1
                    shaped = np.full_like(t_e, before, dtype=bool)
                    statuses_before.append(shaped)
                    statuses_after.append(~shaped)
                else:
                    tj0, tj1 = intervals[lj]
                    inside_j = (tj0 < t_e) & (t_e < tj1)
                    statuses_before.append(inside_j)
                    statuses_after.append(inside_j)
            flip = _eval_bool_tree(obj, statuses_before) ^ _eval_bool_tree(
                obj, statuses_after)
            valid = flip & (t_e > t_min) & (t_e < t_max)
            better = valid & (t_e < t_best)
            t_best = np.where(better, t_e, t_best)
            leaf_best = np.where(better, np.int32(li), leaf_best)
    return t_best, leaf_best


def _leaf_normal(leaf: _Leaf, p):
    n = leaf.node
    if isinstance(n, api.Sphere):
        c = tuple(F(v) for v in n.center)
        return _normalize((p[0] - c[0], p[1] - c[1], p[2] - c[2]))
    if isinstance(n, api.Plane):
        nrm = np.asarray(n.normal, np.float64)
        nrm = (nrm / np.sqrt(np.dot(nrm, nrm))).astype(np.float32)
        shaped = np.ones_like(p[0])
        return (F(nrm[0]) * shaped, F(nrm[1]) * shaped, F(nrm[2]) * shaped)
    if isinstance(n, api.Box):
        c = tuple(F(v) for v in n.center)
        h = tuple(F(v) for v in n.half_extents)
        q = (p[0] - c[0], p[1] - c[1], p[2] - c[2])
        dx = np.abs(q[0]) - h[0]
        dy = np.abs(q[1]) - h[1]
        dz = np.abs(q[2]) - h[2]
        sx = np.where(q[0] >= F(0.0), F(1.0), F(-1.0))
        sy = np.where(q[1] >= F(0.0), F(1.0), F(-1.0))
        sz = np.where(q[2] >= F(0.0), F(1.0), F(-1.0))
        x_wins = (dx >= dy) & (dx >= dz)
        y_wins = (~x_wins) & (dy >= dz)
        zero = np.zeros_like(dx)
        return (np.where(x_wins, sx, zero),
                np.where(y_wins, sy, zero),
                np.where(x_wins | y_wins, zero, sz))
    raise TypeError(f"golden normal: unsupported leaf {type(n).__name__}")


# ---------------------------------------------------------------------------
# SDF evaluation (mirrors engines/sdf.py semantics)
# ---------------------------------------------------------------------------

def _leaf_sdf(leaf: _Leaf, p):
    n = leaf.node
    if isinstance(n, api.Sphere):
        c = tuple(F(v) for v in n.center)
        q = (p[0] - c[0], p[1] - c[1], p[2] - c[2])
        return np.sqrt(_dot(q, q)) - F(n.radius)
    if isinstance(n, api.Plane):
        nrm = np.asarray(n.normal, np.float64)
        ln = np.sqrt(np.dot(nrm, nrm))
        nrm = (nrm / ln).astype(np.float32)
        # offset rescales with the normal (see scene_compile._leaf_row)
        return (_dot((F(nrm[0]), F(nrm[1]), F(nrm[2])), p)
                - F(float(n.offset) / ln))
    if isinstance(n, api.Box):
        c = tuple(F(v) for v in n.center)
        h = tuple(F(v) for v in n.half_extents)
        qx = np.abs(p[0] - c[0]) - h[0]
        qy = np.abs(p[1] - c[1]) - h[1]
        qz = np.abs(p[2] - c[2]) - h[2]
        ox = np.maximum(qx, F(0.0))
        oy = np.maximum(qy, F(0.0))
        oz = np.maximum(qz, F(0.0))
        outside = np.sqrt((ox * ox + oy * oy) + oz * oz)
        inside = np.minimum(np.maximum(qx, np.maximum(qy, qz)), F(0.0))
        return outside + inside
    if isinstance(n, api.Mandelbulb):
        return _sdf_mandelbulb(n, p)
    raise TypeError(f"golden sdf: unsupported leaf {type(n).__name__}")


# Bitwise-portable log — the NumPy mirror of core.math.portable_log
# (RenderSettings.bulb_log == "portable"): identical reduction,
# identical coefficient values, identical two-round association, so the
# oracle's bulb-DE epilogue log matches the kernel's bit for bit
# (tests/test_portable_log.py pins all three mirrors). Independently
# written per the oracle-independence rule — the ALGORITHM is shared by
# spec, the code is not.
_PLOG_C = tuple(np.float32(v) for v in (
    -0.4999999701976776, 0.33333322405815125, -0.2500077188014984,
    0.2000196874141693, -0.1662759929895401, 0.1418900042772293,
    -0.131016343832016, 0.12821748852729797, -0.07866667956113815))
_PLOG_LN2_HI = np.float32(0.6931457519531250)
_PLOG_LN2_LO = np.float32(1.4286067653301955e-06)
_PLOG_SQRTH = np.float32(0.7071067811865476)

# set by render() from settings.bulb_log; all worker threads of
# render_parallel share one settings, so the module flag is benign
_PORTABLE_LOG = False


def _portable_log(x):
    x = np.asarray(x, np.float32)
    bits = x.view(np.int32)
    e = ((bits >> 23) & np.int32(0xFF)) - np.int32(126)
    f = ((bits & np.int32(0x007FFFFF)) | np.int32(0x3F000000)).view(
        np.float32)
    small = f < _PLOG_SQRTH
    f = np.where(small, f + f, f).astype(np.float32)
    e = np.where(small, e - np.int32(1), e)
    ef = e.astype(np.float32)
    u = f - np.float32(1.0)
    g = np.full_like(u, _PLOG_C[8])
    for c in _PLOG_C[7::-1]:
        g = g * u + c
    u2 = u * u
    l1p = u + u2 * g
    return ef * _PLOG_LN2_HI + (l1p + ef * _PLOG_LN2_LO)


def _sdf_mandelbulb_general(n: api.Mandelbulb, p):
    """General power-n trig-form DE (engines/sdf.sdf_mandelbulb_general)."""
    c = tuple(F(v) for v in n.center)
    scale = F(n.scale)
    bailout2 = F(n.bailout) * F(n.bailout) * F(16.0)
    inv_s = F(1.0) / scale
    px = (p[0] - c[0]) * inv_s
    py = (p[1] - c[1]) * inv_s
    pz = (p[2] - c[2]) * inv_s
    pw = F(float(n.power))
    wx, wy, wz = px.copy(), py.copy(), pz.copy()
    m = (wx * wx + wy * wy) + wz * wz
    dz = np.ones_like(m)
    escaped = m > bailout2
    tiny = F(1e-12)
    with np.errstate(invalid="ignore", over="ignore"):
        for _ in range(n.iterations):
            active = ~escaped
            r = np.sqrt(np.maximum(m, tiny))
            rp1 = np.exp(F(float(n.power - 1)) * np.log(r))
            dz_new = pw * rp1 * dz + F(1.0)
            theta = np.arccos(np.clip(wz / r, F(-1.0), F(1.0))) * pw
            phi = np.arctan2(wy, wx) * pw
            zr = rp1 * r
            st = np.sin(theta)
            wx_new = px + zr * (st * np.cos(phi))
            wy_new = py + zr * (st * np.sin(phi))
            wz_new = pz + zr * np.cos(theta)
            wx = np.where(active, wx_new, wx)
            wy = np.where(active, wy_new, wy)
            wz = np.where(active, wz_new, wz)
            dz = np.where(active, dz_new, dz)
            m = np.where(active, (wx * wx + wy * wy) + wz * wz, m)
            escaped = escaped | (m > bailout2)
    r = np.sqrt(np.maximum(m, tiny))
    de = F(0.25) * np.log(np.maximum(m, tiny)) * r / dz
    r0 = np.sqrt((px * px + py * py) + pz * pz)
    far = r0 - F(1.35)
    de = np.where(far > F(0.0), np.minimum(de, far + F(0.1)), de)
    return de * scale


def _sdf_mandelbulb(n: api.Mandelbulb, p):
    if n.power != 8:
        return _sdf_mandelbulb_general(n, p)
    c = tuple(F(v) for v in n.center)
    scale = F(n.scale)
    bailout2 = F(n.bailout) * F(n.bailout) * F(16.0)
    inv_s = F(1.0) / scale
    px = (p[0] - c[0]) * inv_s
    py = (p[1] - c[1]) * inv_s
    pz = (p[2] - c[2]) * inv_s
    wx, wy, wz = px.copy(), py.copy(), pz.copy()
    m = (wx * wx + wy * wy) + wz * wz
    dz = np.ones_like(m)
    escaped = m > bailout2
    tiny = F(1e-4)  # k3^7 must not underflow f32
    # escaped lanes overflow harmlessly (masked by `active`); mirror the
    # silent masked-lane semantics of the device path. with-block so the
    # thread's error state is restored (review r3: __enter__ without
    # __exit__ leaked ignore-state into the whole process)
    with np.errstate(invalid="ignore", over="ignore"):
      for _ in range(n.iterations):
          active = ~escaped
          m2 = m * m
          m4 = m2 * m2
          dz_new = F(8.0) * np.sqrt((m4 * m2) * m) * dz + F(1.0)
          x, y, z = wx, wy, wz
          x2 = x * x
          x4 = x2 * x2
          y2 = y * y
          y4 = y2 * y2
          z2 = z * z
          z4 = z2 * z2
          k3 = x2 + z2
          k3s = np.maximum(k3, tiny)
          k37 = ((k3s * k3s) * (k3s * k3s)) * ((k3s * k3s) * k3s)
          k2 = F(1.0) / np.sqrt(k37)
          k1 = ((x4 + y4) + z4) - F(6.0) * (y2 * z2) \
              - F(6.0) * (x2 * y2) + F(2.0) * (z2 * x2)
          k4 = (x2 - y2) + z2
          wx_new = px + F(64.0) * ((((x * y) * z) * (x2 - z2)) * k4) \
              * ((x4 - F(6.0) * (x2 * z2)) + z4) * k1 * k2
          wy_new = py + (F(-16.0) * (y2 * k3) * (k4 * k4) + k1 * k1)
          wz_new = pz + F(-8.0) * (y * k4) \
              * ((((x4 * x4) - F(28.0) * ((x4 * x2) * z2))
                  + F(70.0) * (x4 * z4))
                 - F(28.0) * ((x2 * z2) * z4) + (z4 * z4)) * k1 * k2
          wx = np.where(active, wx_new, wx)
          wy = np.where(active, wy_new, wy)
          wz = np.where(active, wz_new, wz)
          dz = np.where(active, dz_new, dz)
          m = np.where(active, (wx * wx + wy * wy) + wz * wz, m)
          escaped = escaped | (m > bailout2)
    r = np.sqrt(m)
    # max(m, 1e-30): same guard as engines/sdf (de exactly 0 at m == 0
    # instead of log(0)*0 = NaN); identical for every normal m
    log_fn = _portable_log if _PORTABLE_LOG else np.log
    de = F(0.25) * log_fn(np.maximum(m, F(1e-30))) * r / dz
    # far-field guard -- see engines/sdf.sdf_mandelbulb
    r0 = np.sqrt((px * px + py * py) + pz * pz)
    far = r0 - F(1.35)
    de = np.where(far > F(0.0), np.minimum(de, far + F(0.1)), de)
    return de * scale


def _eval_sdf(obj: _Obj, p):
    vals = []
    for (op, a, b, leaf, k) in obj.nodes:
        if op == OP_LEAF:
            vals.append(_leaf_sdf(obj.leaves[leaf], p))
        elif op == OP_UNION:
            vals.append(np.minimum(vals[a], vals[b]))
        elif op == OP_INTERSECT:
            vals.append(np.maximum(vals[a], vals[b]))
        elif op == OP_SUBTRACT:
            vals.append(np.maximum(vals[a], -vals[b]))
        elif op == OP_SMOOTH_UNION:
            kf = F(k)
            h = _saturate(F(0.5) + F(0.5) * (vals[b] - vals[a]) / kf)
            vals.append(_mix(vals[b], vals[a], h) - kf * h * (F(1.0) - h))
        elif op == OP_SMOOTH_INTERSECT:
            kf = F(k)
            h = _saturate(F(0.5) - F(0.5) * (vals[b] - vals[a]) / kf)
            vals.append(_mix(vals[b], vals[a], h) + kf * h * (F(1.0) - h))
        elif op == OP_SMOOTH_SUBTRACT:
            kf = F(k)
            h = _saturate(F(0.5) - F(0.5) * (vals[b] + vals[a]) / kf)
            vals.append(_mix(vals[a], -vals[b], h) + kf * h * (F(1.0) - h))
        else:
            raise ValueError(f"unknown op {op}")
    return vals[-1]


def _sphere_trace(obj: _Obj, o, d, t_min, t_max, max_steps, hit_eps,
                  eps_scale=0.0):
    eps = F(hit_eps)
    es = F(eps_scale)
    t = np.full_like(o[0], F(t_min))
    done = np.zeros_like(o[0], dtype=bool)
    hit = np.zeros_like(o[0], dtype=bool)
    i = 0
    while i < max_steps and not done.all():
        px = o[0] + t * d[0]
        py = o[1] + t * d[1]
        pz = o[2] + t * d[2]
        h = _eval_sdf(obj, (px, py, pz))
        hit_now = h < (eps + es * t)
        over = t > t_max
        done_new = done | hit_now | over
        t = np.where(done_new, t, t + h)
        hit = hit | (hit_now & (~done))
        done = done_new
        i += 1
    return np.where(hit, t, BIG), hit


def _normal_fd(obj: _Obj, p, eps):
    e = F(eps)
    s0 = _eval_sdf(obj, (p[0] + e, p[1] - e, p[2] - e))
    s1 = _eval_sdf(obj, (p[0] - e, p[1] - e, p[2] + e))
    s2 = _eval_sdf(obj, (p[0] - e, p[1] + e, p[2] - e))
    s3 = _eval_sdf(obj, (p[0] + e, p[1] + e, p[2] + e))
    nx = ((s0 - s1) - s2) + s3
    ny = ((-s0 - s1) + s2) + s3
    nz = ((-s0 + s1) - s2) + s3
    return _normalize((nx, ny, nz))


# ---------------------------------------------------------------------------
# Mesh (uniform grid) — golden path: brute-force Moller-Trumbore over all
# triangles (deliberately boring; the grid is a device-side acceleration)
# ---------------------------------------------------------------------------

def _intersect_mesh_brute(mesh: api.TriangleMesh, o, d, t_min, t_max):
    verts = np.asarray(mesh.vertices, np.float32)
    faces = np.asarray(mesh.faces, np.int32)
    t_best = np.full_like(o[0], BIG)
    tri_best = np.zeros_like(o[0], dtype=np.int32)
    # 1e-7: the SAME determinant guard as every device path
    # (engines/mesh.py, kernels/mesh_tile.py, parallel/ring_mesh.py) —
    # a mismatched guard makes grazing-triangle hits golden-only
    eps = F(1e-7)
    for fi in range(faces.shape[0]):
        v0 = verts[faces[fi, 0]]
        v1 = verts[faces[fi, 1]]
        v2 = verts[faces[fi, 2]]
        e1 = (F(v1[0] - v0[0]), F(v1[1] - v0[1]), F(v1[2] - v0[2]))
        e2 = (F(v2[0] - v0[0]), F(v2[1] - v0[1]), F(v2[2] - v0[2]))
        # pvec = cross(d, e2)
        pv = (d[1] * e2[2] - d[2] * e2[1],
              d[2] * e2[0] - d[0] * e2[2],
              d[0] * e2[1] - d[1] * e2[0])
        det = _dot(e1, pv)
        ok = np.abs(det) > eps
        inv_det = F(1.0) / np.where(ok, det, F(1.0))
        tv = (o[0] - F(v0[0]), o[1] - F(v0[1]), o[2] - F(v0[2]))
        u = _dot(tv, pv) * inv_det
        qv = (tv[1] * e1[2] - tv[2] * e1[1],
              tv[2] * e1[0] - tv[0] * e1[2],
              tv[0] * e1[1] - tv[1] * e1[0])
        v = _dot(d, qv) * inv_det
        t = _dot(e2, qv) * inv_det
        okf = (ok & (u >= F(0.0)) & (v >= F(0.0)) & (u + v <= F(1.0))
               & (t > t_min) & (t < t_max))
        better = okf & (t < t_best)
        t_best = np.where(better, t, t_best)
        tri_best = np.where(better, np.int32(fi), tri_best)
    return t_best, tri_best


def _mesh_normal(mesh: api.TriangleMesh, p, tri_id):
    """Barycentric-interpolated vertex normals (smooth) or geometric."""
    verts = np.asarray(mesh.vertices, np.float32)
    faces = np.asarray(mesh.faces, np.int32)
    v0 = verts[faces[tri_id, 0]]
    v1 = verts[faces[tri_id, 1]]
    v2 = verts[faces[tri_id, 2]]
    e1 = (v1[..., 0] - v0[..., 0], v1[..., 1] - v0[..., 1],
          v1[..., 2] - v0[..., 2])
    e2 = (v2[..., 0] - v0[..., 0], v2[..., 1] - v0[..., 1],
          v2[..., 2] - v0[..., 2])
    if not getattr(mesh, "smooth", True):
        n = (e1[1] * e2[2] - e1[2] * e2[1],
             e1[2] * e2[0] - e1[0] * e2[2],
             e1[0] * e2[1] - e1[1] * e2[0])
        return _normalize(n)
    # area-weighted vertex normals (independent golden computation)
    gv0 = verts[faces[:, 0]]
    gv1 = verts[faces[:, 1]]
    gv2 = verts[faces[:, 2]]
    gn = np.cross(gv1 - gv0, gv2 - gv0)
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], gn)
    vl = np.sqrt((vn * vn).sum(-1, keepdims=True))
    vn = vn / np.maximum(vl, 1e-20)
    # barycentric coords of p
    wx = p[0] - v0[..., 0]
    wy = p[1] - v0[..., 1]
    wz = p[2] - v0[..., 2]
    d11 = (e1[0] * e1[0] + e1[1] * e1[1]) + e1[2] * e1[2]
    d12 = (e1[0] * e2[0] + e1[1] * e2[1]) + e1[2] * e2[2]
    d22 = (e2[0] * e2[0] + e2[1] * e2[1]) + e2[2] * e2[2]
    dw1 = (wx * e1[0] + wy * e1[1]) + wz * e1[2]
    dw2 = (wx * e2[0] + wy * e2[1]) + wz * e2[2]
    denom = d11 * d22 - d12 * d12
    denom = np.where(np.abs(denom) < F(1e-20), F(1e-20), denom)
    u = (d22 * dw1 - d12 * dw2) / denom
    v = (d11 * dw2 - d12 * dw1) / denom
    w = F(1.0) - u - v
    n0 = vn[faces[tri_id, 0]]
    n1 = vn[faces[tri_id, 1]]
    n2 = vn[faces[tri_id, 2]]
    nxs = (w * n0[..., 0] + u * n1[..., 0]) + v * n2[..., 0]
    nys = (w * n0[..., 1] + u * n1[..., 1]) + v * n2[..., 1]
    nzs = (w * n0[..., 2] + u * n1[..., 2]) + v * n2[..., 2]
    return _normalize((nxs, nys, nzs))


# ---------------------------------------------------------------------------
# AO probe directions (mirrors engines/sdf._AO_DIRS by definition)
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Full golden frame
# ---------------------------------------------------------------------------

def render(scene: api.Scene, camera: api.Camera,
           settings: RenderSettings = RenderSettings(), row_range=None):
    """Golden frame. Returns dict of numpy arrays: rgb, depth, normal, hit.

    row_range=(r0, r1) renders only image rows [r0, r1) — global row
    indices, so every per-lane value is bitwise identical to the full
    render (used by render_parallel's row blocks)."""
    global _PORTABLE_LOG
    _PORTABLE_LOG = getattr(settings, "bulb_log", "hw") == "portable"
    intr = camera.intrinsics
    H, W = intr.height, intr.width
    r0, r1 = (0, H) if row_range is None else row_range
    H = r1 - r0
    rr, cc = np.meshgrid(np.arange(r0, r1, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    rr = rr.reshape(-1)
    cc = cc.reshape(-1)
    xc = (cc + F(0.5) - F(intr.cx)) / F(intr.fx)
    yc = (rr + F(0.5) - F(intr.cy)) / F(intr.fy)
    R = np.asarray(camera.rotation, np.float32).reshape(9)
    dx = (R[0] * xc + R[1] * yc) + R[2]
    dy = (R[3] * xc + R[4] * yc) + R[5]
    dz = (R[6] * xc + R[7] * yc) + R[8]
    d = _normalize((dx, dy, dz))
    pos = np.asarray(camera.position, np.float32)
    o = (np.full_like(dx, pos[0]), np.full_like(dx, pos[1]),
         np.full_like(dx, pos[2]))

    objs = [_Obj(so) for so in scene.objects]

    def trace(o, d, t_min, t_max):
        t_best = np.full_like(o[0], BIG)
        obj_best = np.full_like(o[0], -1, dtype=np.int32)
        leaf_best = np.zeros_like(o[0], dtype=np.int32)
        for i, ob in enumerate(objs):
            if ob.is_mesh:
                t_i, leaf_i = _intersect_mesh_brute(ob.mesh, o, d,
                                                    t_min, t_max)
            elif ob.is_sdf:
                t_i, _hit = _sphere_trace(ob, o, d, t_min, t_max,
                                          settings.max_steps,
                                          settings.hit_eps,
                                          settings.hit_eps_scale)
                leaf_i = np.zeros_like(t_i, dtype=np.int32)
            else:
                t_i, leaf_i = _intersect_analytic(ob, o, d, t_min, t_max)
            better = t_i < t_best
            t_best = np.where(better, t_i, t_best)
            obj_best = np.where(better, np.int32(i), obj_best)
            leaf_best = np.where(better, leaf_i, leaf_best)
        mask = t_best < BIG * F(0.5)
        return t_best, obj_best, leaf_best, mask

    t_raw, obj_id, leaf_id, mask = trace(o, d, F(settings.t_min),
                                         F(settings.t_max))
    t = np.where(mask, t_raw, F(0.0))
    p = (o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2])

    # normals
    nx = np.zeros_like(p[0])
    ny = np.zeros_like(p[0])
    nz = np.ones_like(p[0])
    for i, ob in enumerate(objs):
        if ob.is_mesh:
            # leaf_id holds OTHER meshes' triangle ids on non-matching
            # lanes; clamp before the gather (values are discarded by sel)
            n_faces = np.asarray(ob.mesh.faces).shape[0]
            tri_safe = np.clip(np.where(obj_id == np.int32(i), leaf_id, 0),
                               0, n_faces - 1)
            n_i = _mesh_normal(ob.mesh, p, tri_safe)
        elif (not ob.is_sdf) and settings.normals == "auto":
            lnx = np.zeros_like(p[0])
            lny = np.zeros_like(p[0])
            lnz = np.zeros_like(p[0])
            for li, lf in enumerate(ob.leaves):
                n_l = _leaf_normal(lf, p)
                s = F(float(lf.sign))
                sel = leaf_id == np.int32(li)
                lnx = np.where(sel, n_l[0] * s, lnx)
                lny = np.where(sel, n_l[1] * s, lny)
                lnz = np.where(sel, n_l[2] * s, lnz)
            n_i = (lnx, lny, lnz)
        else:
            n_i = _normal_fd(ob, p, settings.normal_eps)
        sel = obj_id == np.int32(i)
        nx = np.where(sel, n_i[0], nx)
        ny = np.where(sel, n_i[1], ny)
        nz = np.where(sel, n_i[2], nz)
    flip = _dot((nx, ny, nz), d) > F(0.0)
    s = np.where(flip, F(-1.0), F(1.0))
    n = (nx * s, ny * s, nz * s)

    # secondary-ray origins offset along the GEOMETRIC normal for meshes
    # (mirrors pipeline/frame.py; avoids shadow-terminator acne)
    n_off = n
    for i, ob in enumerate(objs):
        if ob.is_mesh:
            verts = np.asarray(ob.mesh.vertices, np.float32)
            faces = np.asarray(ob.mesh.faces, np.int32)
            tri_safe = np.clip(np.where(obj_id == np.int32(i), leaf_id, 0),
                               0, faces.shape[0] - 1)
            gv0 = verts[faces[tri_safe, 0]]
            gv1 = verts[faces[tri_safe, 1]]
            gv2 = verts[faces[tri_safe, 2]]
            ge1 = (gv1[..., 0] - gv0[..., 0], gv1[..., 1] - gv0[..., 1],
                   gv1[..., 2] - gv0[..., 2])
            ge2 = (gv2[..., 0] - gv0[..., 0], gv2[..., 1] - gv0[..., 1],
                   gv2[..., 2] - gv0[..., 2])
            gn = _normalize((ge1[1] * ge2[2] - ge1[2] * ge2[1],
                             ge1[2] * ge2[0] - ge1[0] * ge2[2],
                             ge1[0] * ge2[1] - ge1[1] * ge2[0]))
            gflip = _dot(gn, d) > F(0.0)
            gs = np.where(gflip, F(-1.0), F(1.0))
            sel = obj_id == np.int32(i)
            n_off = (np.where(sel, gn[0] * gs, n_off[0]),
                     np.where(sel, gn[1] * gs, n_off[1]),
                     np.where(sel, gn[2] * gs, n_off[2]))

    eps = F(settings.shadow_eps)
    p_off = (p[0] + n_off[0] * eps, p[1] + n_off[1] * eps,
             p[2] + n_off[2] * eps)

    nonmesh = [ob for ob in objs if not ob.is_mesh]

    def scene_sdf(pp):
        v = _eval_sdf(nonmesh[0], pp)
        for ob in nonmesh[1:]:
            v = np.minimum(v, _eval_sdf(ob, pp))
        return v

    # lights
    light_terms = []
    for lt in scene.lights:
        if isinstance(lt, api.PointLight):
            lp = tuple(F(v) for v in lt.position)
            lvx = lp[0] - p_off[0]
            lvy = lp[1] - p_off[1]
            lvz = lp[2] - p_off[2]
            dist = np.sqrt((lvx * lvx + lvy * lvy) + lvz * lvz)
            inv = F(1.0) / dist
            l = (lvx * inv, lvy * inv, lvz * inv)
            lcol = tuple(F(v) for v in lt.color)
        else:
            dd = np.asarray(lt.direction, np.float64)
            dd = (dd / np.sqrt(np.dot(dd, dd))).astype(np.float32)
            l = (np.full_like(p_off[0], -dd[0]),
                 np.full_like(p_off[0], -dd[1]),
                 np.full_like(p_off[0], -dd[2]))
            dist = np.full_like(p_off[0], F(settings.t_max))
            lcol = tuple(F(v) for v in lt.color)

        vis = np.ones_like(p_off[0])
        if settings.shadows and objs:
            if settings.soft_shadows and nonmesh:
                radius = (F(lt.radius) if isinstance(lt, api.PointLight)
                          else F(0.0))
                if radius > 0.0:
                    soft_k = dist / radius
                else:
                    soft_k = np.full_like(dist, F(settings.soft_shadow_k))
                vis = vis * _soft_shadow(scene_sdf, p_off, l,
                                         settings.soft_shadow_tmin, dist,
                                         soft_k,
                                         settings.shadow_steps)
                for ob in objs:
                    if ob.is_mesh:
                        t_i, _ = _intersect_mesh_brute(
                            ob.mesh, p_off, l, F(settings.shadow_eps), dist)
                        vis = vis * np.where(t_i < dist, F(0.0), F(1.0))
            else:
                t_s, _, _, m_s = trace(p_off, l, F(settings.shadow_eps), dist)
                vis = vis * np.where(m_s & (t_s < dist), F(0.0), F(1.0))
        light_terms.append((l, lcol, vis))

    # AO
    if settings.ao and nonmesh:
        ao = _ao(scene_sdf, p_off, n, settings.ao_samples,
                 settings.ao_radius, settings.ao_strength)
    else:
        ao = np.ones_like(p[0])

    v = (-d[0], -d[1], -d[2])
    amb = tuple(F(x) for x in scene.ambient)
    bg = settings.background
    r = np.full_like(p[0], F(bg[0]))
    g = np.full_like(p[0], F(bg[1]))
    b = np.full_like(p[0], F(bg[2]))
    for i, ob in enumerate(objs):
        m = ob.material
        alb = tuple(F(x) for x in m.albedo)
        spc = tuple(F(x) for x in m.specular_color)
        ka, kd, ks = F(m.ka), F(m.kd), F(m.ks)
        ri = ka * alb[0] * amb[0] * ao
        gi = ka * alb[1] * amb[1] * ao
        bi = ka * alb[2] * amb[2] * ao
        for (l, lcol, vis) in light_terms:
            ndotl = np.maximum(_dot(n, l), F(0.0))
            diff = kd * ndotl
            # guarded half-vector (see shade.py: l == -v would NaN)
            hh = (l[0] + v[0], l[1] + v[1], l[2] + v[2])
            inv_h = F(1.0) / np.sqrt(np.maximum(_dot(hh, hh), F(1e-20)))
            h = (hh[0] * inv_h, hh[1] * inv_h, hh[2] * inv_h)
            ndoth = np.maximum(_dot(n, h), F(0.0))
            spec = ks * _pow_int(ndoth, m.shininess)
            ri = ri + vis * lcol[0] * (diff * alb[0] + spec * spc[0])
            gi = gi + vis * lcol[1] * (diff * alb[1] + spec * spc[1])
            bi = bi + vis * lcol[2] * (diff * alb[2] + spec * spc[2])
        sel = mask & (obj_id == np.int32(i))
        r = np.where(sel, ri, r)
        g = np.where(sel, gi, g)
        b = np.where(sel, bi, b)

    hitf = mask.astype(np.float32)
    return {
        "rgb": np.stack([r, g, b], axis=-1).reshape(H, W, 3),
        "depth": t.reshape(H, W),
        "normal": np.stack([n[0] * hitf, n[1] * hitf, n[2] * hitf],
                           axis=-1).reshape(H, W, 3),
        "hit": hitf.reshape(H, W),
        "obj_id": np.where(mask, obj_id, np.int32(-1)).reshape(H, W),
    }


def render_parallel(scene: api.Scene, camera: api.Camera,
                    settings: RenderSettings = RenderSettings(),
                    n_workers=None):
    """Row-block threaded golden render, bitwise identical to render():
    blocks use global row indices so every per-lane value is the same
    elementwise arithmetic, and NumPy releases the GIL on array ops so
    blocks execute concurrently. Block-level march early-exit also stops
    sky blocks early (work-only, value-exact). Asserted bitwise against
    render() in tests/test_torch_golden.py."""
    import concurrent.futures as cf
    import os

    H = camera.intrinsics.height
    n = n_workers or min(32, os.cpu_count() or 1)
    block = max(8, -(-H // (n * 4)))
    ranges = [(r, min(r + block, H)) for r in range(0, H, block)]
    if len(ranges) <= 1:
        return render(scene, camera, settings)
    with cf.ThreadPoolExecutor(n) as ex:
        parts = list(ex.map(
            lambda rg: render(scene, camera, settings, row_range=rg),
            ranges))
    return {k: np.concatenate([p[k] for p in parts], axis=0)
            for k in parts[0]}


def _soft_shadow(sdf_fn, o, d, t_min, t_max, k, steps):
    kf = k if isinstance(k, np.ndarray) else F(k)
    t = np.full_like(o[0], F(t_min))
    res = np.ones_like(o[0])
    # light nearer than t_min -> no shadow segment, visibility 1 (same
    # rule as the kernel and engines/sdf; never sample beyond the light)
    done = t > t_max
    i = 0
    while i < steps and not done.all():
        px = o[0] + t * d[0]
        py = o[1] + t * d[1]
        pz = o[2] + t * d[2]
        h = sdf_fn((px, py, pz))
        res_new = np.minimum(res, kf * h / t)
        s_allowed = (kf * h - res_new * t) / (kf + res_new)
        step = _clamp(h, F(1e-3), np.maximum(F(0.5), s_allowed))
        t_new = t + step
        done_new = done | (res_new < F(0.004)) | (t_new > t_max)
        res = np.where(done, res, res_new)
        t = np.where(done, t, t_new)
        done = done_new
        i += 1
    return _saturate(res)


def _ao(sdf_fn, p, n, samples, radius, strength):
    samples = min(samples, len(_AO_DIRS))
    big_y = np.abs(n[1]) > F(0.9)
    hx = np.where(big_y, F(1.0), F(0.0))
    hy = np.where(big_y, F(0.0), F(1.0))
    t1 = _normalize((hy * n[2], -hx * n[2], hx * n[1] - hy * n[0]))
    t2 = (n[1] * t1[2] - n[2] * t1[1],
          n[2] * t1[0] - n[0] * t1[2],
          n[0] * t1[1] - n[1] * t1[0])
    occ = np.zeros_like(p[0])
    rad = F(radius)
    for si in range(samples):
        ax, ay, az = _AO_DIRS[si]
        dx = (F(ax) * t1[0] + F(ay) * t2[0]) + F(az) * n[0]
        dy = (F(ax) * t1[1] + F(ay) * t2[1]) + F(az) * n[1]
        dz = (F(ax) * t1[2] + F(ay) * t2[2]) + F(az) * n[2]
        for tap in range(1, 5):
            rr = rad * F(tap) * F(0.25)
            h = sdf_fn((p[0] + dx * rr, p[1] + dy * rr, p[2] + dz * rr))
            occ = occ + np.maximum(F(az) * rr - h, F(0.0)) / rr
    occ = occ / F(samples * 4)
    return _saturate(F(1.0) - F(strength) * occ)
