"""The kernel paths of the pallas backend: the fused frame (KF) for
mesh-free scenes and the split pipeline (K1 -> mesh merge -> ao_fix -> K2
-> shading) for mesh scenes, each kernel with its plain PyTorch version,
its wrapper and the frame/sequence drivers.

KF (`surfjax/kernels/render_tile.py::frame_fused_kernel`) renders a whole
frame in one pass: ray generation, primary trace (exact analytic hits, then
per-object SDF marches entered at a bounding sphere), normals, AO probes,
per-light soft or hard visibility and Blinn-Phong shading. The twin below
computes the same per-pixel arithmetic on whole tensors. Where surfjax
gates per TPU tile (early exit of a while loop, a `lax.cond` skip), the
twin gates per lane; since every such gate is value-exact, a lane's
result never depends on which lanes share its batch. The CUDA kernel runs
the same per-lane program, one thread per pixel.

The split path (surfjax `_pallas_primary`, `_pallas_vis`,
`_render_padded`) runs three kernels built on the same cores:
`render_tile` (K1: trace + normals + AO of the non-mesh objects),
`trace_rays` (K2: one light's visibility) and `ao_fix` (AO again at the
receivers a mesh won), plus the mesh packet kernel of kernels/mesh_tile.py.
Shading and the merges are tensor code, as XLA code is in surfjax; the
differentiable render of diff/hybrid.py drives the same stages (its light
loop and shade tail are `_light_terms` and `_shade_padded` here).

Two more pieces ride on those paths. With settings.vector_objects the
single sphere/box objects and two-leaf SDF pairs of a scene form a "crowd"
that the cores take by loops over member rows (surfjax's `_crowd_*`
sections; "The crowd" below). With settings.prime a cone march on a
1/4-resolution grid (`prime_tile`, surfjax's `prime_tile_kernel`) finds for
every 4x4 pixel block a start t0 before which no SDF surface lies, and the
frame's SDF marches begin there.

Every wrapper (`frame_fused`, `render_tile`, `trace_rays`, `ao_fix`,
`prime_tile`) launches its CUDA kernel for CUDA tensors, counting the
launch, and runs its plain version for CPU tensors; it never falls back
from one to the other.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from surfjax_torch.api import (
    OP_INTERSECT, OP_LEAF, OP_SMOOTH_INTERSECT, OP_SMOOTH_SUBTRACT,
    OP_SMOOTH_UNION, OP_SUBTRACT, OP_UNION, SMOOTH_OPS,
)
from surfjax_torch.core.math import (
    BIG, clamp, f32, fdiv, maximum, minimum, mix, saturate, sqrt, vnormalize,
)
from surfjax_torch.core.scene_compile import (
    ENGINE_ANALYTIC, ENGINE_MESH, ENGINE_SDF, LEAF_BOX, LEAF_MANDELBULB,
    LEAF_PLANE, LEAF_SPHERE, LIGHT_DIRECTIONAL, LIGHT_POINT,
)
from surfjax_torch.core.types import FrameBuffers, RenderSettings
from surfjax_torch.engines.analytic import (
    intersect_analytic, leaf_interval, leaf_normal, object_normal_analytic,
)
from surfjax_torch.engines.sdf import (
    POWER8_ONLY_MSG, _AO_DIRS, _bulb_canonical, _new_w_cheb, _new_w_std,
    ao_tap_points, ao_tap_term, ao_terms_to_factor, eval_sdf, make_leaf_fast,
    sdf_box, sdf_sphere,
)
from surfjax_torch.kernels import record_call
from surfjax_torch.shade import shade_object

# Bulb bounding-radius factors (canonical units x leaf scale), as in
# surfjax: COVER contains the hit region {DE < 0.045*scale} and gates
# march entry/exit and the hard-shadow segment skip; LOWER is a pointwise
# lower bound of the DE and gates influence windows and the AO far gate.
BULB_BOUND_COVER = 1.3
BULB_BOUND_LOWER = 1.39
_PROXY_SWITCH = 0.08   # default entry-shell inflation of a bound sphere

# Fixed per-thread bounds of the CUDA kernel (csrc/frame_fused.cuh).
MAX_TAPE_NODES = 32    # value array of the tape walker
MAX_ANALYTIC_LEAVES = 16   # interval arrays of the event CSG
MAX_OBJECTS = 64       # AO near-object bit mask
LANES = 128            # lanes of a padded split-path ray row, as in surfjax


# --- operation counts -------------------------------------------------------
# While `count_ops` is active the plain versions tally the FP32 operations
# their lanes need: lower estimates per step (adds, multiplies, divides,
# roots, min/max and compares; selects and copies are free), lanes that a
# per-lane gate skips count nothing, and a Mandelbulb DE counts the
# iterations each lane ran. chip_smoke.py divides the total by the card's
# FP32 rate for the kernels' operation bound.
_LEAF_OPS = {LEAF_SPHERE: 10, LEAF_PLANE: 6, LEAF_BOX: 22,
             LEAF_MANDELBULB: 25}
_ANALYTIC_LEAF_OPS = {LEAF_SPHERE: 20, LEAF_PLANE: 12, LEAF_BOX: 36}
# one power-8 update of the DE orbit with its escape test, by form
# (settings.bulb_iter): the hand count of the CUDA substep that stands in
# surfjax_torch/tools/fp32_peak.py, whose probe measures the card's rate on
# exactly these operations
BULB_ITER_OPS = {"std": 81, "cheb": 62}
# n: the running total (None while not counting); bulb: per-lane
# Mandelbulb iterations of the DE evaluations not yet tallied, and
# bulb_ops the operations of one of them; bulb_iters: the running total of
# Mandelbulb iteration-lanes; evals: of object SDF evaluation-lanes
_OPS = {"n": None, "bulb": None, "bulb_ops": None, "bulb_iters": None,
        "evals": None}


@contextlib.contextmanager
def count_ops():
    """Count the operations of the plain versions run inside the block ->
    a dict that holds, once the block has ended, the total under "ops",
    under "bulb_iters" the Mandelbulb iteration-lanes inside it (each
    counted BULB_ITER_OPS operations) and under "evals" the evaluations of
    an object's SDF, one per object and lane."""
    res = {}
    _OPS.update(n=0, bulb=None, bulb_ops=None, bulb_iters=0, evals=0)
    try:
        yield res
    finally:
        res["ops"] = _OPS["n"]
        res["bulb_iters"] = _OPS["bulb_iters"]
        res["evals"] = _OPS["evals"]
        _OPS.update(n=None, bulb=None, bulb_ops=None, bulb_iters=None,
                    evals=None)


def fd_normal_evals(static, settings: RenderSettings, obj) -> int:
    """The SDF evaluations normals_core makes for K1's hit objects `obj`
    (-1 on a miss) in a scene without a crowd: 4 per lane whose normal is
    the FD tetrahedron of its object's tape (an SDF object, or any object
    under normals "fd")."""
    fd = torch.tensor([o.engine == ENGINE_SDF or settings.normals != "auto"
                       for o in static.ir.objects] + [False],
                      device=obj.device)
    obj = obj.reshape(-1).long()
    return 4 * int(fd[torch.where(obj >= 0, obj, -1)].sum())


def _tally(lanes, per_lane: int) -> None:
    """Add per_lane operations for each lane of a bool mask (or count)."""
    if _OPS["n"] is not None:
        n = int(lanes.sum()) if isinstance(lanes, torch.Tensor) else lanes
        _OPS["n"] += per_lane * int(n)


def _tape_ops(oir) -> int:
    return (sum(_LEAF_OPS[lf.kind] for lf in oir.leaves)
            + sum(12 if nd.op >= OP_SMOOTH_UNION else 2
                  for nd in oir.nodes if nd.op != OP_LEAF))


def _analytic_ops(oir) -> int:
    return sum(_ANALYTIC_LEAF_OPS[lf.kind] for lf in oir.leaves)


def _tally_de(fn, lanes, evals: int = 1) -> None:
    """Tally `evals` DE evaluations of fn's objects on the `lanes` mask,
    with the Mandelbulb iterations those evaluations ran there."""
    if _OPS["n"] is None:
        return
    iters = _OPS["bulb"]
    _OPS["bulb"] = None
    _tally(lanes, evals * (sum(_tape_ops(o) for o in fn.objs)
                           + getattr(fn, "flat_ops", 0)))
    n = int(lanes.sum()) if isinstance(lanes, torch.Tensor) else lanes
    _OPS["evals"] += evals * len(fn.objs) * int(n)
    if iters is not None:
        n_iters = int((iters * lanes).sum())
        _OPS["bulb_iters"] += n_iters
        _OPS["n"] += _OPS["bulb_ops"] * n_iters


def _split(static):
    """-> (analytic, sdf, mesh) lists of (object index, ObjectIR)."""
    objs = static.ir.objects
    analytic = [(i, o) for i, o in enumerate(objs)
                if o.engine == ENGINE_ANALYTIC]
    sdf = [(i, o) for i, o in enumerate(objs) if o.engine == ENGINE_SDF]
    mesh = [(i, o) for i, o in enumerate(objs) if o.engine == ENGINE_MESH]
    return analytic, sdf, mesh


def _exit_margin(settings: RenderSettings) -> float:
    """Worst hit epsilon over [0, t_max]: hit_eps + hit_eps_scale * t_max."""
    return settings.hit_eps + settings.hit_eps_scale * float(settings.t_max)


def _bulb_iters(prm, p, iterations: int, bulb_iter: str):
    """Per-lane count of the orbit updates the fused-path Mandelbulb DE
    runs at p (it stops a lane once m > bailout2): the orbit evaluated a
    second time, for count_ops."""
    _, bailout2, px, py, pz = _bulb_canonical(prm, p)
    new_w = (_new_w_cheb if bulb_iter == "cheb" else _new_w_std)(
        px, py, pz, f32(1e-4))
    wx, wy, wz = px, py, pz
    m = (px * px + py * py) + pz * pz
    iters = torch.zeros_like(m, dtype=torch.int32)
    for _ in range(iterations):
        active = m <= bailout2
        if not bool(active.any()):
            break
        iters += active
        wx_new, wy_new, wz_new = new_w(wx, wy, wz)
        wx = torch.where(active, wx_new, wx)
        wy = torch.where(active, wy_new, wy)
        wz = torch.where(active, wz_new, wz)
        m = torch.where(active, (wx * wx + wy * wy) + wz * wz, m)
    return iters


def _fast_leaf_fn(settings: RenderSettings, cap: int = 0):
    leaf_fn = make_leaf_fast(settings.bulb_iter, settings.bulb_log, cap)
    if _OPS["n"] is None:
        return leaf_fn

    def counting(kind, prm, p, p0=0, p1=0):
        if kind == LEAF_MANDELBULB:
            iters = _bulb_iters(prm, p, min(p1, cap) if cap else p1,
                                settings.bulb_iter)
            prev = _OPS["bulb"]
            _OPS["bulb"] = iters if prev is None else prev + iters
            _OPS["bulb_ops"] = BULB_ITER_OPS[settings.bulb_iter]
        return leaf_fn(kind, prm, p, p0, p1)
    return counting


def _leaf_bound_scalars(lf, lp, lower: bool = False,
                        cover_margin: float | None = None):
    """(cx, cy, cz, radius) of one bounded leaf, or None (plane).
    lower=True: a sphere whose SDF lower-bounds the leaf SDF pointwise;
    otherwise a hit-region cover, valid for the bulb only up to
    eps = 0.045*scale (above it the LOWER radius plus the margin)."""
    prm = lp[lf.slot]
    if lf.kind == LEAF_SPHERE:
        return prm[0], prm[1], prm[2], prm[3]
    if lf.kind == LEAF_BOX:
        r = sqrt((prm[3] * prm[3] + prm[4] * prm[4]) + prm[5] * prm[5])
        return prm[0], prm[1], prm[2], r
    if lf.kind == LEAF_MANDELBULB:
        if lower:
            return prm[0], prm[1], prm[2], prm[3] * f32(BULB_BOUND_LOWER)
        r_cover = prm[3] * f32(BULB_BOUND_COVER)
        if cover_margin is not None:
            r_safe = prm[3] * f32(BULB_BOUND_LOWER) + f32(cover_margin)
            r_cover = torch.where(f32(0.045) * prm[3] >= f32(cover_margin),
                            r_cover, r_safe)
        return prm[0], prm[1], prm[2], r_cover
    return None


def _object_bound(oir, lp, nparams, lower: bool = False,
                  cover_margin: float | None = None):
    """Bounding sphere (cx, cy, cz, R) of one SDF object, or None if it has
    a plane leaf. Smooth ops push the surface out by at most k/4 each."""
    if any(lf.kind == LEAF_PLANE for lf in oir.leaves):
        return None
    bounds = [_leaf_bound_scalars(lf, lp, lower=lower,
                                  cover_margin=cover_margin)
              for lf in oir.leaves]
    inv_n = f32(1.0 / float(len(bounds)))
    cx = sum(b[0] for b in bounds) * inv_n
    cy = sum(b[1] for b in bounds) * inv_n
    cz = sum(b[2] for b in bounds) * inv_n
    R = None
    for bx, by, bz, br in bounds:
        dx, dy, dz = bx - cx, by - cy, bz - cz
        rr = sqrt((dx * dx + dy * dy) + dz * dz) + br
        R = rr if R is None else torch.maximum(R, rr)
    k_margin = torch.zeros((), dtype=torch.float32, device=lp.device)
    for nd in oir.nodes:
        if nd.pslot >= 0:
            k_margin = k_margin + nparams[nd.pslot, 0] * 0.25
    return cx, cy, cz, R + k_margin


def _bulb_shell_static(oir) -> bool:
    """Static gates of the thin bulb entry shell: a single positive power-8
    bulb leaf with iterations in the validated set {2, 4, 8}."""
    if len(oir.nodes) != 1:
        return False
    lf = oir.leaves[0]
    return (lf.kind == LEAF_MANDELBULB and lf.sign > 0 and lf.p0 == 8
            and lf.p1 in (2, 4, 8))


def _bulb_entry_shell(oir, lp, exit_margin: float):
    """Entry-shell inflation for a single-leaf bulb (its COVER sphere needs
    no 0.08 inflation), or None for the default max(0.08, exit_margin).
    The dynamic gate (bailout 2, exit_margin <= 0.045*scale) falls back
    to the default per call."""
    if not _bulb_shell_static(oir):
        return None
    prm = lp[oir.leaves[0].slot]
    valid = (torch.abs(prm[4] - 2.0) < f32(1e-6)) & \
        (f32(0.045) * prm[3] >= f32(exit_margin))
    return torch.where(valid, f32(exit_margin),
                 f32(max(_PROXY_SWITCH, exit_margin)))


def _bound_entry(b, o, d, t_start, t_clip, exit_margin: float, shell=None):
    """Closed-form entry/exit of the inflated bound sphere -> (t1, clip2).
    Rays that miss it (or pass it before t_start) get t1 = clip2 = t_clip,
    so their march is done before its first step."""
    cx, cy, cz, R = b
    Re = R + (f32(max(_PROXY_SWITCH, exit_margin)) if shell is None
              else shell)
    wx = cx - o[0]
    wy = cy - o[1]
    wz = cz - o[2]
    pb = (wx * d[0] + wy * d[1]) + wz * d[2]
    w2 = (wx * wx + wy * wy) + wz * wz
    disc = pb * pb - (w2 - Re * Re)
    sq = sqrt(maximum(disc, 0.0))
    t_in = pb - sq
    t_out = pb + sq
    none = (disc < 0.0) | (t_out <= t_start)
    t1 = torch.maximum(t_in, t_start)
    t1 = torch.where(none, t_clip, t1)
    clip2 = torch.where(none, t_clip, torch.minimum(t_clip, t_out))
    return t1, clip2


def _proxy_exact(oir) -> bool:
    """True for an object the priming proxy evaluates exactly: at most two
    tape nodes and no fractal leaf; the others are replaced by their
    lower-bound sphere where they have one."""
    return len(oir.nodes) <= 2 and not any(
        lf.kind == LEAF_MANDELBULB for lf in oir.leaves)


def _proxy_bounded(oir) -> bool:
    """True for an object the proxy replaces by its lower-bound sphere."""
    return not _proxy_exact(oir) and not any(
        lf.kind == LEAF_PLANE for lf in oir.leaves)


def _proxy_sdf_fn(sdf_objs, lp, nparams, leaf_fn):
    """-> the proxy scene of the priming pass, a pointwise lower bound of
    the scene SDF that is cheap to evaluate, or None when no object gains
    from one. An object that has no bound sphere (a plane leaf) is
    evaluated exactly with `leaf_fn`, the evaluator of the true scene."""
    exact, bounds = [], []
    for _, oir in sdf_objs:
        if _proxy_bounded(oir):
            bounds.append(_object_bound(oir, lp, nparams, lower=True))
        else:
            exact.append(oir)
    if not bounds:
        return None

    def proxy(p):
        v = None
        for oir in exact:
            h = eval_sdf(oir, lp, nparams, p, leaf_fn=leaf_fn)
            v = h if v is None else torch.minimum(v, h)
        for cx, cy, cz, R in bounds:
            dx = p[0] - cx
            dy = p[1] - cy
            dz = p[2] - cz
            h = sqrt((dx * dx + dy * dy) + dz * dz) - R
            v = h if v is None else torch.minimum(v, h)
        return v

    proxy.objs = tuple(exact)
    proxy.flat_ops = 11 * len(bounds)
    return proxy


def _inv_one_plus(k_m: float) -> float:
    """1 / (1 + k_m) in float32 arithmetic."""
    return f32(np.float32(1.0) / (np.float32(1.0) + np.float32(k_m)))


def _prime_march(proxy_fn, sdf_fn, o, d, t_min: float, t_max: float,
                 k_m: float, steps: int):
    """Cone march, gated per lane -> the largest t_safe such that every
    ray within angle k_m/2 of this one (same origin) has SDF > 0 on
    [t_min, t_safe].

    A step s = (h - k*t)/(1 + k) keeps every point within radius k*t' of
    the centre ray outside the surface along [t, t + s]. Phase 1 marches
    the proxy scene and hands a lane over once h < 0.08 or the cone is
    blocked (s <= 1e-3*t); phase 2 goes on with the true SDF from the
    same t. Each phase has its own budget of `steps`; a stopped lane keeps
    its last proven t, a lane that reaches t_max is clear all the way."""
    k = f32(k_m)
    inv1k = _inv_one_plus(k_m)
    tmax = f32(t_max)

    def phase(fn, t, handoff):
        done = t >= tmax
        for _ in range(steps):
            if bool(done.all()):
                break
            h = fn((o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2]))
            _tally_de(fn, ~done)
            _tally(~done, 14)
            s_all = (h - k * t) * inv1k
            stop = s_all <= t * f32(1e-3)
            if handoff is not None:
                stop = stop | (h < f32(handoff))
            act = ~(done | stop)
            t = torch.where(act, minimum(t + s_all, tmax), t)
            done = done | stop | (act & (t >= tmax))
        return t

    t_safe = torch.full_like(o[0], f32(t_min))
    if proxy_fn is not None:
        t_safe = phase(proxy_fn, t_safe, _PROXY_SWITCH)
    return phase(sdf_fn, t_safe, None)


def _march(sdf_fn, o, d, t_init, t_clip, max_steps: int, hit_eps: float,
           relax: float = 1.0, eps_scale: float = 0.0):
    """Bounded march, gated per lane -> (t, hit).

    Every lane takes at most max_steps substeps and stops when it hits
    (h < hit_eps + eps_scale*t) or passes t_clip; substeps of a done lane
    are identity. relax > 1 over-relaxes the step by `relax`; when two
    consecutive safety spheres stop overlapping (st_prev > h_prev + |h|)
    the lane retreats to the conservative point and the test is skipped."""
    eps = f32(hit_eps)
    w = f32(relax)
    es = f32(eps_scale)
    relaxed = relax > 1.0
    t = t_init
    done = t >= t_clip
    hit = torch.zeros_like(done)
    h_prev = torch.zeros_like(t)
    st_prev = torch.zeros_like(t)
    for _ in range(max_steps):
        if bool(done.all()):
            break
        h = sdf_fn((o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2]))
        _tally_de(sdf_fn, ~done)
        _tally(~done, 12)
        if relaxed:
            ovr = st_prev > h_prev + torch.abs(h)
            ok = ~ovr
            okf = torch.where(ovr, 0.0, 1.0)
        else:
            ok = torch.ones_like(done)
            okf = 1.0
        hit_now = ok & (h < eps + es * t)
        over = ok & (t > t_clip)
        hit = hit | (hit_now & ~done)
        done_new = done | hit_now | over
        step = w * h
        t_next = t + step
        if relaxed:
            t_next = torch.where(ovr, (t - st_prev) + h_prev, t_next)
        t = torch.where(done_new, t, t_next)
        h_prev = torch.where(done_new, h_prev, okf * h)
        st_prev = torch.where(done_new, st_prev, okf * step)
        done = done_new
    return t, hit


def _fd_normal(sdf_fn, p, eps: float):
    e = f32(eps)
    s0 = sdf_fn((p[0] + e, p[1] - e, p[2] - e))
    s1 = sdf_fn((p[0] - e, p[1] - e, p[2] + e))
    s2 = sdf_fn((p[0] - e, p[1] + e, p[2] - e))
    s3 = sdf_fn((p[0] + e, p[1] + e, p[2] + e))
    nx = ((s0 - s1) - s2) + s3
    ny = ((-s0 - s1) + s2) + s3
    nz = ((-s0 + s1) - s2) + s3
    inv = 1.0 / sqrt((nx * nx + ny * ny) + nz * nz)
    return (nx * inv, ny * inv, nz * inv)


def _object_sdf(oir, lp, nparams, leaf_fn):
    fn = lambda p: eval_sdf(oir, lp, nparams, p, leaf_fn=leaf_fn)  # noqa
    fn.objs = (oir,)
    return fn


# ---------------------------------------------------------------------------
# The crowd: member loops for large scenes (settings.vector_objects)
#
# Single-leaf positive sphere/box objects (SDF or analytic engine) and SDF
# two-leaf pairs op(leaf0, leaf1) form a "crowd": instead of one table-driven
# object each, they are traced, shaded and shadowed by loops over member
# rows of `crowd_meta`, which read the member's parameters by index. The
# per-member arithmetic is that of the per-object path, so geometry is
# bitwise equal with the crowd on or off. Members are ordered spheres
# first, section by section, and ties between members are decided by a
# strict `<`, so the section order is part of the result.
#
# surfjax gates some member work per TPU tile (a member's AO terms when no
# lane of the tile is near it, its FD normal when no lane picked it); each
# gate is value-exact per lane (a far member's term is exactly 0, an
# unpicked lane's normal is discarded), so the plain versions here gate per
# lane and the CUDA kernels per thread.
# ---------------------------------------------------------------------------

class CrowdIR(NamedTuple):
    """Crowd membership in statically kinded sections: members = sdf
    spheres ++ sdf boxes ++ analytic spheres ++ analytic boxes ++ SDF pairs
    grouped by (leaf kinds, op) in first-seen order (scene order within a
    section)."""
    members: tuple      # ((obj_idx, ObjectIR), ...) in section order
    n_sph_sdf: int
    n_box_sdf: int
    n_sph_ana: int
    n_box_ana: int
    shin_groups: tuple  # distinct shininess values, in member order
    pair_specs: tuple = ()   # ((is_sphere0, is_sphere1, op, count), ...)

    @property
    def sdf_ranges(self):
        a = self.n_sph_sdf
        return ((0, a, True), (a, a + self.n_box_sdf, False))

    @property
    def ana_ranges(self):
        s = self.n_sph_sdf + self.n_box_sdf
        a = s + self.n_sph_ana
        return ((s, a, True), (a, a + self.n_box_ana, False))

    @property
    def all_ranges(self):
        return self.sdf_ranges + self.ana_ranges

    @property
    def n_singles(self):
        return (self.n_sph_sdf + self.n_box_sdf + self.n_sph_ana
                + self.n_box_ana)

    @property
    def pair_ranges(self):
        """((lo, hi, (is_sphere0, is_sphere1, op)), ...): the tag of a
        pair section is its spec where a single section has is_sphere."""
        out = []
        lo = self.n_singles
        for is_s0, is_s1, op, cnt in self.pair_specs:
            out.append((lo, lo + cnt, (is_s0, is_s1, op)))
            lo += cnt
        return tuple(out)

    @property
    def has_sdf(self):
        return self.n_sph_sdf + self.n_box_sdf > 0 or bool(self.pair_specs)

    @property
    def has_ana(self):
        return self.n_sph_ana + self.n_box_ana > 0


def _pair_spec(oir):
    """(is_sphere0, is_sphere1, op) of an eligible SDF pair, else None:
    the tape is exactly op(leaf0, leaf1), both leaves sphere/box, and the
    leaf signs are the op's own parity (negative only on the subtracted
    operand)."""
    if len(oir.nodes) != 3 or len(oir.leaves) != 2:
        return None
    n0, n1, n2 = oir.nodes
    if not (n0.op == OP_LEAF and n1.op == OP_LEAF and n2.op != OP_LEAF
            and n2.a == 0 and n2.b == 1):
        return None
    l0, l1 = oir.leaves
    if any(lf.kind not in (LEAF_SPHERE, LEAF_BOX) for lf in (l0, l1)):
        return None
    sub = n2.op in (OP_SUBTRACT, OP_SMOOTH_SUBTRACT)
    if l0.sign <= 0 or (l1.sign > 0) == sub:
        return None
    return (l0.kind == LEAF_SPHERE, l1.kind == LEAF_SPHERE, n2.op)


def split_crowd(static, settings: RenderSettings):
    """-> (CrowdIR | None, rest_analytic, rest_sdf), each rest a list of
    that engine's (object index, ObjectIR) outside the crowd. The crowd
    forms only with settings.vector_objects and at least two eligible
    members; planes, bulbs, deeper tapes, analytic pairs and meshes stay
    per-object."""
    analytic, sdf_objs, _ = _split(static)
    if not settings.vector_objects:
        return None, analytic, sdf_objs

    def single(oir):
        lf = oir.leaves[0] if len(oir.leaves) == 1 else None
        return (len(oir.nodes) == 1 and lf is not None and lf.sign > 0
                and lf.kind in (LEAF_SPHERE, LEAF_BOX))

    def pick(objs, allow_pairs):
        singles = [m for m in objs if single(m[1])]
        pairs = [m for m in objs if allow_pairs and not single(m[1])
                 and _pair_spec(m[1]) is not None]
        taken = {i for i, _ in singles + pairs}
        rest = [m for m in objs if m[0] not in taken]
        sph = [m for m in singles if m[1].leaves[0].kind == LEAF_SPHERE]
        box = [m for m in singles if m[1].leaves[0].kind == LEAF_BOX]
        return sph, box, pairs, rest

    sph_s, box_s, pairs_s, rest_sdf = pick(sdf_objs, True)
    sph_a, box_a, _, rest_ana = pick(analytic, False)
    by_spec = {}    # insertion order = first-seen order of the specs
    for m in pairs_s:
        by_spec.setdefault(_pair_spec(m[1]), []).append(m)
    pair_specs = tuple(sp + (len(ms),) for sp, ms in by_spec.items())
    members = sph_s + box_s + sph_a + box_a + \
        [m for ms in by_spec.values() for m in ms]
    if len(members) < 2:
        return None, analytic, sdf_objs
    groups = []
    for _, oir in members:
        if oir.shininess not in groups:
            groups.append(oir.shininess)
    return (CrowdIR(tuple(members), len(sph_s), len(box_s), len(sph_a),
                    len(box_a), tuple(groups), pair_specs),
            rest_ana, rest_sdf)


@functools.lru_cache(maxsize=64)
def _crowd_meta_cached(static, vector_objects: bool):
    crowd = split_crowd(static, RenderSettings(
        vector_objects=vector_objects))[0]
    if crowd is None:
        return np.zeros((1, 6), np.int32)
    rows = []
    for i, oir in crowd.members:
        slot1 = oir.leaves[1].slot if len(oir.leaves) == 2 else 0
        pslot = max(oir.nodes[-1].pslot, 0) if len(oir.nodes) == 3 else 0
        rows.append([oir.leaves[0].slot, i, oir.mat,
                     crowd.shin_groups.index(oir.shininess), slot1, pslot])
    return np.asarray(rows, np.int32)


def crowd_meta(static, settings: RenderSettings) -> np.ndarray:
    """(max(1, n), 6) int32 rows [leaf_slot0, obj_idx, mat_idx, shin_group,
    leaf_slot1, node_pslot], row j = member j; slot1 and pslot are 0 for
    single-leaf members. One zero row stands in when there is no crowd."""
    return _crowd_meta_cached(static, bool(settings.vector_objects))


def _crowd_refs(static, settings: RenderSettings, lp, nparams):
    """The (meta rows, leaf_params, node_params) triple the member loops
    read through."""
    return crowd_meta(static, settings), lp, nparams


def _crowd_bound(prm, is_sphere: bool):
    """Bounding sphere of a sphere/box leaf (cover and pointwise lower
    bound coincide), the formulas of _leaf_bound_scalars."""
    if is_sphere:
        return (prm[0], prm[1], prm[2], prm[3])
    r = sqrt((prm[3] * prm[3] + prm[4] * prm[4]) + prm[5] * prm[5])
    return (prm[0], prm[1], prm[2], r)


def _crowd_leaf_sdf(prm, is_sphere: bool):
    if is_sphere:
        return lambda p: sdf_sphere(prm, p)
    return lambda p: sdf_box(prm, p)


def _crowd_pair_sdf(prm0, is_s0: bool, prm1, is_s1: bool, op: int, k):
    """op(leaf0, leaf1) in the arithmetic and association of eval_sdf's
    tape for the same 3-node object."""
    f0 = _crowd_leaf_sdf(prm0, is_s0)
    f1 = _crowd_leaf_sdf(prm1, is_s1)
    if op == OP_UNION:
        return lambda p: torch.minimum(f0(p), f1(p))
    if op == OP_INTERSECT:
        return lambda p: torch.maximum(f0(p), f1(p))
    if op == OP_SUBTRACT:
        return lambda p: torch.maximum(f0(p), -f1(p))

    def f(p):
        a, b = f0(p), f1(p)
        if op == OP_SMOOTH_UNION:
            h = saturate(0.5 + 0.5 * (b - a) / k)
            return mix(b, a, h) - k * h * (1.0 - h)
        if op == OP_SMOOTH_INTERSECT:
            h = saturate(0.5 - 0.5 * (b - a) / k)
            return mix(b, a, h) + k * h * (1.0 - h)
        h = saturate(0.5 - 0.5 * (b + a) / k)
        return mix(a, -b, h) + k * h * (1.0 - h)
    return f


def _crowd_pair_bound(prm0, is_s0: bool, prm1, is_s1: bool, op: int, k):
    """Bounding sphere of a pair in the arithmetic of _object_bound for a
    two-leaf tape: mean centre, largest leaf reach, + k/4 for a smooth op.
    It covers every op's surface and lower-bounds every op's SDF."""
    b0 = _crowd_bound(prm0, is_s0)
    b1 = _crowd_bound(prm1, is_s1)
    cx = (b0[0] + b1[0]) * 0.5
    cy = (b0[1] + b1[1]) * 0.5
    cz = (b0[2] + b1[2]) * 0.5
    R = None
    for bx, by, bz, br in (b0, b1):
        dx, dy, dz = bx - cx, by - cy, bz - cz
        rr = sqrt((dx * dx + dy * dy) + dz * dz) + br
        R = rr if R is None else torch.maximum(R, rr)
    if op in SMOOTH_OPS:
        R = R + k * 0.25
    return cx, cy, cz, R


def _crowd_shape(crowd, crowd_refs, j: int, tag):
    """Member j's (bounding sphere, SDF); tag is the static tag of its
    section: is_sphere, or a pair's (is_sphere0, is_sphere1, op)."""
    cm, lp, nparams = crowd_refs
    prm0 = lp[int(cm[j, 0])]
    if isinstance(tag, tuple):
        is_s0, is_s1, op = tag
        prm1 = lp[int(cm[j, 4])]
        k = nparams[int(cm[j, 5]), 0]
        b = _crowd_pair_bound(prm0, is_s0, prm1, is_s1, op, k)
        fn = _crowd_pair_sdf(prm0, is_s0, prm1, is_s1, op, k)
    else:
        b = _crowd_bound(prm0, tag)
        fn = _crowd_leaf_sdf(prm0, tag)
    fn.objs = (crowd.members[j][1],)    # for count_ops
    return b, fn


def _crowd_sections(ranges, fn, carry):
    """carry = fn(j, tag, carry) over the member ranges ((lo, hi, tag),
    ...), in order."""
    for lo, hi, tag in ranges:
        for j in range(lo, hi):
            carry = fn(j, tag, carry)
    return carry


def _leaf_exact_t(prm, is_sphere: bool, o, d, t_min, t_max):
    """Nearest boundary of a positive sphere/box leaf in (t_min, t_max),
    BIG on a miss: intersect_analytic's single-leaf case."""
    t0, t1 = leaf_interval(LEAF_SPHERE if is_sphere else LEAF_BOX, prm, o, d)
    e0 = (t0 > t_min) & (t0 < t_max)
    e1 = (t1 > t_min) & (t1 < t_max)
    return torch.where(e0, t0, torch.where(e1, t1, BIG))


def _crowd_analytic_trace(crowd, crowd_refs, o, d, t_min, t_max, state,
                          keep=None):
    """Exact nearest hits of the analytic members, merged like analytic
    objects. state -> (t_a, obj, leaf). keep(j, live=None): the lanes that
    visit member j, live the lanes the loop still changes (CrowdMasks.lanes,
    called once per member and in member order); None: every lane visits
    every member."""
    cm, lp, _ = crowd_refs

    def member(j, is_sphere, carry):
        t_a, obj, leaf = carry
        t_j = _leaf_exact_t(lp[int(cm[j, 0])], is_sphere, o, d, f32(t_min),
                            f32(t_max))
        lanes = t_j.numel() if keep is None else keep(j)
        _tally(lanes, _ANALYTIC_LEAF_OPS[LEAF_SPHERE if is_sphere
                                         else LEAF_BOX])
        better = t_j < t_a
        if keep is not None:
            better = better & lanes
        return (torch.where(better, t_j, t_a),
                torch.where(better, float(cm[j, 1]), obj),
                torch.where(better, 0.0, leaf))

    return _crowd_sections(crowd.ana_ranges, member, state)


def _crowd_trace(crowd, crowd_refs, o, d, t_start, settings, exit_margin,
                 state, keep=None):
    """Bound entry and march of every SDF member (singles, then pairs),
    each clipped by the nearest hit so far. state -> (t, obj, leaf,
    t_clip); keep as in _crowd_analytic_trace."""
    cm = crowd_refs[0]

    def member(j, tag, carry):
        t, obj, leaf, t_clip = carry
        b, sdf_j = _crowd_shape(crowd, crowd_refs, j, tag)
        lanes = t.numel() if keep is None else keep(j)
        _tally(lanes, 30)
        t1, clip2 = _bound_entry(b, o, d, t_start, t_clip, exit_margin)
        if keep is not None:      # a skipped lane's march is done at once
            clip2 = torch.where(lanes, clip2, t1)
        t_j, hit_j = _march(sdf_j, o, d, t1, clip2, settings.max_steps,
                            settings.hit_eps, relax=settings.over_relax,
                            eps_scale=settings.hit_eps_scale)
        better = hit_j & (t_j < t)
        t = torch.where(better, t_j, t)
        return (t, torch.where(better, float(cm[j, 1]), obj),
                torch.where(better, 0.0, leaf), torch.minimum(t_clip, t))

    return _crowd_sections(crowd.sdf_ranges + crowd.pair_ranges, member,
                           state)


def _crowd_normals(crowd, crowd_refs, p, obj, settings, n):
    """Normals of the lanes a member won: the FD tetrahedron of the
    member's own SDF, or the closed-form leaf normal for analytic members
    under normals="auto"."""
    cm, lp, _ = crowd_refs

    def pick(sel, n_s, carry):
        return tuple(torch.where(sel, a, b) for a, b in zip(n_s, carry))

    def member_fd(j, tag, carry):
        sel = obj == float(cm[j, 1])
        if not bool(sel.any()):
            return carry
        _, sdf_j = _crowd_shape(crowd, crowd_refs, j, tag)
        _tally_de(sdf_j, sel, evals=4)
        _tally(sel, 30)
        return pick(sel, _fd_normal(sdf_j, p, settings.normal_eps), carry)

    def member_analytic(j, is_sphere, carry):
        sel = obj == float(cm[j, 1])
        _tally(sel, 6)
        kind = LEAF_SPHERE if is_sphere else LEAF_BOX
        return pick(sel, leaf_normal(kind, lp[int(cm[j, 0])], p), carry)

    if settings.normals == "auto":
        n = _crowd_sections(crowd.sdf_ranges, member_fd, n)
        n = _crowd_sections(crowd.ana_ranges, member_analytic, n)
    else:
        n = _crowd_sections(crowd.all_ranges, member_fd, n)
    return _crowd_sections(crowd.pair_ranges, member_fd, n)


def _crowd_ao_terms(crowd, crowd_refs, p_off, taps, settings, terms, need,
                    keep=None):
    """Every member's AO tap terms, max-combined into `terms`, with the
    far gate of _ao_compute: a receiver more than 2*ao_radius outside the
    member's bound gets exactly zero from it. keep as in
    _crowd_analytic_trace."""
    gate = f32(2.0 * f32(settings.ao_radius))

    def member(j, tag, terms):
        (cx, cy, cz, R), sdf_j = _crowd_shape(crowd, crowd_refs, j, tag)
        dx = p_off[0] - cx
        dy = p_off[1] - cy
        dz = p_off[2] - cz
        near = sqrt((dx * dx + dy * dy) + dz * dz) - R <= gate
        if keep is not None:
            kept = keep(j, need)
            need_j = need & kept
            near = near & kept
        else:
            need_j = need
        _tally(need_j, 10)
        if not bool(near.any()):
            return terms
        _tally_de(sdf_j, near & need_j, evals=len(taps))
        _tally(near & need_j, 4 * len(taps))
        return [torch.maximum(acc, torch.where(
            near, ao_tap_term(az, r, sdf_j(q)), 0.0))
            for acc, (az, r, q) in zip(terms, taps)]

    return _crowd_sections(crowd.all_ranges + crowd.pair_ranges, member,
                           terms)


def _crowd_hard_vis(crowd, crowd_refs, o, l, dist, settings, eps_margin,
                    vis, keep=None):
    """Hard shadows of the crowd: SDF members (singles, then pairs) by
    any-hit marches with the segment skip and the bound entry/exit clip,
    analytic members exactly. -> vis. keep(key, j), key "hard_sdf" or
    "hard_ana": as in _crowd_analytic_trace."""
    cm, lp, _ = crowd_refs
    eps = f32(settings.shadow_eps)

    def member(j, tag, vis):
        b, sdf_j = _crowd_shape(crowd, crowd_refs, j, tag)
        dist_j = torch.where(vis <= 0.0, 0.0, dist)
        if keep is not None:
            dist_j = torch.where(keep("hard_sdf", j, dist_j > 0.0), dist_j,
                                 0.0)
        _tally(dist_j > 0.0, 30)
        dseg = _seg_bound_dist(b, o, l, eps, dist_j)
        dist_j = torch.where(dseg > f32(eps_margin), 0.0, dist_j)
        t1, clip2 = _bound_entry(b, o, l, torch.full_like(dist_j, eps),
                                 dist_j, eps_margin)
        t_s, hit_s = _march(sdf_j, o, l, t1, clip2, settings.max_steps,
                            settings.hit_eps, relax=settings.over_relax,
                            eps_scale=settings.hit_eps_scale)
        return vis * torch.where(hit_s & (t_s < dist_j), 0.0, 1.0)

    def member_analytic(j, is_sphere, vis):
        t_j = _leaf_exact_t(lp[int(cm[j, 0])], is_sphere, o, l, eps, dist)
        lanes = (dist > 0.0) & (vis > 0.0)   # a dark lane skips the rest
        occ = t_j < dist
        if keep is not None:
            kept = keep("hard_ana", j, lanes)
            lanes = lanes & kept
            occ = occ & kept
        _tally(lanes, _ANALYTIC_LEAF_OPS[LEAF_SPHERE if is_sphere
                                         else LEAF_BOX])
        return vis * torch.where(occ, 0.0, 1.0)

    vis = _crowd_sections(crowd.sdf_ranges + crowd.pair_ranges, member, vis)
    return _crowd_sections(crowd.ana_ranges, member_analytic, vis)


def _crowd_soft_vis(crowd, crowd_refs, o, l, dist, settings, kf, soft_vis,
                    keep=None):
    """Penumbrae of the crowd: sphere members in closed form (no march),
    boxes and pairs by influence-window marches. -> soft_vis. keep(key, j),
    key "soft": as in _crowd_analytic_trace."""
    cm, lp, _ = crowd_refs
    t0 = f32(settings.soft_shadow_tmin)

    def member(j, tag, soft_vis):
        live = (dist > 0.0) & (soft_vis > 0.0)   # a dark lane skips the rest
        kept = None if keep is None else keep("soft", j, live)
        if tag is True:
            lanes = live
            v_j = torch.minimum(soft_vis, _penumbra_sphere(
                lp[int(cm[j, 0])], o, l, t0, dist, kf))
            if keep is not None:
                lanes = lanes & kept
                v_j = torch.where(kept, v_j, soft_vis)
            _tally(lanes, 70)
            return v_j
        b, sdf_j = _crowd_shape(crowd, crowd_refs, j, tag)
        dist_j = torch.where(soft_vis <= 0.0, 0.0, dist)
        if keep is not None:
            dist_j = torch.where(kept, dist_j, 0.0)
        _tally(dist_j > 0.0, 30)
        t_lo, t_hi = _influence_window(b, o, l, t0, dist_j, kf)
        v_j = _soft_march(sdf_j, o, l, maximum(t_lo, t0),
                          torch.minimum(dist_j, t_hi), kf,
                          settings.shadow_steps, relax=settings.over_relax)
        return torch.minimum(soft_vis, v_j)

    return _crowd_sections(crowd.all_ranges + crowd.pair_ranges, member,
                           soft_vis)


def _crowd_shade(crowd, crowd_refs, n_objects: int, mat_table, obj, hit,
                 ambient, ao, n, v, light_terms, rgb):
    """Shade the lanes a member won: each lane gathers its member's
    material row by mat_idx, and shade_object runs once per distinct
    shininess. Per lane this is the per-object shading arithmetic on the
    same material values. rgb -> (r, g, b)."""
    cm = crowd_refs[0]
    dev = obj.device
    # member row of every object index; the spare last slot takes obj -1
    row_of_obj = torch.full((n_objects + 1,), -1, dtype=torch.long,
                            device=dev)
    row_of_obj[torch.as_tensor(cm[:, 1].astype(np.int64), device=dev)] = \
        torch.arange(len(cm), device=dev)
    row = row_of_obj[obj.long()]
    is_member = hit & (row >= 0)
    row = torch.clamp(row, min=0)
    mats = mat_table[torch.as_tensor(cm[:, 2].astype(np.int64),
                                     device=dev)[row]]
    grp = torch.as_tensor(cm[:, 3].astype(np.int64), device=dev)[row]
    mat_cols = tuple(mats[..., k] for k in range(9))
    for gi, shin in enumerate(crowd.shin_groups):
        sel = is_member & (grp == gi)
        if not bool(sel.any()):
            continue
        shaded = shade_object(mat_cols, shin, ambient, ao, n, v, light_terms)
        rgb = tuple(torch.where(sel, a, b) for a, b in zip(shaded, rgb))
    return rgb


def trace_core(static, settings: RenderSettings, lp, nparams, o, d,
               t0=None, cull=None):
    """Primary trace over (settings.t_min, settings.t_max) of the non-mesh
    objects -> (t, obj f32, leaf f32, hit_f f32).

    Analytic objects are intersected exactly (scene order), then the
    analytic crowd members; then the crowd's SDF members are marched, then
    each remaining SDF object, cheapest tape first, every march from its
    bound-sphere entry and clipped by the nearest hit so far. t0 (per
    lane, from the priming pass) is a start before which no SDF surface
    lies: SDF marches begin at max(t_min, t0), analytic hits ignore it.
    cull(key, j, live) -> the lanes that visit member j in the loop `key`
    (CrowdMasks.lanes), None: every lane visits every member."""
    crowd, analytic, sdf_objs = split_crowd(static, settings)
    t_a = torch.full_like(o[0], BIG)
    obj = torch.full_like(o[0], -1.0)
    leaf = torch.zeros_like(o[0])
    t_min, t_max = settings.t_min, settings.t_max
    for i, oir in analytic:
        t_i, leaf_i = intersect_analytic(oir, lp, o, d, t_min, t_max)
        _tally(t_i.numel(), _analytic_ops(oir))
        better = t_i < t_a
        t_a = torch.where(better, t_i, t_a)
        obj = torch.where(better, float(i), obj)
        leaf = torch.where(better, leaf_i.to(torch.float32), leaf)
    crowd_refs = _crowd_refs(static, settings, lp, nparams)
    if crowd is not None and crowd.has_ana:
        t_a, obj, leaf = _crowd_analytic_trace(
            crowd, crowd_refs, o, d, t_min, t_max, (t_a, obj, leaf),
            _bind(cull, "primary_ana"))
    t = t_a
    if t0 is None:
        t_start = torch.full_like(o[0], f32(t_min))
    else:
        t_start = maximum(t0, f32(t_min))
    exit_margin = _exit_margin(settings)
    if crowd is not None and crowd.has_sdf:
        t, obj, leaf, _ = _crowd_trace(
            crowd, crowd_refs, o, d, t_start, settings, exit_margin,
            (t, obj, leaf, minimum(t, f32(t_max))),
            _bind(cull, "primary_sdf"))
    if sdf_objs:
        fast_fn = _fast_leaf_fn(settings)
        order = sorted(sdf_objs, key=lambda io: len(io[1].nodes))
        t_clip = minimum(t, f32(t_max))
        for i, oir in order:
            sdf_i = _object_sdf(oir, lp, nparams, fast_fn)
            b_i = _object_bound(oir, lp, nparams, cover_margin=exit_margin)
            if b_i is not None:
                shell_i = _bulb_entry_shell(oir, lp, exit_margin)
                t1, clip2 = _bound_entry(b_i, o, d, t_start, t_clip,
                                         exit_margin, shell=shell_i)
            else:
                t1, clip2 = t_start, t_clip
            t_i, hit_i = _march(sdf_i, o, d, t1, clip2, settings.max_steps,
                                settings.hit_eps, relax=settings.over_relax,
                                eps_scale=settings.hit_eps_scale)
            better = hit_i & (t_i < t)
            t = torch.where(better, t_i, t)
            obj = torch.where(better, float(i), obj)
            leaf = torch.where(better, 0.0, leaf)
            t_clip = torch.minimum(t_clip, t)
    hit_f = torch.where(t < f32(BIG * 0.5), 1.0, 0.0)
    return t, obj, leaf, hit_f


def normals_core(static, settings: RenderSettings, lp, nparams, p, obj,
                 leaf, d):
    """Face-forwarded normals of trace_core hits: analytic normals for
    analytic objects under normals="auto", otherwise the FD tetrahedron of
    the winning object's own tape (evaluated only where it won)."""
    crowd, analytic, sdf_objs = split_crowd(static, settings)
    nx = torch.zeros_like(p[0])
    ny = torch.zeros_like(p[0])
    nz = torch.ones_like(p[0])
    if crowd is not None:
        nx, ny, nz = _crowd_normals(
            crowd, _crowd_refs(static, settings, lp, nparams), p, obj,
            settings, (nx, ny, nz))
    fd_objs = list(sdf_objs)
    if settings.normals == "auto":
        for i, oir in analytic:
            n_i = object_normal_analytic(oir, lp, p, leaf.to(torch.int32))
            sel = obj == float(i)
            _tally(sel, 6)
            nx = torch.where(sel, n_i[0], nx)
            ny = torch.where(sel, n_i[1], ny)
            nz = torch.where(sel, n_i[2], nz)
    else:
        fd_objs = sorted(analytic + sdf_objs)
    fast_fn = _fast_leaf_fn(settings)
    for i, oir in fd_objs:
        sel = obj == float(i)
        if not bool(sel.any()):
            continue
        fn = _object_sdf(oir, lp, nparams, fast_fn)
        n_s = _fd_normal(fn, p, settings.normal_eps)
        _tally_de(fn, sel, evals=4)
        _tally(sel, 30)
        nx = torch.where(sel, n_s[0], nx)
        ny = torch.where(sel, n_s[1], ny)
        nz = torch.where(sel, n_s[2], nz)
    flip = (nx * d[0] + ny * d[1]) + nz * d[2] > 0.0
    s = torch.where(flip, -1.0, 1.0)
    return (nx * s, ny * s, nz * s)


def _penumbra_plane(prm, o, l, t0: float, t_max, kf):
    """Closed-form penumbra of a plane leaf: k*d(t)/t is monotone, so its
    minimum over [t0, t_max] is at an endpoint. t_max <= t0 -> 1."""
    a = ((prm[0] * o[0] + prm[1] * o[1]) + prm[2] * o[2]) - prm[3]
    b = (prm[0] * l[0] + prm[1] * l[1]) + prm[2] * l[2]
    tm = maximum(t_max, t0)
    f0 = fdiv(kf * (a + b * t0), t0)
    f1 = kf * (a + b * tm) / tm
    res = torch.minimum(f0, f1)
    res = torch.where(t_max <= t0, 1.0, res)
    return clamp(res, 0.0, 1.0)


def _penumbra_sphere(prm, o, l, t0: float, t_max, kf):
    """Closed-form penumbra of a sphere leaf: the minimum of
    k*(|o + t*l - c| - R)/t over [t0, t_max] is at an endpoint or at a
    root of t^2 (b^2 - R^2) + 2 b t (R^2 - A) + A (A - R^2)."""
    cx, cy, cz, R = prm[0], prm[1], prm[2], prm[3]
    wx = cx - o[0]
    wy = cy - o[1]
    wz = cz - o[2]
    A = (wx * wx + wy * wy) + wz * wz
    b = (wx * l[0] + wy * l[1]) + wz * l[2]

    def f(t):
        s = sqrt(maximum((t - b) * t + (A - b * t), 0.0))
        return kf * (s - R) / t

    tm = maximum(t_max, t0)
    qa = b * b - R * R
    qb = b * (R * R - A)
    qc = A * (A - R * R)
    disc = qb * qb - qa * qc
    sq = sqrt(maximum(disc, 0.0))
    safe_qa = torch.where(torch.abs(qa) < f32(1e-12), f32(1e-12), qa)
    r1 = clamp((-qb - sq) / safe_qa, t0, tm)
    r2 = clamp((-qb + sq) / safe_qa, t0, tm)
    r1 = torch.where(disc >= 0.0, r1, t0)
    r2 = torch.where(disc >= 0.0, r2, t0)
    f_t0 = f(torch.full_like(b, t0))
    res = torch.minimum(torch.minimum(f_t0, f(tm)),
                        torch.minimum(f(r1), f(r2)))
    res = torch.where(t_max <= t0, 1.0, res)
    return clamp(res, 0.0, 1.0)


def _single_leaf_closed_form(oir):
    """LEAF_PLANE / LEAF_SPHERE for one positive plane/sphere leaf (closed-
    form penumbra), else None."""
    if len(oir.nodes) == 1 and len(oir.leaves) == 1:
        lf = oir.leaves[0]
        if lf.sign > 0 and lf.kind in (LEAF_PLANE, LEAF_SPHERE):
            return lf.kind
    return None


def _influence_window(b, o, l, t0: float, t_max, kf):
    """Per-lane [t_lo, t_hi] outside which the object cannot lower the
    penumbra below 1 (k*h_bound/t >= 1 there): the roots of
    t^2 (1 - 1/k^2) - 2 t (b + R/k) + (A - R^2) = 0. Soft penumbrae
    (k < 1.2) take the whole segment."""
    cx, cy, cz, R = b
    wx = cx - o[0]
    wy = cy - o[1]
    wz = cz - o[2]
    A = (wx * wx + wy * wy) + wz * wz
    bb = (wx * l[0] + wy * l[1]) + wz * l[2]
    inv_k = 1.0 / kf
    qa = 1.0 - inv_k * inv_k
    qb = -(bb + R * inv_k)
    qc = A - R * R
    disc = qb * qb - qa * qc
    sq = sqrt(maximum(disc, 0.0))
    safe_qa = maximum(qa, f32(1e-6))
    t_lo = (-qb - sq) / safe_qa
    t_hi = (-qb + sq) / safe_qa
    t_lo = maximum(t_lo, t0)
    t_hi = torch.minimum(t_hi, t_max)
    empty = (disc < 0.0) | (t_hi <= t_lo)
    t_lo = torch.where(empty, t0, t_lo)
    t_hi = torch.where(empty, 0.0, t_hi)
    no_win = kf < f32(1.2)
    t_lo = torch.where(no_win, t0, t_lo)
    t_hi = torch.where(no_win, t_max, t_hi)
    return t_lo, t_hi


def _seg_bound_dist(b, o, l, t_lo: float, dist):
    """Distance from the shadow segment [t_lo, dist] to the sphere b."""
    cx, cy, cz, R = b
    wx = cx - o[0]
    wy = cy - o[1]
    wz = cz - o[2]
    proj = (wx * l[0] + wy * l[1]) + wz * l[2]
    proj = torch.minimum(maximum(proj, t_lo), maximum(dist, t_lo))
    qx = wx - proj * l[0]
    qy = wy - proj * l[1]
    qz = wz - proj * l[2]
    return sqrt((qx * qx + qy * qy) + qz * qz) - R


def _soft_march(sdf_fn, o, d, t_init, t_max, k, steps: int,
                relax: float = 1.0):
    """Penumbra march, gated per lane -> visibility in [0, 1].

    res = min(res, k*h/t); the step never skips a stretch where k*d/t
    could fall below res; relax > 1 over-relaxes with the same retreat
    rule as _march. A lane stops below res 0.004 or past t_max."""
    kf = k if isinstance(k, torch.Tensor) else f32(k)
    w = f32(relax)
    relaxed = relax > 1.0
    t = t_init
    res = torch.ones_like(t)
    done = t > t_max
    h_prev = torch.zeros_like(t)
    st_prev = torch.zeros_like(t)
    for _ in range(steps):
        if bool(done.all()):
            break
        h = sdf_fn((o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2]))
        _tally_de(sdf_fn, ~done)
        _tally(~done, 18)
        if relaxed:
            ovr = st_prev > h_prev + torch.abs(h)
            okf = torch.where(ovr, 0.0, 1.0)
        else:
            okf = 1.0
        res_new = torch.minimum(res, kf * h / t)
        s_allowed = (kf * h - res_new * t) / (kf + res_new)
        cap = maximum(s_allowed, 0.5)
        step = torch.minimum(maximum(w * h, f32(1e-3)), cap)
        t_new = t + step
        if relaxed:
            t_new = torch.where(ovr, (t - st_prev) + h_prev, t_new)
        done_new = done | (res_new < f32(0.004)) | (t_new > t_max)
        res = torch.where(done, res, res_new)
        t = torch.where(done, t, t_new)
        h_prev = torch.where(done_new, h_prev, okf * h)
        st_prev = torch.where(done_new, st_prev, okf * step)
        done = done_new
    return clamp(res, 0.0, 1.0)


def visibility_core(static, settings: RenderSettings, lp, nparams,
                    o, l, dist, soft_k=None, cull=None):
    """Shadow visibility of secondary rays through the non-mesh objects
    -> vis.

    Soft shadows: every object's penumbra factor, combined by min (closed
    forms for single plane/sphere leaves, influence-window marches for
    bounded objects; lanes already dark skip later objects). Hard shadows:
    analytic objects occlude exactly, SDF objects by any-hit marches that
    skip segments clear of the object's cover sphere. cull(key, j, live): as in
    trace_core, keys "hard_sdf", "hard_ana" and "soft" of this light."""
    crowd, analytic, sdf_objs = split_crowd(static, settings)
    crowd_refs = _crowd_refs(static, settings, lp, nparams)
    vis = torch.ones_like(o[0])
    eps = settings.shadow_eps

    if settings.soft_shadows and (analytic or sdf_objs or crowd):
        nonmesh = sorted(analytic + sdf_objs,
                         key=lambda io: len(io[1].nodes))
        k = soft_k if soft_k is not None else settings.soft_shadow_k
        kf = k if isinstance(k, torch.Tensor) else f32(k)
        t0 = f32(settings.soft_shadow_tmin)
        lod_fn = _fast_leaf_fn(settings, settings.secondary_lod_iters)
        soft_vis = torch.ones_like(o[0])
        if crowd is not None:
            soft_vis = _crowd_soft_vis(crowd, crowd_refs, o, l, dist,
                                       settings, kf, soft_vis, cull)
        for i, oir in nonmesh:
            cf = _single_leaf_closed_form(oir)
            if cf is not None:
                _tally(dist > 0.0, 16 if cf == LEAF_PLANE else 70)
                prm = lp[oir.leaves[0].slot]
                pen = _penumbra_plane if cf == LEAF_PLANE else \
                    _penumbra_sphere
                soft_vis = torch.minimum(soft_vis,
                                         pen(prm, o, l, t0, dist, kf))
                continue
            sdf_i = _object_sdf(oir, lp, nparams, lod_fn)
            dist_i = torch.where(soft_vis <= 0.0, 0.0, dist)
            b = _object_bound(oir, lp, nparams, lower=True)
            if b is not None:
                _tally(dist_i > 0.0, 30)
                t_lo, t_hi = _influence_window(b, o, l, t0, dist_i, kf)
                v_i = _soft_march(sdf_i, o, l, maximum(t_lo, t0),
                                  torch.minimum(dist_i, t_hi), kf,
                                  settings.shadow_steps,
                                  relax=settings.over_relax)
            else:
                v_i = _soft_march(sdf_i, o, l, torch.full_like(dist_i, t0),
                                  dist_i, kf, settings.shadow_steps,
                                  relax=settings.over_relax)
            soft_vis = torch.minimum(soft_vis, v_i)
        return vis * soft_vis

    for _, oir in analytic:
        t_i, _ = intersect_analytic(oir, lp, o, l, eps, dist)
        _tally(dist > 0.0, _analytic_ops(oir))
        vis = vis * torch.where(t_i < dist, 0.0, 1.0)
    eps_margin = _exit_margin(settings)
    if crowd is not None:
        vis = _crowd_hard_vis(crowd, crowd_refs, o, l, dist, settings,
                              eps_margin, vis, cull)
    if sdf_objs:
        fast_fn = _fast_leaf_fn(settings)
        for i, oir in sorted(sdf_objs, key=lambda io: len(io[1].nodes)):
            sdf_i = _object_sdf(oir, lp, nparams, fast_fn)
            dist_i = torch.where(vis <= 0.0, 0.0, dist)
            b = _object_bound(oir, lp, nparams, cover_margin=eps_margin)
            if b is not None:
                # a segment clear of the cover sphere by more than the
                # worst hit epsilon cannot register an occlusion
                _tally(dist_i > 0.0, 30)
                dseg = _seg_bound_dist(b, o, l, f32(eps), dist)
                dist_i = torch.where(dseg > f32(eps_margin), 0.0, dist_i)
                t1, clip2 = _bound_entry(b, o, l,
                                         torch.full_like(dist_i, f32(eps)),
                                         dist_i, eps_margin)
            else:
                t1, clip2 = torch.full_like(dist_i, f32(eps)), dist_i
            t_s, hit_s = _march(sdf_i, o, l, t1, clip2, settings.max_steps,
                                settings.hit_eps, relax=settings.over_relax,
                                eps_scale=settings.hit_eps_scale)
            occ = hit_s & (t_s < dist_i)
            vis = vis * torch.where(occ, 0.0, 1.0)
    return vis


def _bind(cull, key: str):
    """cull(key, j, live) as a function of (j, live), or None."""
    return None if cull is None else (
        lambda j, live=None: cull(key, j, live))


def _scene_sdf(objs, lp, nparams, leaf_fn):
    def f(p):
        v = eval_sdf(objs[0][1], lp, nparams, p, leaf_fn=leaf_fn)
        for _, oir in objs[1:]:
            v = torch.minimum(v, eval_sdf(oir, lp, nparams, p,
                                          leaf_fn=leaf_fn))
        return v
    f.objs = tuple(oir for _, oir in objs)
    return f


def _ao_compute(static, settings: RenderSettings, lp, nparams, p, n,
                already_offset: bool = False, need=None, cull=None):
    """AO probes over every non-mesh object. Per tap, the occlusion terms
    of object groups combine exactly by max: unbounded objects (plane
    leaves) as one scene-min group, each crowd member and each other
    bounded object on its own, gated per lane: a receiver more than 2*ao_radius outside the object's
    lower-bound sphere gets exactly zero from it at every tap, so its terms
    are not computed.

    already_offset: p is a receiver already offset by the caller (mesh
    hits, offset along the geometric normal); otherwise it is offset here
    along n by shadow_eps. need: the lanes whose AO the caller uses (all
    by default); it only limits what count_ops counts. cull(key, j, live): as in
    trace_core, key "ao"."""
    crowd, analytic, sdf_only = split_crowd(static, settings)
    objs = analytic + sdf_only
    if not objs and crowd is None:
        return torch.ones_like(p[0])
    eps = f32(settings.shadow_eps)
    p_off = p if already_offset else \
        (p[0] + n[0] * eps, p[1] + n[1] * eps, p[2] + n[2] * eps)
    cap = settings.ao_lod_iters or settings.secondary_lod_iters
    lod_fn = _fast_leaf_fn(settings, cap)
    samples, radius = settings.ao_samples, settings.ao_radius

    unbounded = []
    gated = []
    for i, oir in objs:
        b = _object_bound(oir, lp, nparams, lower=True)
        if b is None:
            unbounded.append((i, oir))
            continue
        cx, cy, cz, R = b
        dx = p_off[0] - cx
        dy = p_off[1] - cy
        dz = p_off[2] - cz
        hb = sqrt((dx * dx + dy * dy) + dz * dz) - R
        gated.append(((i, oir), hb <= f32(2.0 * f32(radius))))

    n_terms = min(samples, len(_AO_DIRS)) * 4
    need = torch.ones_like(p_off[0], dtype=torch.bool) if need is None \
        else need
    _tally(need, 30 + 10 * n_terms)
    taps = list(ao_tap_points(p_off, n, samples, radius))
    if unbounded:
        fn = _scene_sdf(unbounded, lp, nparams, lod_fn)
        terms = [ao_tap_term(az, r, fn(q)) for az, r, q in taps]
        _tally_de(fn, need, evals=n_terms)
    else:
        terms = [torch.zeros_like(p_off[0]) for _ in range(n_terms)]
    if crowd is not None:
        terms = _crowd_ao_terms(
            crowd, _crowd_refs(static, settings, lp, nparams), p_off, taps,
            settings, terms, need, _bind(cull, "ao"))
    for (i, oir), near in gated:
        if not bool(near.any()):
            continue
        fn = _object_sdf(oir, lp, nparams, lod_fn)
        terms = [torch.maximum(acc, torch.where(near,
                                                ao_tap_term(az, r, fn(q)),
                                          0.0))
                 for acc, (az, r, q) in zip(terms, taps)]
        _tally_de(fn, near & need, evals=n_terms)
        _tally(near & need, 4 * n_terms)
    return ao_terms_to_factor(terms, samples, settings.ao_strength)


def scene_march_twin(static, settings: RenderSettings, leaf_params,
                     node_params, o, d, t0=None):
    """Trace + normals + AO of flat rays -> (t, obj, n, ao, hit_f); the
    counterpart of surfjax's scene_march_twin. t0: see trace_core."""
    lp, nparams = leaf_params, node_params
    t, obj, leaf, hit_f = trace_core(static, settings, lp, nparams, o, d,
                                     t0=t0)
    t_sane = torch.where(hit_f > 0.5, t, 0.0)
    p = (o[0] + t_sane * d[0], o[1] + t_sane * d[1], o[2] + t_sane * d[2])
    n = normals_core(static, settings, lp, nparams, p, obj, leaf, d)
    analytic, sdf_objs, _ = _split(static)
    if settings.ao and (analytic or sdf_objs):
        ao = _ao_compute(static, settings, lp, nparams, p, n)
    else:
        ao = torch.ones_like(p[0])
    return t, obj, n, ao, hit_f


# ---------------------------------------------------------------------------
# The whole fused frame: twin, checks, wrapper
# ---------------------------------------------------------------------------

class SceneTensors(NamedTuple):
    """A compiled scene on a device: the static SceneWithMeshes plus the
    dict of parameter tensors (params_to_device)."""
    static: object
    params: dict


def frame_rays(intr, cam_rows):
    """Pinhole rays for F frames -> (o, d) component tuples of (F, H, W)
    tensors; cam_rows (F, 12) = [R_flat(9), position(3)] per frame. The
    arithmetic of KF's ray generation, pixel centres at +0.5."""
    dev = cam_rows.device
    F = cam_rows.shape[0]
    H, W = intr.height, intr.width
    rr = torch.arange(H, dtype=torch.float32, device=dev).view(1, H, 1)
    cc = torch.arange(W, dtype=torch.float32, device=dev).view(1, 1, W)
    xc = fdiv(cc + 0.5 - f32(intr.cx), intr.fx)
    yc = fdiv(rr + 0.5 - f32(intr.cy), intr.fy)
    c = [cam_rows[:, k].view(F, 1, 1) for k in range(12)]
    dxd = (c[0] * xc + c[1] * yc) + c[2]
    dyd = (c[3] * xc + c[4] * yc) + c[5]
    dzd = (c[6] * xc + c[7] * yc) + c[8]
    d = vnormalize((dxd, dyd, dzd))
    zeros = torch.zeros((F, H, W), dtype=torch.float32, device=dev)
    o = (zeros + c[9], zeros + c[10], zeros + c[11])
    return o, d


def _light_ray(settings: RenderSettings, kind: int, lrow, p_off):
    """KF's shadow ray of one light from the offset receivers -> (l, dist,
    soft_k): the direction, the segment length (t_max for a directional
    light) and the penumbra sharpness (dist / radius for a point light
    with a radius, else soft_shadow_k)."""
    zeros = torch.zeros_like(p_off[0])
    if kind == LIGHT_POINT:
        lvx = lrow[0] - p_off[0]
        lvy = lrow[1] - p_off[1]
        lvz = lrow[2] - p_off[2]
        dist = sqrt((lvx * lvx + lvy * lvy) + lvz * lvz)
        inv = 1.0 / dist
        l = (lvx * inv, lvy * inv, lvz * inv)
    else:
        l = (zeros - lrow[0], zeros - lrow[1], zeros - lrow[2])
        dist = zeros + f32(settings.t_max)
    radius = lrow[6]
    if bool(radius > 0.0):
        soft_k = dist / radius
    else:
        soft_k = torch.full_like(dist, f32(settings.soft_shadow_k))
    return l, dist, soft_k


def frame_fused_reference(scene_t, settings: RenderSettings, intr, cam_rows,
                          t0=None, masks=None):
    """Plain PyTorch twin of KF over F frames; t0 (F, H, W) or None: the
    primed march starts of trace_core.

    masks: a `crowd_warp_masks` result for the same frames, or None. With
    masks, each lane visits only the crowd members in its warp's mask of
    each member loop, as the CUDA kernel does, and count_ops counts that
    culled algorithm; the buffers are the same to the bit (the masks are
    conservative). Without, every lane visits every member.

    -> (r, g, b, depth, obj, nx, ny, nz, hit), each float32 (F, H, W):
    depth is 0 on a miss, obj carries the object index as a float (-1 on a
    miss) and the normal is zeroed on a miss, exactly as the kernel writes
    them."""
    F, H, W = cam_rows.shape[0], intr.height, intr.width
    o3, d3 = frame_rays(intr, cam_rows)
    o = tuple(c.reshape(-1) for c in o3)
    d = tuple(c.reshape(-1) for c in d3)
    out = fused_pixels(scene_t, settings, o, d,
                       None if t0 is None else t0.reshape(-1), masks)
    return tuple(a.reshape(F, H, W) for a in out)


def fused_pixels(scene_t, settings: RenderSettings, o, d, t0=None,
                 masks=None):
    """The twin's work on flat rays o, d (component tuples) with primed
    starts t0 (flat) or None: each lane is one pixel, independent of the
    others (but for the crowd's masks, which index the whole frames) ->
    the nine flat buffers of frame_fused_reference."""
    static, params = scene_t
    lp, nparams = params["leaf_params"], params["node_params"]
    cull = None if masks is None else masks.lanes
    if masks is not None:
        masks.tally()

    t, obj, leaf, hit_f = trace_core(
        static, settings, lp, nparams, o, d, t0=t0, cull=cull)
    hit = hit_f > 0.5
    t_sane = torch.where(hit, t, 0.0)
    p = (o[0] + t_sane * d[0], o[1] + t_sane * d[1], o[2] + t_sane * d[2])
    n = normals_core(static, settings, lp, nparams, p, obj, leaf, d)
    if settings.ao and static.ir.objects:
        ao = _ao_compute(static, settings, lp, nparams, p, n, need=hit,
                         cull=cull)
    else:
        ao = torch.ones_like(p[0])
    _tally(t.numel(), 20)                                  # ray generation
    _tally(hit, 10 + 40 * len(static.ir.lights))           # shading

    eps = f32(settings.shadow_eps)
    p_off = (p[0] + n[0] * eps, p[1] + n[1] * eps, p[2] + n[2] * eps)
    zeros = torch.zeros_like(t)
    light_terms = []
    lights = params["lights"]
    for li, kind in enumerate(static.ir.lights):
        lrow = lights[li]
        l, dist, soft_k = _light_ray(settings, kind, lrow, p_off)
        lcol = (lrow[3], lrow[4], lrow[5])
        if settings.shadows:
            dist_eff = torch.where(hit, dist, 0.0)
            vis = visibility_core(
                static, settings, lp, nparams, p_off, l, dist_eff,
                soft_k=soft_k, cull=None if cull is None else
                (lambda key, j, live=None, li=li: cull((key, li), j, live)))
        else:
            vis = torch.ones_like(t)
        light_terms.append((l, lcol, vis))

    v = (-d[0], -d[1], -d[2])
    amb = params["ambient"]
    ambient = (amb[0], amb[1], amb[2])
    bg = settings.background
    r = zeros + f32(bg[0])
    g = zeros + f32(bg[1])
    b = zeros + f32(bg[2])
    r, g, b = _shade_hits(static, settings, params, obj, hit, ambient, ao, n,
                          v, light_terms, (r, g, b))

    return (r, g, b, t_sane, obj, n[0] * hit_f, n[1] * hit_f, n[2] * hit_f,
            hit_f)


def _shade_hits(static, settings: RenderSettings, params, obj, hit, ambient,
                ao, n, v, light_terms, rgb):
    """Blinn-Phong shading of every hit lane, object by object; crowd
    members through the gathered-material loop. rgb -> (r, g, b)."""
    crowd = split_crowd(static, settings)[0]
    crowd_objs = {i for i, _ in crowd.members} if crowd else ()
    mats = params["materials"]
    for i, oir in enumerate(static.ir.objects):
        if i in crowd_objs:
            continue
        sel = hit & (obj == float(i))
        if not bool(sel.any()):
            continue
        shaded = shade_object(mats[oir.mat], oir.shininess, ambient, ao, n,
                              v, light_terms)
        rgb = tuple(torch.where(sel, a, b) for a, b in zip(shaded, rgb))
    if crowd is not None:
        rgb = _crowd_shade(
            crowd, _crowd_refs(static, settings, params["leaf_params"],
                               params["node_params"]),
            len(static.ir.objects), mats, obj, hit, ambient, ao, n, v,
            light_terms, rgb)
    return rgb


# ---------------------------------------------------------------------------
# Warp-level member culling: the plain version of what kf_frame_kernel<true>
# votes (csrc/frame_fused.cuh, "Warp-level member culling", which derives
# the regions and the slack)
# ---------------------------------------------------------------------------

CULL_LIN = f32(2.0 ** -18)    # slack of the gates that take no square root
CULL_SQRT = f32(2.0 ** -8)    # slack of those that subtract squares
# count_ops of the vote, hand counts of the kernel's FP32 operations per lane
# (frame_fused.cuh; fabsf and selects are free, a shuffle is no operation,
# the reductions' add/min/max after each of their 5 shuffles count):
#   cull_keep: w 3, v1 5, q 6, perp 6, t 6 (2 compares, k*perp + v1, the
#     clamp's 2), dt 1, r_t 2, gap 5, r_eff 1, scale 6, the test 3 -> 44;
#   crowd_bound: a sphere leaf's 0, a box leaf's |half size| 6; a pair's
#     two leaves' + centre 6 + two reaches 10 each + max 1, smooth + 2;
#   warp_cone: 3 sums 15, vnormalize 10, d - u 3, |d - u| 6, max 5,
#     make_seg 6 (2 compares, 1 - sig^2, sqrt, divide) -> 45;
#   warp_ball: 6 min/max 30, centre 6, p - c 3, |p - c| 6, max 5,
#     make_seg 6 -> 56;
#   warp_light: rho 6 (divide, max), then a point light's axis 15 (L - c
#     3, len 6, inverse 2, u 3, rB 1) or a directional one's 3, inv_len 2,
#     the hard capsule 8 (slope 2, make_seg 6), the soft one 12 (rB_soft 4,
#     slope 2, make_seg 6) -> 43 / 31.
_CULL_KEEP_OPS = 44
_CULL_CONE_OPS = 45
_CULL_BALL_OPS = 56
_CULL_LIGHT_OPS = {LIGHT_POINT: 43, LIGHT_DIRECTIONAL: 31}


def _cull_bound_ops(tag) -> int:
    """crowd_bound's operations for a member of a section with this tag
    (is_sphere, or a pair's (is_sphere0, is_sphere1, op))."""
    if not isinstance(tag, tuple):
        return 0 if tag else 6
    s0, s1, op = tag
    return (0 if s0 else 6) + (0 if s1 else 6) + 27 + (
        2 if op in SMOOTH_OPS else 0)


class WarpSeg(NamedTuple):
    """Tapered capsules, one per warp: points a + t*u, t in [0, len], each
    widened by rA + sig*t; every field a (n_warps, 1) tensor."""
    a: tuple
    u: tuple
    len: torch.Tensor
    rA: torch.Tensor
    sig: torch.Tensor
    k: torch.Tensor
    any: torch.Tensor


def _warp_layout(F: int, H: int, W: int, dev):
    """KF's warps (16x2 pixels of one frame; those with a pixel in the
    frame) -> (lane index into the flat (F*H*W,) pixels for each of the
    (n_warps, 32) lanes, -1 outside the frame; warp of every pixel)."""
    R2, C = -(-H // 2), -(-W // 16)
    f = torch.arange(F, device=dev).view(F, 1, 1, 1, 1)
    i = (2 * torch.arange(R2, device=dev)).view(1, R2, 1, 1, 1) \
        + torch.arange(2, device=dev).view(1, 1, 1, 2, 1)
    j = (16 * torch.arange(C, device=dev)).view(1, 1, C, 1, 1) \
        + torch.arange(16, device=dev).view(1, 1, 1, 1, 16)
    flat = (f * H + i) * W + j
    inside = (i < H) & (j < W)
    lanes = torch.where(inside, flat, -1).reshape(F * R2 * C, 32)
    warp_of = torch.empty(F * H * W, dtype=torch.long, device=dev)
    n_warps = lanes.shape[0]
    w_ids = torch.arange(n_warps, device=dev).view(-1, 1).expand(-1, 32)
    ok = lanes >= 0
    warp_of[lanes[ok]] = w_ids[ok]
    return lanes, warp_of


def _gather(x, lanes, fill: float):
    """Flat per-pixel values -> (n_warps, 32), `fill` outside the frame."""
    return torch.where(lanes >= 0, x[lanes.clamp(min=0)], fill)


def _warp_sum(x):
    """The butterfly of __shfl_xor_sync over offsets 16 .. 1: every lane
    ends with the same sum, in the kernel's order -> (n_warps, 1)."""
    idx = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        x = x + x[:, idx ^ off]
    return x[:, :1]


def _make_seg(a, u, length, rA, sig, any_):
    inside = (sig > -1.0) & (sig < 1.0)
    k = torch.where(inside, sig / sqrt(maximum(1.0 - sig * sig, 0.0)), 0.0)
    return WarpSeg(a, u, length, rA, sig, k, any_)


def _warp_cone(settings: RenderSettings, o, d, active):
    """The primary rays' capsule (kernel: warp_cone)."""
    dm = [torch.where(active, c, 0.0) for c in d]
    u = vnormalize(tuple(_warp_sum(c) for c in dm))
    e = (d[0] - u[0], d[1] - u[1], d[2] - u[2])
    chord = sqrt((e[0] * e[0] + e[1] * e[1]) + e[2] * e[2])
    sig = torch.where(active, chord, 0.0).amax(dim=1, keepdim=True)
    length = torch.full_like(sig, f32(settings.t_max))
    return _make_seg(tuple(c[:, :1] for c in o), u, length,
                     torch.zeros_like(sig), sig, active.any(dim=1,
                                                            keepdim=True))


def _warp_ball(p, active):
    """The active receivers' ball (kernel: warp_ball)."""
    lo = [torch.where(active, c, BIG).amin(dim=1, keepdim=True) for c in p]
    hi = [torch.where(active, c, -BIG).amax(dim=1, keepdim=True) for c in p]
    c = tuple((a + b) * 0.5 for a, b in zip(lo, hi))
    e = (p[0] - c[0], p[1] - c[1], p[2] - c[2])
    r = torch.where(active, sqrt((e[0] * e[0] + e[1] * e[1]) + e[2] * e[2]),
                    0.0).amax(dim=1, keepdim=True)
    zero = torch.zeros_like(r)
    return _make_seg(c, (zero, zero, zero), zero, r, zero,
                     active.any(dim=1, keepdim=True))


def _warp_light(settings: RenderSettings, kind: int, lrow, ball, dist, kf,
                active):
    """One light's hard and soft capsules (kernel: warp_light)."""
    rho = torch.where(active, dist / kf, 0.0).amax(dim=1, keepdim=True)
    if kind == LIGHT_POINT:
        e = tuple(lrow[k] - ball.a[k] for k in range(3))
        length = sqrt((e[0] * e[0] + e[1] * e[1]) + e[2] * e[2])
        inv = torch.where(length > 0.0, 1.0 / length, 0.0)
        u = tuple(c * inv for c in e)
        rB = CULL_LIN * length
    else:
        zero = torch.zeros_like(ball.rA)
        u = tuple(zero - lrow[k] for k in range(3))
        length = zero + f32(settings.t_max)
        rB = ball.rA
    inv_len = torch.where(length > 0.0, 1.0 / length, 0.0)
    hard = _make_seg(ball.a, u, length, ball.rA, (rB - ball.rA) * inv_len,
                     ball.any)
    rB_soft = (rB + rho * f32(1.0 + 2.0 ** -18)) + CULL_SQRT * length
    soft = _make_seg(ball.a, u, length, ball.rA,
                     (rB_soft - ball.rA) * inv_len, ball.any)
    return hard, soft


def cull_margin(b, reach, seg: WarpSeg, rel: float):
    """(n_warps, n_members): how far each member (bound b, (n_members,)
    tensors) lies outside each warp's capsule, beyond its reach and the
    slack `rel` of its scale; the member may matter where this is <= 0
    (kernel: cull_keep)."""
    cx, cy, cz, R = (c.view(1, -1) for c in b)
    ax, ay, az = seg.a
    ux, uy, uz = seg.u
    wx, wy, wz = cx - ax, cy - ay, cz - az
    v1 = (wx * ux + wy * uy) + wz * uz
    qx, qy, qz = wx - v1 * ux, wy - v1 * uy, wz - v1 * uz
    perp = sqrt((qx * qx + qy * qy) + qz * qz)
    t_in = torch.minimum(maximum(v1 + seg.k * perp, 0.0), seg.len)
    t = torch.where(seg.sig >= 1.0, seg.len,
                    torch.where(seg.sig <= -1.0, 0.0, t_in))
    dt = t - v1
    r_t = seg.rA + seg.sig * t
    gap = sqrt(dt * dt + perp * perp) - r_t
    r_eff = R + reach
    scale = (((torch.abs(cx) + torch.abs(cy)) + torch.abs(cz))
             + (torch.abs(v1) + perp)) + (r_eff + torch.abs(r_t))
    return gap - (r_eff + rel * scale)


class CrowdMasks(NamedTuple):
    """crowd_warp_masks' result: per member loop, the (n_warps, n_crowd)
    mask of the members each warp visits (False outside the loop's
    range). Keys "primary_ana", "primary_sdf", "ao", and per light index
    li ("hard_sdf", li), ("hard_ana", li), ("soft", li), for the loops the
    settings run."""
    masks: dict
    warp_of: torch.Tensor    # (F*H*W,) warp of each pixel
    ranges: dict             # key -> the member ranges ((lo, hi), ...)
    tests: dict              # key -> (WarpSeg, reach, rel) of its votes
    bounds: tuple            # the members' bounds (cx, cy, cz, R)
    hit_warps: torch.Tensor  # (n_warps,) warps with a hit lane
    test_ops: tuple          # per member: one lane's test of it
    hit_ops: int             # per lane of a warp with a hit: its regions

    def lanes(self, key, j: int, live=None):
        """-> (F*H*W,) bool: the pixels that visit member j in `key`.

        live: the pixels the loop still changes (None: every pixel); the
        twin calls this once per member, in member order. Where j begins
        one of the loop's 32-member chunks, count_ops counts the chunk's
        tests, one member per lane, on each warp with a live pixel: the
        kernel's cull_members leaves the loop once no lane is live (a
        warp without a hit never enters the secondary loops, one whose
        lanes are all in shadow stops there)."""
        for lo, hi in self.ranges[key]:
            if lo <= j < hi and (j - lo) % 32 == 0:
                if live is None:
                    n = self.hit_warps.numel()
                else:
                    warps = torch.zeros_like(self.hit_warps)
                    warps[self.warp_of[live]] = True
                    n = int(warps.sum())
                _tally(n, sum(self.test_ops[j:min(j + 32, hi)]))
        return self.masks[key][self.warp_of, j]

    def tally(self) -> None:
        """count_ops: the warps' regions on all 32 lanes: the rays' cone
        on every warp, the receivers' ball and the lights' capsules on the
        warps with a hit (the member tests: `lanes`)."""
        _tally(32 * self.hit_warps.numel(), _CULL_CONE_OPS)
        _tally(32 * int(self.hit_warps.sum()), self.hit_ops)

    def counts(self) -> dict:
        """-> key -> (mean, largest) masked members per warp, over the
        warps with an active lane: every warp for the primary loops, the
        warps with a hit for the others."""
        out = {}
        for key, m in self.masks.items():
            name = key if isinstance(key, str) else f"{key[0]} {key[1]}"
            if not name.startswith("primary"):
                m = m[self.hit_warps]
            n = m.sum(dim=1).double()
            out[name] = (float(n.mean()), int(n.max()))
        return out


def crowd_warp_masks(scene_t, settings: RenderSettings, intr, cam_rows,
                     t0=None) -> CrowdMasks:
    """The member masks each warp of kf_frame_kernel<true> votes, with the
    kernel's regions, tests and slack, for F frames of a crowd scene. The
    regions come from the lanes as the kernel has them: the primary rays
    of the pixels in the frame; the hit pixels' offset receivers and their
    shadow rays (from the plain trace, which the masks do not change)."""
    static, params = scene_t
    crowd = split_crowd(static, settings)[0]
    if crowd is None:
        raise ValueError("crowd_warp_masks: the scene forms no crowd")
    F, H, W = cam_rows.shape[0], intr.height, intr.width
    dev = cam_rows.device
    lp, nparams = params["leaf_params"], params["node_params"]
    o3, d3 = frame_rays(intr, cam_rows)
    o = tuple(c.reshape(-1) for c in o3)
    d = tuple(c.reshape(-1) for c in d3)
    lanes, warp_of = _warp_layout(F, H, W, dev)
    in_frame = lanes >= 0

    refs = _crowd_refs(static, settings, lp, nparams)
    tags = {}
    for lo, hi, tag in crowd.all_ranges + crowd.pair_ranges:
        for j in range(lo, hi):
            tags[j] = tag
    n = len(crowd.members)
    bounds = [_crowd_shape(crowd, refs, j, tags[j])[0] for j in range(n)]
    test_ops = tuple(_CULL_KEEP_OPS + _cull_bound_ops(tags[j])
                     for j in range(n))
    b = tuple(torch.stack([torch.as_tensor(bj[k], dtype=torch.float32,
                                           device=dev).reshape(())
                           for bj in bounds]) for k in range(4))
    sdf_end = crowd.n_sph_sdf + crowd.n_box_sdf
    single_end = crowd.n_singles
    em = _exit_margin(settings)
    shell, margin = f32(max(_PROXY_SWITCH, em)), f32(em)

    masks, ranges, tests = {}, {}, {}

    def vote(key, rs, seg, reach, rel):
        tests[key] = (seg, reach, rel)
        keep = (cull_margin(b, reach, seg, rel) <= 0.0) & seg.any
        in_range = torch.zeros(n, dtype=torch.bool, device=dev)
        for lo, hi in rs:
            in_range[lo:hi] = True
        masks[key] = keep & in_range.view(1, -1)
        ranges[key] = rs

    cone = _warp_cone(settings, tuple(_gather(c, lanes, 0.0) for c in o),
                      tuple(_gather(c, lanes, 0.0) for c in d), in_frame)
    vote("primary_ana", ((sdf_end, single_end),), cone, 0.0, CULL_SQRT)
    vote("primary_sdf", ((0, sdf_end), (single_end, n)), cone, shell,
         CULL_SQRT)

    t, obj, leaf, hit_f = trace_core(
        static, settings, lp, nparams, o, d,
        t0=None if t0 is None else t0.reshape(-1))
    hit = hit_f > 0.5
    t_sane = torch.where(hit, t, 0.0)
    p = (o[0] + t_sane * d[0], o[1] + t_sane * d[1], o[2] + t_sane * d[2])
    nrm = normals_core(static, settings, lp, nparams, p, obj, leaf, d)
    eps = f32(settings.shadow_eps)
    p_off = tuple(p[k] + nrm[k] * eps for k in range(3))
    active = _gather(hit, lanes, False).bool()
    ball = _warp_ball(tuple(_gather(c, lanes, 0.0) for c in p_off), active)
    hit_ops = 0
    if settings.ao and static.ir.objects:
        vote("ao", ((0, n),), ball, f32(2.0 * f32(settings.ao_radius)),
             CULL_LIN)
    if settings.shadows:
        hit_ops = sum(_CULL_LIGHT_OPS[kind] for kind in static.ir.lights)
    if settings.shadows or "ao" in masks:
        hit_ops += _CULL_BALL_OPS
    if settings.shadows:
        for li, kind in enumerate(static.ir.lights):
            lrow = params["lights"][li]
            _, dist, kf = _light_ray(settings, kind, lrow, p_off)
            hard, soft = _warp_light(
                settings, kind, lrow, ball, _gather(dist, lanes, 0.0),
                _gather(kf, lanes, 1.0), active)
            if settings.soft_shadows:
                vote(("soft", li), ((0, n),), soft, 0.0, CULL_SQRT)
            else:
                vote(("hard_sdf", li), ((0, sdf_end), (single_end, n)),
                     hard, margin, CULL_LIN)
                vote(("hard_ana", li), ((sdf_end, single_end),), hard, 0.0,
                     CULL_SQRT)
    return CrowdMasks(masks, warp_of, ranges, tests, b, active.any(dim=1),
                      test_ops, hit_ops)


def check_scene(static, settings: RenderSettings, meshes: bool = False
                ) -> None:
    """Raise on anything the kernels and their plain versions do not take;
    meshes=False for the fused path, which takes no mesh objects."""
    if settings.march_cap or settings.shadow_march_cap:
        raise NotImplementedError(
            "march_cap / shadow_march_cap are not ported yet")
    if settings.max_steps <= 0 or settings.shadow_steps <= 0:
        raise ValueError(
            f"step budgets must be positive; got max_steps="
            f"{settings.max_steps}, shadow_steps={settings.shadow_steps}")
    if settings.bulb_iter not in ("std", "cheb"):
        raise ValueError(f"bulb_iter must be 'std' or 'cheb'; got "
                         f"{settings.bulb_iter!r}")
    if settings.bulb_log not in ("hw", "portable"):
        raise ValueError(f"bulb_log must be 'hw' or 'portable'; got "
                         f"{settings.bulb_log!r}")
    if settings.normals not in ("auto", "fd"):
        raise ValueError(f"normals must be 'auto' or 'fd'; got "
                         f"{settings.normals!r}")
    if meshes and (settings.tile_rows <= 0 or settings.tile_rows % 8):
        raise ValueError(f"tile_rows must be a positive multiple of 8; got "
                         f"{settings.tile_rows}")
    _, rest_ana, rest_sdf = split_crowd(static, settings)
    if len(rest_ana) + len(rest_sdf) > MAX_OBJECTS:
        raise ValueError(
            f"scene has {len(rest_ana) + len(rest_sdf)} non-mesh objects "
            f"outside the crowd; the kernels take at most {MAX_OBJECTS} "
            "(crowd members, see vector_objects, are not counted)")
    for oir in static.ir.objects:
        if oir.engine == ENGINE_MESH:
            if not meshes:
                raise ValueError("the fused path takes no mesh objects; "
                                 "mesh scenes take the split path")
            continue
        if len(oir.nodes) > MAX_TAPE_NODES:
            raise ValueError(
                f"object tape has {len(oir.nodes)} nodes; the kernels take "
                f"at most {MAX_TAPE_NODES}")
        if len(oir.leaves) > MAX_ANALYTIC_LEAVES and \
                oir.engine == ENGINE_ANALYTIC:
            raise ValueError(
                f"analytic object has {len(oir.leaves)} leaves; the "
                f"kernels take at most {MAX_ANALYTIC_LEAVES}")
        for lf in oir.leaves:
            if lf.kind == LEAF_MANDELBULB and lf.p0 != 8:
                raise NotImplementedError(POWER8_ONLY_MSG)


# --- the CUDA route ---------------------------------------------------------

# Row widths of the int tables the kernels read (see frame_fused.cuh).
OBJ_W = 12
NODE_W = 5
LEAF_W = 5
CROWD_W = 8     # crowd_meta's six columns, then the member's type and tag
# member types of a crowd row, and the tag: is_sphere for a single,
# is_sphere0 | is_sphere1 << 1 | op << 2 for a pair
CROWD_SDF, CROWD_ANALYTIC, CROWD_PAIR = 0, 1, 2


class KFTables(ctypes.Structure):
    """Device pointers handed to kf_frame_fused (frame_fused.cuh)."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "objects", "nodes", "leaves", "order", "light_kinds", "crowd",
        "leaf_params", "node_params", "lights", "materials", "ambient",
        "cam_rows", "t0", "out")]


class KFSettings(ctypes.Structure):
    """Settings passed by value to kf_frame_fused (frame_fused.cuh)."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "F", "H", "W", "n_objects", "n_ana", "n_sdf", "n_lights",
        "max_steps", "shadow_steps", "shadows", "soft_shadows", "ao",
        "ao_samples", "normals_fd", "relaxed", "bulb_cheb", "bulb_portable",
        "secondary_lod", "ao_lod", "n_crowd", "crowd_sdf_end",
        "crowd_single_end")] + [(name, ctypes.c_float) for name in (
        "fx", "fy", "cx", "cy", "t_min", "t_max", "hit_eps", "hit_eps_scale",
        "over_relax", "normal_eps", "soft_shadow_k", "soft_shadow_tmin",
        "shadow_eps", "ao_radius", "ao_strength", "exit_margin",
        "default_shell", "bg_r", "bg_g", "bg_b")]


def _crowd_rows(crowd, meta) -> np.ndarray:
    """crowd_meta's rows widened to CROWD_W with each member's type and
    tag, so that a kernel thread can take any member on its own."""
    rows = np.zeros((len(meta), CROWD_W), np.int32)
    rows[:, :6] = meta
    if crowd is None:
        return rows
    for typ, ranges in ((CROWD_SDF, crowd.sdf_ranges),
                        (CROWD_ANALYTIC, crowd.ana_ranges),
                        (CROWD_PAIR, crowd.pair_ranges)):
        for lo, hi, tag in ranges:
            if isinstance(tag, tuple):
                tag = int(tag[0]) | int(tag[1]) << 1 | tag[2] << 2
            rows[lo:hi, 6] = typ
            rows[lo:hi, 7] = int(tag)
    return rows


def pack_scene(static, settings: RenderSettings = RenderSettings()):
    """Host-side statics of a scene -> int32 numpy tables for the kernels:
    objects (n, OBJ_W), nodes (total, NODE_W), leaves (total, LEAF_W),
    order (of the objects outside the crowd: analytic in scene order ++
    SDF by node count ++ both by node count, the stable sorts of surfjax),
    light kinds and the crowd rows (_crowd_rows); then the counts (n_ana,
    n_sdf, n_crowd, crowd_sdf_end, crowd_single_end): crowd members
    [0, crowd_sdf_end) are SDF singles, up to crowd_single_end analytic
    singles, the rest pairs."""
    crowd, analytic, sdf_objs = split_crowd(static, settings)
    member_row = {i: j for j, (i, _) in enumerate(crowd.members)} \
        if crowd else {}
    objects, nodes, leaves = [], [], []
    for i, oir in enumerate(static.ir.objects):
        cf = _single_leaf_closed_form(oir)
        boundable = not any(lf.kind == LEAF_PLANE for lf in oir.leaves)
        objects.append([oir.engine, oir.mat, oir.shininess, len(nodes),
                        len(oir.nodes), len(leaves), len(oir.leaves),
                        int(boundable), -1 if cf is None else cf,
                        int(_bulb_shell_static(oir)), member_row.get(i, -1),
                        int(_proxy_bounded(oir))])
        nodes.extend(list(nd) for nd in oir.nodes)
        leaves.extend(list(lf) for lf in oir.leaves)
    by_nodes = lambda io: len(io[1].nodes)  # noqa: E731
    order = ([i for i, _ in analytic]
             + [i for i, _ in sorted(sdf_objs, key=by_nodes)]
             + [i for i, _ in sorted(analytic + sdf_objs, key=by_nodes)])

    def table(rows, width):
        a = np.asarray(rows, np.int32).reshape(-1, width)
        return a if a.size else np.zeros((1, width), np.int32)

    n_crowd = len(crowd.members) if crowd else 0
    sdf_end = crowd.n_sph_sdf + crowd.n_box_sdf if crowd else 0
    return (table(objects, OBJ_W), table(nodes, NODE_W),
            table(leaves, LEAF_W),
            np.asarray(order or [0], np.int32),
            np.asarray(list(static.ir.lights) or [0], np.int32),
            _crowd_rows(crowd, crowd_meta(static, settings)),
            (len(analytic), len(sdf_objs), n_crowd, sdf_end,
             crowd.n_singles if crowd else 0))


def kernel_settings(static, settings: RenderSettings, intr, F: int,
                    counts) -> KFSettings:
    """The by-value settings struct; every float is rounded to float32
    on the host exactly as the twin rounds it. The split kernels take no
    camera: intr None leaves F, H, W and the intrinsics 0."""
    em = _exit_margin(settings)
    bg = settings.background
    n_ana, n_sdf, n_crowd, crowd_sdf_end, crowd_single_end = counts
    if intr is None:
        from surfjax_torch.core.camera import Intrinsics
        intr = Intrinsics(0, 0, 0.0, 0.0, 0.0, 0.0)
    return KFSettings(
        F=F, H=intr.height, W=intr.width,
        n_objects=len(static.ir.objects), n_ana=n_ana, n_sdf=n_sdf,
        n_lights=len(static.ir.lights),
        max_steps=settings.max_steps, shadow_steps=settings.shadow_steps,
        shadows=int(settings.shadows), soft_shadows=int(settings.soft_shadows),
        ao=int(settings.ao),
        ao_samples=min(settings.ao_samples, len(_AO_DIRS)),
        normals_fd=int(settings.normals == "fd"),
        relaxed=int(settings.over_relax > 1.0),
        bulb_cheb=int(settings.bulb_iter == "cheb"),
        bulb_portable=int(settings.bulb_log == "portable"),
        secondary_lod=settings.secondary_lod_iters,
        ao_lod=settings.ao_lod_iters or settings.secondary_lod_iters,
        n_crowd=n_crowd, crowd_sdf_end=crowd_sdf_end,
        crowd_single_end=crowd_single_end,
        fx=f32(intr.fx), fy=f32(intr.fy), cx=f32(intr.cx), cy=f32(intr.cy),
        t_min=f32(settings.t_min), t_max=f32(settings.t_max),
        hit_eps=f32(settings.hit_eps),
        hit_eps_scale=f32(settings.hit_eps_scale),
        over_relax=f32(settings.over_relax),
        normal_eps=f32(settings.normal_eps),
        soft_shadow_k=f32(settings.soft_shadow_k),
        soft_shadow_tmin=f32(settings.soft_shadow_tmin),
        shadow_eps=f32(settings.shadow_eps),
        ao_radius=f32(settings.ao_radius),
        ao_strength=f32(settings.ao_strength),
        exit_margin=f32(em), default_shell=f32(max(_PROXY_SWITCH, em)),
        bg_r=f32(bg[0]), bg_g=f32(bg[1]), bg_b=f32(bg[2]))


@functools.lru_cache(maxsize=16)
def _packed_on(static, vector_objects: bool, device: str):
    """pack_scene's int tables as tensors on `device` and its counts, kept
    across calls (the wrappers run once per frame and light)."""
    *tables, counts = pack_scene(
        static, RenderSettings(vector_objects=vector_objects))
    return [torch.as_tensor(a, device=device) for a in tables], counts


def _scene_tables(scene_t, settings: RenderSettings, dev):
    """The host-packed int tables and the float parameter tensors of a
    scene on `dev`, in KFTables order up to `cam_rows` -> (tensors,
    counts). Raises on a parameter tensor the kernels do not take."""
    static, params = scene_t
    ints, counts = _packed_on(static, bool(settings.vector_objects),
                              str(dev))
    names = ("leaf_params", "node_params", "lights", "materials", "ambient")
    floats = [params[k] for k in names]
    for name, ten in zip(names, floats):
        _check_f32_on(name, ten, dev)
    return list(ints) + floats, counts


def _check_f32_on(name: str, ten, dev) -> None:
    if ten.device != dev or ten.dtype != torch.float32 or \
            not ten.is_contiguous():
        raise ValueError(f"{name}: need a contiguous float32 tensor on "
                         f"{dev}; got {ten.dtype} on {ten.device}")


def _raise_on(err: int, entry: str) -> None:
    if err != 0:
        from surfjax_torch.kernels import _build
        raise RuntimeError(f"{entry} launch failed: cudaError {err} "
                           f"({_build.error_string(err)})")


# The staged kernel for scenes without a crowd (csrc/kf_staged.cuh): its
# block, the records it keeps in shared memory and the phases of its
# profile, as the header defines them; then the phases of the profile of
# the per-pixel kernel it replaced (csrc/kf_frame_prof.cu).
KS_THREADS = 128
KS_REC, KS_CTR = 16, 1
KP_OBJ, KP_LIGHTS = 8, 4
KP_PHASE_NAMES = (
    ["ray"] + [f"primary o{k}" for k in range(KP_OBJ)]
    + ["normal", "ao setup", "ao unbounded"]
    + [f"ao o{k}" for k in range(KP_OBJ)] + ["ao sum"]
    + [f"vis l{li} o{k}" for li in range(KP_LIGHTS) for k in range(KP_OBJ)]
    + ["shade", "write"])
KF_PROF_NAMES = (["ray", "primary", "normal", "ao"]
                 + [f"vis l{li}" for li in range(KP_LIGHTS)]
                 + ["shade", "write"])


class KSLayout(ctypes.Structure):
    """The staged kernel's dynamic shared memory: byte offsets of its
    sections and the sizes of the tables it stages (kf_staged.cuh)."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "bytes", "n_nodes", "n_leaves", "n_order", "n_leaf_rows", "n_kp",
        "ctr", "objects", "nodes", "leaves", "order", "leaf_params",
        "node_params", "bounds", "rec")]


def staged_layout(n_objects: int, n_nodes: int, n_leaves: int, n_order: int,
                  n_leaf_rows: int, n_kp: int,
                  records: bool = True) -> KSLayout:
    """The block's shared memory for a scene of these table sizes: the work
    slot, the staged scene (its tables and two bounding spheres per
    object, mesh objects included: their rows are staged, their bounds
    left unset) and, for the fused kernel (`records`), the pixels'
    records, each section 16-byte aligned, in the order of KSLayout.
    `bytes` is the total the launch asks for."""
    words = {
        "ctr": KS_CTR,
        "objects": n_objects * OBJ_W,
        "nodes": n_nodes * NODE_W,
        "leaves": n_leaves * LEAF_W,
        "order": n_order,
        "leaf_params": n_leaf_rows * 8,
        "node_params": n_kp,
        "bounds": n_objects * 8,
        "rec": KS_REC * KS_THREADS if records else 0,
    }
    lay = KSLayout(n_nodes=n_nodes, n_leaves=n_leaves, n_order=n_order,
                   n_leaf_rows=n_leaf_rows, n_kp=n_kp)
    at = 0
    for name, n in words.items():
        setattr(lay, name, at)
        at += -(-4 * n // 16) * 16
    lay.bytes = at
    return lay


def _scene_layout(tables, records: bool = True) -> KSLayout:
    """staged_layout of the tables _scene_tables returns."""
    objects, nodes, leaves, order = tables[:4]
    leaf_params, node_params = tables[6], tables[7]
    return staged_layout(objects.shape[0], nodes.shape[0], leaves.shape[0],
                         order.numel(), leaf_params.shape[0],
                         node_params.numel(), records)


def _kernel_args(scene_t, settings: RenderSettings, intr, cam_rows, t0):
    """The launch's arguments -> (KFTables, KFSettings, the scene's tables,
    its counts, the output tensor (9, F, H, W))."""
    static, _ = scene_t
    dev = cam_rows.device
    F = cam_rows.shape[0]
    tables, counts = _scene_tables(scene_t, settings, dev)
    if not cam_rows.is_contiguous():
        raise ValueError("cam_rows: need a contiguous float32 tensor")
    if t0 is not None:
        _check_f32_on("t0", t0, dev)
    out = torch.empty((9, F, intr.height, intr.width), dtype=torch.float32,
                      device=dev)
    tab = KFTables(*[t.data_ptr() for t in tables + [cam_rows]],
                   None if t0 is None else t0.data_ptr(), out.data_ptr())
    ks = kernel_settings(static, settings, intr, F, counts)
    return tab, ks, tables, counts, out


def _launch_kernel(scene_t, settings: RenderSettings, intr, cam_rows, t0):
    from surfjax_torch.kernels import _build
    dev = cam_rows.device
    tab, ks, tables, counts, out = _kernel_args(scene_t, settings, intr,
                                                cam_rows, t0)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if counts[2] > 0:   # a crowd: kf_frame_kernel<true>
            err = lib.kf_frame_fused(tab, ks, dev.index, stream)
            entry = "kf_frame_fused"
        else:
            # the staged kernel's tile counter, zeroed
            work = torch.zeros(1, dtype=torch.int32, device=dev)
            err = lib.ks_frame_fused(tab, ks, _scene_layout(tables), None,
                                     work.data_ptr(), dev.index, stream)
            entry = "ks_frame_fused"
    _raise_on(err, entry)
    frame_fused.launches += 1
    return tuple(out[k] for k in range(9))


def _fused_launcher(scene_t, settings: RenderSettings, intr, cam_rows, t0,
                    profile: bool, call):
    """A fused-kernel launch on a scene without a crowd, prepared once ->
    (launch, out, prof): launch() runs call(lib, tab, ks, layout, prof
    pointer or None, stream) -> error code, once, on the current stream
    (not counted in `frame_fused.launches`: this is for timing and
    profiling, not a render path), into out (9, F, H, W); with profile,
    prof is int64 (tiles * 4 warps, len(KP_PHASE_NAMES), 3), zeroed at
    every launch, else None. Raises on a crowd."""
    from surfjax_torch.kernels import _build
    dev = cam_rows.device
    tab, ks, tables, counts, out = _kernel_args(scene_t, settings, intr,
                                                cam_rows.contiguous(), t0)
    if counts[2] > 0:
        raise ValueError("these launchers take scenes without a crowd")
    layout = _scene_layout(tables)
    tiles = (-(-intr.width // 16) * -(-intr.height // 8) * cam_rows.shape[0])
    prof = torch.zeros((tiles * (KS_THREADS // 32), len(KP_PHASE_NAMES), 3),
                       dtype=torch.int64, device=dev) if profile else None
    lib = _build.load()

    def launch():
        if prof is not None:
            prof.zero_()
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(call(lib, tab, ks, layout,
                       None if prof is None else prof.data_ptr(), stream),
                  "fused kernel launcher")

    return launch, tuple(out[k] for k in range(9)), prof


def staged_launcher(scene_t, settings: RenderSettings, intr, cam_rows,
                    t0=None, profile: bool = False):
    """The staged kernel (see _fused_launcher), its tile counter zeroed at
    every launch; profile: its profiling instantiation, whose counters
    (phases KP_PHASE_NAMES; per phase cycles, loop trips and
    lane-evaluations) go to prof."""
    dev = cam_rows.device
    work = torch.zeros(1, dtype=torch.int32, device=dev)

    def call(lib, tab, ks, layout, prof, stream):
        work.zero_()
        return lib.ks_frame_fused(tab, ks, layout, prof, work.data_ptr(),
                                  dev.index, stream)

    return _fused_launcher(scene_t, settings, intr, cam_rows, t0, profile,
                           call)


def frame_profile_launcher(scene_t, settings: RenderSettings, intr,
                           cam_rows, t0=None):
    """The profile of kf_frame_kernel<false>, the per-pixel kernel the
    staged kernel replaced (csrc/kf_frame_prof.cu; see _fused_launcher):
    its phases are KF_PROF_NAMES, the first of prof's, cycles only."""
    def call(lib, tab, ks, layout, prof, stream):
        return lib.kf_frame_profile(tab, ks, prof, cam_rows.device.index,
                                    stream)

    return _fused_launcher(scene_t, settings, intr, cam_rows, t0, True, call)


def staged_occupancy(scene_t, settings: RenderSettings, dev) -> dict:
    """The production staged kernel's shared memory per block and resident
    blocks per SM on the card, for this scene."""
    from surfjax_torch.kernels import _build
    tables, _ = _scene_tables(scene_t, settings, dev)
    layout = _scene_layout(tables)
    blocks = ctypes.c_int(0)
    _raise_on(_build.load().ks_occupancy(layout, ctypes.byref(blocks)),
              "ks_occupancy")
    return {"bytes": layout.bytes, "blocks_per_sm": blocks.value}


def frame_fused(scene_t, settings: RenderSettings, intr, cam_rows, t0=None):
    """KF for F frames -> the 9 float32 (F, H, W) tensors of
    frame_fused_reference; t0 (F, H, W) float32 or None: the primed march
    starts.

    CUDA tensors launch the hand-written kernel (and count the launch in
    `frame_fused.launches`); CPU tensors run the plain twin. Anything the
    kernel does not take raises."""
    static, params = scene_t
    check_scene(static, settings)
    if cam_rows.dim() != 2 or cam_rows.shape[1] != 12:
        raise ValueError(f"cam_rows must be (F, 12); got "
                         f"{tuple(cam_rows.shape)}")
    if cam_rows.dtype != torch.float32:
        raise ValueError(f"cam_rows must be float32; got {cam_rows.dtype}")
    if t0 is not None and tuple(t0.shape) != (
            cam_rows.shape[0], intr.height, intr.width):
        raise ValueError(f"t0 must be (F, H, W); got {tuple(t0.shape)}")
    if cam_rows.device.type == "cuda":
        return _launch_kernel(scene_t, settings, intr, cam_rows.contiguous(),
                              t0)
    if cam_rows.device.type == "cpu":
        return frame_fused_reference(scene_t, settings, intr, cam_rows, t0)
    raise ValueError(f"unsupported device {cam_rows.device}")


frame_fused.launches = 0


def frame_buffers(out) -> FrameBuffers:
    """The 9 (F, H, W) tensors of frame_fused -> FrameBuffers with a
    leading frame axis: rgb (F, H, W, 3), depth/hit (F, H, W), obj_id
    int32 (-1 on a miss)."""
    r, g, b, t, obj, nx, ny, nz, hit_f = out
    return FrameBuffers(
        rgb=torch.stack([r, g, b], dim=-1),
        depth=t,
        normal=torch.stack([nx, ny, nz], dim=-1),
        hit=hit_f,
        obj_id=torch.where(hit_f > 0.5, obj.to(torch.int32), -1)
        .to(torch.int32),
    )




def fused_frame_ok(static, settings: RenderSettings) -> bool:
    """True when a frame takes KF: a mesh-free scene. Mesh scenes take the
    split pipeline (the reference also sends the capped-march residual
    there; caps are not ported and raise)."""
    return not _split(static)[2]


def _maybe_warn_crowd(static, settings: RenderSettings) -> None:
    """A large scene with the crowd off -> point the user at
    vector_objects."""
    if settings.vector_objects:
        return
    probe = split_crowd(static, settings.with_(vector_objects=True))[0]
    if probe is not None and len(probe.members) >= 24:
        import warnings
        warnings.warn(
            f"scene has {len(probe.members)} crowd-eligible objects; "
            "consider RenderSettings(vector_objects=True): member loops "
            f"with bitwise-equal geometry, and no limit of {MAX_OBJECTS} "
            "objects", RuntimeWarning)


def render_sequence_pallas(static, intr, settings: RenderSettings, params,
                           R_flats, positions) -> FrameBuffers:
    """F frames -> FrameBuffers with a leading frame axis (see
    frame_buffers): one fused call for a mesh-free scene without priming,
    else one frame after another (priming is a single-frame pass, and a
    mesh scene takes the split path), as surfjax's _sequence_jit routes
    them."""
    F = R_flats.shape[0]
    if settings.prime or not fused_frame_ok(static, settings):
        frames = [render_frame_pallas(static, intr, settings, params,
                                      R_flats[f], positions[f])
                  for f in range(F)]
        return FrameBuffers(*(torch.stack(parts) for parts in zip(*frames)))
    _maybe_warn_crowd(static, settings)
    cam_rows = torch.cat([R_flats.reshape(F, 9), positions.reshape(F, 3)],
                         dim=1).to(torch.float32).contiguous()
    return frame_buffers(frame_fused(SceneTensors(static, params), settings,
                                     intr, cam_rows))


PRIME_BLOCK = 4    # a coarse ray of the priming pass stands for 4x4 pixels


def prime_frame(static, intr, settings: RenderSettings, params, R_flat,
                cam_pos):
    """The priming pass of one frame -> t0 (H, W), a safe SDF-march start
    for every pixel, or None when the frame is not primed: priming needs
    settings.prime, an SDF object, min(H, W) >= settings.prime_min and no
    active crowd (members are cheap primitives; the pass does not know
    them).

    One coarse ray per 4x4 pixel block, through the middle of the block's
    (edge-clamped) pixel range, so every child pixel lies within 1.5 px of
    it on each axis; the cone marched is twice as wide as the block, which
    leaves each child a clearance of k_blk*t at t_safe."""
    from surfjax_torch.core.camera import camera_ray_dirs_dyn
    H, W = intr.height, intr.width
    crowd, _, sdf_objs = split_crowd(static, settings)
    if not (settings.prime and sdf_objs and min(H, W) >= settings.prime_min
            and crowd is None):
        return None
    dev = R_flat.device
    C = PRIME_BLOCK
    Hc, Wc = (H + C - 1) // C, (W + C - 1) // C

    def centres(n_coarse: int, n_px: int):
        i = torch.arange(n_coarse, dtype=torch.float32, device=dev)
        last = float(n_px - 1)
        return (torch.clamp(i * C, max=last)
                + torch.clamp(i * C + (C - 1), max=last)) * 0.5

    rr_c, cc_c = torch.meshgrid(centres(Hc, H), centres(Wc, W),
                                indexing="ij")
    d_c = tuple(c.contiguous() for c in
                camera_ray_dirs_dyn(intr, R_flat, rr_c, cc_c))
    o_c = tuple(cam_pos[k].expand(rr_c.shape).contiguous() for k in range(3))
    k_blk = 1.5 * np.sqrt(2.0) / min(intr.fx, intr.fy)
    t0_c = prime_tile(SceneTensors(static, params), settings,
                      float(2.0 * k_blk), o_c, d_c)
    return (t0_c.repeat_interleave(C, dim=0).repeat_interleave(C, dim=1)
            [:H, :W].contiguous())


def render_frame_pallas(static, intr, settings: RenderSettings, params,
                        R_flat, cam_pos) -> FrameBuffers:
    """One frame -> FrameBuffers (H, W, ...): the priming pass where it
    applies (prime_frame), then the fused path for a mesh-free scene; else
    the split path on SQUARE pixel tiles, each (tile_rows, 128) block of
    the padded ray arrays a tile_rows x 128 rectangle of the image (the
    mesh kernel's candidate sets are per tile, so spatial coherence keeps
    them small)."""
    fused = fused_frame_ok(static, settings)
    _maybe_warn_crowd(static, settings)
    check_scene(static, settings, meshes=not fused)
    t0 = prime_frame(static, intr, settings, params, R_flat, cam_pos)
    if fused:
        cam_rows = torch.cat([R_flat.reshape(9), cam_pos.reshape(3)]
                             ).reshape(1, 12).to(torch.float32).contiguous()
        fb = frame_buffers(frame_fused(
            SceneTensors(static, params), settings, intr, cam_rows,
            None if t0 is None else t0[None]))
        return FrameBuffers(*(a[0] for a in fb))
    from surfjax_torch.core.camera import camera_ray_dirs_dyn
    dev = R_flat.device
    H, W = intr.height, intr.width
    R = settings.tile_rows
    H2 = ((H + R - 1) // R) * R
    W2 = ((W + LANES - 1) // LANES) * LANES
    ty, tx = H2 // R, W2 // LANES
    rows = torch.clamp(torch.arange(H2, dtype=torch.float32, device=dev),
                       max=float(H - 1))
    cols = torch.clamp(torch.arange(W2, dtype=torch.float32, device=dev),
                       max=float(W - 1))
    rr, cc = torch.meshgrid(rows, cols, indexing="ij")

    def tile_layout(a):
        return (a.reshape(ty, R, tx, LANES).permute(0, 2, 1, 3)
                .reshape(ty * tx * R, LANES))

    def untile(a):
        a = a.reshape(ty, tx, R, LANES).permute(0, 2, 1, 3)
        return a.reshape(H2, W2)[:H, :W]

    rr_t, cc_t = tile_layout(rr), tile_layout(cc)
    d = tuple(c.contiguous() for c in
              camera_ray_dirs_dyn(intr, R_flat, rr_t, cc_t))
    o = tuple(cam_pos[k].expand(rr_t.shape).contiguous() for k in range(3))
    if t0 is not None:
        # a padded lane repeats an edge pixel's ray and takes its start
        t0 = tile_layout(t0[rr.long(), cc.long()]).contiguous()
    fb = _render_padded(static, settings, params, o, d, t0=t0)
    return FrameBuffers(
        rgb=torch.stack([untile(fb.rgb[..., k]) for k in range(3)], dim=-1),
        depth=untile(fb.depth),
        normal=torch.stack([untile(fb.normal[..., k]) for k in range(3)],
                           dim=-1),
        hit=untile(fb.hit),
        obj_id=untile(fb.obj_id),
    )


# ---------------------------------------------------------------------------
# The split path: K1, K2, ao_fix (plain versions, wrappers) and drivers
# ---------------------------------------------------------------------------


class SplitRays(ctypes.Structure):
    """Flat ray arrays of a split-kernel launch (csrc/split_path.cu)."""
    _fields_ = [("inp", ctypes.c_void_p * 8), ("out", ctypes.c_void_p * 8),
                ("n", ctypes.c_int)]


def render_tile_reference(scene_t, settings: RenderSettings, o, d, t0=None):
    """Plain version of K1 -> (t, obj, nx, ny, nz, ao, hit_f): the raw
    trace t of the non-mesh objects (BIG on a miss), the object index as a
    float (-1 on a miss), the face-forwarded normal, AO at the hit (on
    every lane, as surfjax's K1 does) and the hit flag. t0: the primed
    march starts of trace_core, or None."""
    static, params = scene_t
    t, obj, n, ao, hit_f = scene_march_twin(
        static, settings, params["leaf_params"], params["node_params"], o, d,
        t0=t0)
    return (t, obj, n[0], n[1], n[2], ao, hit_f)


def trace_rays_reference(scene_t, settings: RenderSettings, o, l, dist,
                         soft_k):
    """Plain version of K2 -> vis of one light along l over [.., dist]
    through the non-mesh objects (soft_k: per-lane penumbra sharpness)."""
    static, params = scene_t
    return visibility_core(static, settings, params["leaf_params"],
                           params["node_params"], o, l, dist,
                           soft_k=soft_k)


def ao_fix_reference(scene_t, settings: RenderSettings, p_off, n, need,
                     ao_in):
    """Plain version of ao_fix -> AO at the pre-offset receivers p_off
    where need > 0.5, ao_in elsewhere."""
    static, params = scene_t
    ao_new = _ao_compute(static, settings, params["leaf_params"],
                         params["node_params"], p_off, n,
                         already_offset=True, need=need > 0.5)
    return torch.where(need > 0.5, ao_new, ao_in)


def _ray_arrays(args):
    """The plain version's ray arguments (tensors or component tuples) ->
    the flat list of float32 arrays of one shape, on one device."""
    ins = [c for a in args for c in (a if isinstance(a, tuple) else (a,))]
    shape, dev = ins[0].shape, ins[0].device
    for k, a in enumerate(ins):
        if a.device != dev or a.dtype != torch.float32 or a.shape != shape:
            raise ValueError(f"ray array {k}: need float32 {tuple(shape)} on "
                             f"{dev}; got {a.dtype} {tuple(a.shape)} on "
                             f"{a.device}")
    return ins


def _split_args(scene_t, settings: RenderSettings, args, n_out: int):
    """A split kernel's launch arguments -> (KFTables, KFSettings,
    SplitRays, the tensors they point to, the scene's counts, the output
    tensor (n_out, *shape))."""
    static, _ = scene_t
    ins = [a.contiguous() for a in _ray_arrays(args)]
    shape, dev = ins[0].shape, ins[0].device
    tables, counts = _scene_tables(scene_t, settings, dev)
    out = torch.empty((n_out,) + tuple(shape), dtype=torch.float32,
                      device=dev)
    tab = KFTables(*[t.data_ptr() for t in tables], None, None, None)
    ks = kernel_settings(static, settings, None, 0, counts)
    rays = SplitRays()
    for k, a in enumerate(ins):
        rays.inp[k] = a.data_ptr()
    for k in range(n_out):
        rays.out[k] = out[k].data_ptr()
    rays.n = out[0].numel()
    return tab, ks, rays, (ins, tables), counts, out


def _split_enqueue(dev, call, entry: str, keep):
    """-> launch(): call(stream) on the current stream of dev, raising if
    the launch was refused; it returns `keep`, the tensors the kernel
    reads, so that they stay alive as long as launch does."""
    def launch():
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            _raise_on(call(ctypes.c_void_p(stream)), entry)
        return keep
    return launch


def split_launcher(entry: str, scene_t, settings: RenderSettings, args,
                   n_out: int):
    """Prepare one launch of the split kernel `entry` on CUDA tensors ->
    (launch, outputs): launch() enqueues the kernel on the current stream,
    writing `outputs`, and raises if the launch was refused. The wrappers
    launch once; chip_smoke.py times repeated launches."""
    from surfjax_torch.kernels import _build
    prepared = _split_args(scene_t, settings, args, n_out)
    tab, ks, rays, keep, counts, out = prepared
    if entry in STAGED and counts[2] == 0:
        # K1 and K2 without a crowd
        return _staged_launcher(STAGED[entry], prepared, False)[:2]
    dev = out.device
    fn = getattr(_build.load(), entry)
    launch = _split_enqueue(
        dev, lambda stream: fn(tab, ks, rays, dev.index, stream), entry,
        keep)
    return launch, tuple(out[k] for k in range(n_out))


# The entries of split_path.cu whose calls on a scene without a crowd go to
# the kernels of csrc/split_staged.cu
STAGED = {"sp_render_tile": "render_tile", "sp_trace_rays": "trace_rays"}


def staged_split_launcher(entry: str, scene_t, settings: RenderSettings,
                          args, profile: bool = False):
    """Prepare a launch of K1 (entry "render_tile") or K2 ("trace_rays")
    for a scene without a crowd (csrc/split_staged.cu) on CUDA tensors ->
    (launch, outputs, prof): as split_launcher; with profile, the profiling
    instantiation, whose counters go to prof, int64 (rows * 4 warps,
    len(KP_PHASE_NAMES), 3), zeroed at every launch (per phase cycles,
    loop trips and lane-evaluations), else None. K2's two work counters
    are zeroed once here; the last block of each launch resets them."""
    n_out = {"render_tile": 7, "trace_rays": 1}[entry]
    return _staged_launcher(entry, _split_args(scene_t, settings, args,
                                               n_out), profile)


def _staged_launcher(entry: str, prepared, profile: bool):
    """staged_split_launcher on _split_args' result."""
    from surfjax_torch.kernels import _build
    tab, ks, rays, keep, counts, out = prepared
    if counts[2] > 0:
        raise ValueError("the staged split kernels take scenes without a "
                         "crowd")
    dev = out.device
    rows = -(-rays.n // KS_THREADS)
    prof = torch.zeros((rows * (KS_THREADS // 32), len(KP_PHASE_NAMES), 3),
                       dtype=torch.int64, device=dev) if profile else None
    lib = _build.load()
    if entry == "render_tile":
        def call(stream):
            return lib.sp_staged_render_tile(tab, ks, rays,
                                             _ptr(prof), dev.index, stream)
    else:
        layout = _scene_layout(keep[1], records=False)
        work = torch.zeros(2, dtype=torch.int32, device=dev)

        def call(stream):
            return lib.sp_staged_trace_rays(tab, ks, layout, rays, _ptr(prof),
                                            work.data_ptr(), dev.index,
                                            stream)

    def zeroed_call(stream):
        if prof is not None:
            prof.zero_()
        return call(stream)

    launch = _split_enqueue(dev, zeroed_call, f"sp_staged_{entry}", keep)
    return launch, tuple(out[k] for k in range(out.shape[0])), prof


def _ptr(ten):
    return None if ten is None else ten.data_ptr()


def _split_call(wrapper, entry: str, reference, scene_t,
                settings: RenderSettings, args, n_out: int):
    """Check the scene and the ray arrays (`args`: the plain version's ray
    arguments), then launch the CUDA kernel `entry` (CUDA tensors, counted
    in `wrapper.launches`) or run `reference` (CPU)."""
    check_scene(scene_t.static, settings, meshes=True)
    dev = _ray_arrays(args)[0].device
    record_call(wrapper.__name__, (scene_t, settings) + tuple(args))
    if dev.type == "cpu":
        out = reference(scene_t, settings, *args)
        return out if isinstance(out, tuple) else (out,)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    launch, out = split_launcher(entry, scene_t, settings, args, n_out)
    launch()
    wrapper.launches += 1
    return out


def render_tile(scene_t, settings: RenderSettings, o, d, t0=None):
    """K1 over rays of any shape -> the 7 tensors of render_tile_reference.
    CUDA tensors launch the kernel (csrc/split_path.cu), counted in
    `render_tile.launches`; CPU tensors run the plain version."""
    rays = (tuple(o), tuple(d)) + (() if t0 is None else (t0,))
    return _split_call(render_tile, "sp_render_tile", render_tile_reference,
                       scene_t, settings, rays, 7)


def trace_rays(scene_t, settings: RenderSettings, o, l, dist, soft_k):
    """K2 -> vis (see trace_rays_reference); kernel or plain version as
    render_tile; launches counted in `trace_rays.launches`."""
    return _split_call(trace_rays, "sp_trace_rays", trace_rays_reference,
                       scene_t, settings,
                       (tuple(o), tuple(l), dist, soft_k), 1)[0]


def ao_fix(scene_t, settings: RenderSettings, p_off, n, need, ao_in):
    """ao_fix -> ao (see ao_fix_reference); kernel or plain version as
    render_tile; launches counted in `ao_fix.launches`."""
    return _split_call(ao_fix, "sp_ao_fix", ao_fix_reference, scene_t,
                       settings, (tuple(p_off), tuple(n), need, ao_in), 1)[0]


class PrimeArgs(ctypes.Structure):
    """Ray arrays and cone of a pt_prime_tile launch (csrc/prime_tile.cu)."""
    _fields_ = [("inp", ctypes.c_void_p * 6), ("out", ctypes.c_void_p),
                ("n", ctypes.c_int), ("has_proxy", ctypes.c_int),
                ("k_m", ctypes.c_float), ("inv1k", ctypes.c_float)]


def _prime_fns(scene_t, settings: RenderSettings):
    """-> (proxy_fn or None, sdf_fn) of the priming pass over the scene's
    SDF objects: the proxy scene and the true scene SDF, both with the
    primary march's leaf evaluator."""
    static, params = scene_t
    lp, nparams = params["leaf_params"], params["node_params"]
    sdf_objs = _split(static)[1]
    leaf_fn = _fast_leaf_fn(settings)
    return (_proxy_sdf_fn(sdf_objs, lp, nparams, leaf_fn),
            _scene_sdf(sdf_objs, lp, nparams, leaf_fn))


def prime_tile_reference(scene_t, settings: RenderSettings, k_m: float,
                         o, d):
    """Plain version of the priming kernel -> t0, the cone march of
    _prime_march along the coarse rays (o, d) with cone slope k_m."""
    proxy_fn, sdf_fn = _prime_fns(scene_t, settings)
    return _prime_march(proxy_fn, sdf_fn, o, d, settings.t_min,
                        settings.t_max, k_m, settings.max_steps)


def prime_launcher(scene_t, settings: RenderSettings, k_m: float, o, d):
    """Prepare one launch of the priming kernel on CUDA tensors ->
    (launch, (t0,)), as split_launcher."""
    from surfjax_torch.kernels import _build
    static, _ = scene_t
    ins = [a.contiguous() for a in _ray_arrays((tuple(o), tuple(d)))]
    dev = ins[0].device
    tables, counts = _scene_tables(scene_t, settings, dev)
    out = torch.empty_like(ins[0])
    tab = KFTables(*[t.data_ptr() for t in tables], None, None, None)
    ks = kernel_settings(static, settings, None, 0, counts)
    args = PrimeArgs()
    for k, a in enumerate(ins):
        args.inp[k] = a.data_ptr()
    args.out = out.data_ptr()
    args.n = out.numel()
    args.has_proxy = int(any(_proxy_bounded(oir)
                             for _, oir in _split(static)[1]))
    args.k_m = f32(k_m)
    args.inv1k = _inv_one_plus(k_m)
    fn = _build.load().pt_prime_tile

    def launch():
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            _raise_on(fn(tab, ks, args, dev.index, ctypes.c_void_p(stream)),
                      "pt_prime_tile")
        return ins, tables

    return launch, (out,)


def prime_tile(scene_t, settings: RenderSettings, k_m: float, o, d):
    """The priming kernel over coarse rays of any shape -> t0 (see
    prime_tile_reference). CUDA tensors launch the kernel
    (csrc/prime_tile.cu), counted in `prime_tile.launches`; CPU tensors
    run the plain version."""
    check_scene(scene_t.static, settings,
                meshes=bool(_split(scene_t.static)[2]))
    if split_crowd(scene_t.static, settings)[0] is not None:
        raise ValueError("the priming pass does not take a crowd: "
                         "prime_frame skips it when one is active")
    o, d = tuple(o), tuple(d)
    dev = _ray_arrays((o, d))[0].device
    record_call("prime_tile", (scene_t, settings, k_m, o, d))
    if dev.type == "cpu":
        return prime_tile_reference(scene_t, settings, k_m, o, d)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    launch, (out,) = prime_launcher(scene_t, settings, k_m, o, d)
    launch()
    prime_tile.launches += 1
    return out


render_tile.launches = trace_rays.launches = ao_fix.launches = 0
prime_tile.launches = 0


def _pad_rays(arrs, rows: int):
    """Flat (N,) ray components -> (rows_total, 128) padded by repeating
    the last ray, and N."""
    n = arrs[0].shape[0]
    block = rows * LANES
    n_pad = ((n + block - 1) // block) * block
    out = []
    for a in arrs:
        a = torch.cat([a, a[-1:].expand(n_pad - n)])
        out.append(a.reshape(n_pad // LANES, LANES))
    return tuple(out), n


def render_rays_pallas(static, settings: RenderSettings, params, o, d
                       ) -> FrameBuffers:
    """Split-path render of a flat ray batch (padded to whole tiles)."""
    (ox, oy, oz, dx, dy, dz), n_rays = _pad_rays(
        (o[0], o[1], o[2], d[0], d[1], d[2]), settings.tile_rows)
    fb = _render_padded(static, settings, params, (ox, oy, oz), (dx, dy, dz))
    return FrameBuffers(*(a.reshape((-1,) + a.shape[2:])[:n_rays]
                          for a in fb))


def _face_forward(nv, d):
    flip = (nv[0] * d[0] + nv[1] * d[1]) + nv[2] * d[2] > 0.0
    s = torch.where(flip, -1.0, 1.0)
    return (nv[0] * s, nv[1] * s, nv[2] * s)


def _pallas_primary(static, settings: RenderSettings, params, o2, d2,
                    t0=None):
    """Primary stage on (rows_total, 128)-tiled rays: K1 -> merge of each
    mesh's packet-kernel hits -> AO fix at the receivers a mesh won.
    -> (t, obj, n, n_geom, ao, hit_f); t is the raw t (callers mask by
    hit_f)."""
    from surfjax_torch.engines.mesh import (
        _mesh_arrays, intersect_mesh, mesh_normal,
    )
    from surfjax_torch.kernels.mesh_tile import (
        MAX_PACKET_TRIS, mesh_tile_kernel,
    )
    scene_t = SceneTensors(static, params)
    _, _, mesh = _split(static)
    t, obj, nx, ny, nz, ao, hit_f = render_tile(scene_t, settings, o2, d2,
                                                t0=t0)
    n = (nx, ny, nz)
    n_geom = n
    mesh_won = torch.zeros_like(t)
    for i, oir in mesh:
        ms = static.mesh_static[oir.mesh]
        arrays = _mesh_arrays(params, oir.mesh)
        if ms.n_tris > MAX_PACKET_TRIS:
            import warnings
            warnings.warn(
                f"mesh with {ms.n_tris} tris exceeds the packet kernel "
                f"budget ({MAX_PACKET_TRIS}); using grid-DDA",
                RuntimeWarning)
            shp = o2[0].shape
            o_f = tuple(c.reshape(-1) for c in o2)
            d_f = tuple(c.reshape(-1) for c in d2)
            t_f, tri_f = intersect_mesh(ms, oir.mesh, params, o_f, d_f,
                                        settings.t_min, settings.t_max)
            t_hit = torch.where(t_f < f32(BIG * 0.5), t_f, 0.0)
            p_f = tuple(o_f[k] + t_hit * d_f[k] for k in range(3))
            n_f = mesh_normal(ms, oir.mesh, params, p_f, tri_f)
            gn = arrays["tri_n"][tri_f.long()]
            t_m = t_f.reshape(shp)
            n_s = tuple(c.reshape(shp) for c in n_f)
            n_g = tuple(gn[:, k].reshape(shp) for k in range(3))
        else:
            t_m, n_s, n_g = mesh_tile_kernel(ms, settings,
                                             arrays["tri_packed"], o2, d2,
                                             settings.t_max)
        better = t_m < torch.where(hit_f > 0.5, t, BIG)
        t = torch.where(better, t_m, t)
        obj = torch.where(better, float(i), obj)
        hit_f = torch.where(better, 1.0, hit_f)
        # face-forward both the shading and the geometric mesh normals
        n_s = _face_forward(n_s, d2)
        n_g = _face_forward(n_g, d2)
        n = tuple(torch.where(better, a, b) for a, b in zip(n_s, n))
        n_geom = tuple(torch.where(better, a, b) for a, b in zip(n_g, n_geom))
        mesh_won = torch.where(better, 1.0, mesh_won)

    # AO at mesh-won lanes: K1 probed its own pre-merge hit, so AO is
    # taken again at the merged receiver, offset along the geometric
    # normal, against the non-mesh objects
    if mesh and settings.ao and len(static.ir.objects) > len(mesh):
        t_sane = torch.where(hit_f > 0.5, t, 0.0)
        p_off = _offset(o2, d2, t_sane, n_geom, settings)
        ao = ao_fix(scene_t, settings, p_off, n, mesh_won, ao)
    return t, obj, n, n_geom, ao, hit_f


def _offset(o2, d2, t_sane, n_geom, settings: RenderSettings):
    """Receivers p = o + t*d offset by shadow_eps along the geometric
    normal (shadow-terminator safety for smooth meshes; n_geom == n for
    non-mesh hits)."""
    eps = f32(settings.shadow_eps)
    return tuple((o2[k] + t_sane * d2[k]) + n_geom[k] * eps for k in range(3))


def _pallas_vis(static, settings: RenderSettings, params, p_off, l,
                dist_eff, soft_k):
    """One light's visibility on (rows, 128)-tiled receivers: K2 through
    the non-mesh objects, then every mesh's any-hit occlusion."""
    from surfjax_torch.engines.mesh import _mesh_arrays, intersect_mesh
    from surfjax_torch.kernels.mesh_tile import (
        MAX_PACKET_TRIS, mesh_tile_kernel,
    )
    vis = trace_rays(SceneTensors(static, params), settings, p_off, l,
                     dist_eff, soft_k)
    for _, oir in _split(static)[2]:
        ms = static.mesh_static[oir.mesh]
        if ms.n_tris > MAX_PACKET_TRIS:
            t_f, _ = intersect_mesh(ms, oir.mesh, params,
                                    tuple(c.reshape(-1) for c in p_off),
                                    tuple(c.reshape(-1) for c in l),
                                    settings.shadow_eps, dist_eff.reshape(-1))
            t_m = t_f.reshape(p_off[0].shape)
        else:
            t_m, _, _ = mesh_tile_kernel(
                ms, settings, _mesh_arrays(params, oir.mesh)["tri_packed"],
                p_off, l, dist_eff, any_hit=True)
        vis = vis * torch.where(t_m < dist_eff, 0.0, 1.0)
    return vis


def _light_terms(static, settings: RenderSettings, params, p_off, hit_f,
                 vis_fn):
    """Per light (direction, colour, visibility) at the receivers p_off;
    vis_fn(l, dist_eff, soft_k) -> one light's visibility (`_pallas_vis`
    in the split pipeline; the differentiable hybrid passes one that cuts
    the gradient)."""
    light_terms = []
    for li, kind in enumerate(static.ir.lights):
        lrow = params["lights"][li]
        if kind == LIGHT_POINT:
            lv = tuple(lrow[k] - p_off[k] for k in range(3))
            dist = sqrt((lv[0] * lv[0] + lv[1] * lv[1]) + lv[2] * lv[2])
            inv = 1.0 / dist
            l = tuple(c * inv for c in lv)
        else:
            l = tuple(torch.ones_like(hit_f) * -lrow[k] for k in range(3))
            dist = torch.full_like(hit_f, f32(settings.t_max))
        lcol = (lrow[3], lrow[4], lrow[5])
        if settings.shadows:
            # area lights: penumbra sharpness k = dist / radius
            radius = lrow[6]
            if bool(radius > 0.0):
                soft_k = dist / radius
            else:
                soft_k = torch.full_like(dist, f32(settings.soft_shadow_k))
            # miss lanes need no shadow ray: an empty segment
            dist_eff = torch.where(hit_f > 0.5, dist, 0.0)
            vis = vis_fn(l, dist_eff, soft_k)
        else:
            vis = torch.ones_like(hit_f)
        light_terms.append((l, lcol, vis))
    return light_terms


def _shade_padded(static, settings: RenderSettings, params, d2, t_sane, obj,
                  hit_f, n, ao, light_terms) -> FrameBuffers:
    """The shade tail of the split pipeline -> FrameBuffers in the rays'
    layout."""
    v = (-d2[0], -d2[1], -d2[2])
    amb = params["ambient"]
    ambient = (amb[0], amb[1], amb[2])
    bg = settings.background
    hit = hit_f > 0.5
    rgb = _shade_hits(static, settings, params, obj, hit, ambient, ao, n, v,
                      light_terms,
                      tuple(torch.full_like(hit_f, f32(bg[k]))
                            for k in range(3)))
    return FrameBuffers(
        rgb=torch.stack(rgb, dim=-1),
        depth=t_sane,
        normal=torch.stack([c * hit_f for c in n], dim=-1),
        hit=hit_f,
        obj_id=torch.where(hit, obj.to(torch.int32), -1).to(torch.int32),
    )


def _render_padded(static, settings: RenderSettings, params, o2, d2,
                   t0=None) -> FrameBuffers:
    """The split pipeline on (rows_total, 128)-tiled rays -> FrameBuffers
    of the same layout: rgb/normal (rows, 128, 3), depth/hit (rows, 128),
    obj_id int32. t0: the primed march starts, same layout, or None."""
    t, obj, n, n_geom, ao, hit_f = _pallas_primary(static, settings, params,
                                                   o2, d2, t0=t0)
    t_sane = torch.where(hit_f > 0.5, t, 0.0)
    p_off = _offset(o2, d2, t_sane, n_geom, settings)
    light_terms = _light_terms(
        static, settings, params, p_off, hit_f,
        lambda l, dist_eff, soft_k: _pallas_vis(
            static, settings, params, p_off, l, dist_eff, soft_k))
    return _shade_padded(static, settings, params, d2, t_sane, obj, hit_f, n,
                         ao, light_terms)
