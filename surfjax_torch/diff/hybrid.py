"""Differentiable render with the kernels in the forward pass (counterpart
of `surfjax/diff/hybrid.py`).

The backward of a sphere-traced hit needs only the SDF's derivatives at the
hit points (engines/sdf.py, the IFT adjoint), not a differentiable march. So
every march of a frame runs in the kernels of the split path, which have no
gradient (K1 `render_tile` for the primary hits, K2 `trace_rays` per light,
`ao_fix` and the mesh kernel on a mesh scene; their plain versions for CPU
tensors), on detached inputs and under no_grad, and the gradient paths are
rebuilt around them:

  t          `_ReattachT`: the kernel's t in the forward, the IFT adjoint
             in the backward, evaluated per winning object with the same
             silhouette clamp as engines/sdf.py; a lane a mesh won takes
             its triangle's plane as the defining function, whose spatial
             gradient is the geometric normal.
  normals,   recomputed with autograd on at the hit points (4 SDF
  AO         evaluations per hit for the normal, 4 per AO sample; no march)
             and spliced by `_splice`: the value is the kernel's to the
             bit, the gradient the recomputation's.
  visibility K2 without a gradient, which is the eager pipeline's meaning
             too: hard visibility is piecewise constant and the penumbra
             march is cut there as well (pipeline/frame.light_visibility).

The value equals `render_rays_pallas` to the bit: the same stages, the same
light loop and shade tail (kernels/render_tile.py), and every splice adds an
exact zero. The gradient agrees with the eager pipeline's up to floating
point and the marches' different stopping points: the IFT gradient does not
depend on which defining function is used, so analytic objects may use
their SDF form here and their closed-form root there.

A crowd (settings.vector_objects with eligible members) is refused: fit
scenes are small; use backend="jnp" or vector_objects=False. A lane a mesh
won carries pose gradients through the plane but none to parameters (mesh
vertices are not fit), and its normal carries no gradient.
"""

from __future__ import annotations

import torch

from surfjax_torch.core.math import vdot
from surfjax_torch.core.scene_compile import ENGINE_MESH, SceneWithMeshes
from surfjax_torch.core.types import FrameBuffers, RenderSettings
from surfjax_torch.engines.sdf import (
    ao_probes, eval_sdf, ift_adjoint, normal_fd,
)
from surfjax_torch.kernels.render_tile import (
    _light_terms, _offset, _pad_rays, _pallas_primary, _pallas_vis,
    _shade_padded, split_crowd,
)


def _splice(diff, value):
    """-> `value` to the bit (it adds the exact zero diff - diff.detach(),
    so `diff` must be finite wherever it is used) with the gradient of
    `diff`."""
    return value.detach() + (diff - diff.detach())


def _detached(tensors):
    return tuple(c.detach() for c in tensors)


class _ReattachT(torch.autograd.Function):
    """Identity on the kernel's hit distance t, with the IFT adjoint as
    its backward: the hybrid's differentiable t."""

    @staticmethod
    def forward(ctx, static, lp, nparams, ox, oy, oz, dx, dy, dz, t, obj_f,
                hit_f, ngx, ngy, ngz):
        ctx.static = static
        ctx.save_for_backward(lp, nparams, ox, oy, oz, dx, dy, dz, t, obj_f,
                              hit_f, ngx, ngy, ngz)
        return t.clone()

    @staticmethod
    def backward(ctx, g_t):
        (lp, nparams, ox, oy, oz, dx, dy, dz, t, obj_f, hit_f,
         ngx, ngy, ngz) = ctx.saved_tensors
        objects = ctx.static.ir.objects
        nonmesh = [(i, oir) for i, oir in enumerate(objects)
                   if oir.engine != ENGINE_MESH]
        mesh_ids = [i for i, oir in enumerate(objects)
                    if oir.engine == ENGINE_MESH]

        # the winning object's defining function on each lane; analytic
        # objects through their SDF form (module docstring)
        def f(lp_, np_, p):
            out = torch.zeros_like(t)
            for i, oir in nonmesh:
                out = torch.where(obj_f == float(i),
                                  eval_sdf(oir, lp_, np_, p), out)
            return out

        plane = None
        if mesh_ids:
            is_mesh = torch.zeros_like(t, dtype=torch.bool)
            for i in mesh_ids:
                is_mesh = is_mesh | (obj_f == float(i))
            plane = (is_mesh, (ngx, ngy, ngz))
        g_lp, g_np, g_o, g_d = ift_adjoint(
            f, lp, nparams, (ox, oy, oz), (dx, dy, dz), t, hit_f > 0.5, g_t,
            plane_normal=plane)
        return (None, g_lp, g_np) + tuple(g_o) + tuple(g_d) + (None,) * 6


def _reattach_t(static: SceneWithMeshes, lp, nparams, o, d, t, obj_f, hit_f,
                n_geom):
    return _ReattachT.apply(static, lp, nparams, *o, *d, t, obj_f, hit_f,
                            *n_geom)


def _normals_diff(static, settings: RenderSettings, lp, nparams, p, obj_f, d,
                  n_kernel):
    """The normal with a gradient, at the hit points: the FD tetrahedron of
    the winning non-mesh object, face-forwarded like the pipeline's; mesh
    and miss lanes keep the kernel's normal, detached."""
    nx, ny, nz = _detached(n_kernel)
    for i, oir in enumerate(static.ir.objects):
        if oir.engine == ENGINE_MESH:
            continue
        sel = obj_f == float(i)
        n_i = normal_fd(oir, lp, nparams, p, settings.normal_eps, live=sel)
        s = torch.where(vdot(n_i, d) > 0.0, -1.0, 1.0)
        nx = torch.where(sel, n_i[0] * s, nx)
        ny = torch.where(sel, n_i[1] * s, ny)
        nz = torch.where(sel, n_i[2] * s, nz)
    return (nx, ny, nz)


def _scene_sdf_diff(static, lp, nparams):
    """min over the non-mesh objects: the AO receivers' SDF with a gradient
    (the composition of pipeline/frame._nonmesh_scene_sdf), or None."""
    objs = [oir for oir in static.ir.objects if oir.engine != ENGINE_MESH]
    if not objs:
        return None

    def f(p):
        v = eval_sdf(objs[0], lp, nparams, p)
        for oir in objs[1:]:
            v = torch.minimum(v, eval_sdf(oir, lp, nparams, p))
        return v
    return f


def render_rays_hybrid(static: SceneWithMeshes, settings: RenderSettings,
                       params, o, d) -> FrameBuffers:
    """Kernel-forward, IFT-backward render of a flat ray batch.

    Value: equal to render_rays_pallas to the bit. Gradients (to
    params["leaf_params"], params["node_params"], o, d, and through the
    shade tail to lights, materials and ambient): t through `_reattach_t`,
    normals and AO through their recomputation at the hit points,
    visibility none (module docstring)."""
    if split_crowd(static, settings)[0] is not None:
        raise NotImplementedError(
            "render_rays_hybrid: crowd scenes (vector_objects) have no "
            "differentiable hybrid path; fit with backend='jnp' or "
            "vector_objects=False.")
    (ox, oy, oz, dx, dy, dz), n_rays = _pad_rays(
        (o[0], o[1], o[2], d[0], d[1], d[2]), settings.tile_rows)
    o2, d2 = (ox, oy, oz), (dx, dy, dz)
    lp, nparams = params["leaf_params"], params["node_params"]
    # every march runs in the kernels, on detached inputs and without a
    # graph (a plain version would otherwise record hundreds of steps)
    params_ng = {k: v.detach() for k, v in params.items()}
    with torch.no_grad():
        t_k, obj, n_k, n_geom, ao_k, hit_f = _pallas_primary(
            static, settings, params_ng, _detached(o2), _detached(d2))

    t = _reattach_t(static, lp, nparams, o2, d2, t_k, obj, hit_f, n_geom)
    hit = hit_f > 0.5
    t_sane = torch.where(hit, t, 0.0)
    p = tuple(o2[k] + t_sane * d2[k] for k in range(3))

    n_d = _normals_diff(static, settings, lp, nparams, p, obj, d2, n_k)
    n = tuple(_splice(n_d[k], n_k[k]) for k in range(3))
    n_off = tuple(_splice(n_d[k], n_geom[k]) for k in range(3))
    p_off = _offset(o2, d2, t_sane, n_off, settings)

    ao = ao_k
    if settings.ao:
        sdf = _scene_sdf_diff(static, lp, nparams)
        if sdf is not None:
            ao = _splice(ao_probes(sdf, p_off, n, settings.ao_samples,
                                   settings.ao_radius, settings.ao_strength),
                         ao_k)

    def vis_fn(l, dist_eff, soft_k):
        with torch.no_grad():
            return _pallas_vis(static, settings, params_ng,
                               _detached(p_off), _detached(l),
                               dist_eff.detach(), soft_k.detach())

    light_terms = _light_terms(static, settings, params, p_off, hit_f,
                               vis_fn)
    fb = _shade_padded(static, settings, params, d2, t_sane, obj, hit_f, n,
                       ao, light_terms)
    return FrameBuffers(*(a.reshape((-1,) + a.shape[2:])[:n_rays]
                          for a in fb))
