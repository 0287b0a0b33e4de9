"""Frame pipeline: the eager tensor path and the dispatch to the kernels.

Counterpart of `surfjax/pipeline/frame.py`. With backend="jnp" a frame is
traced, shaded and written by the eager functions below (primary hits ->
normals -> shadow rays -> AO probes -> shading; meshes through the grid
DDA of engines/mesh.py). With backend="pallas" a mesh-free scene goes to
the fused path and a mesh scene to the split path (kernels/render_tile.py;
a sequence's frames in passes, each kernel launched once per pass), with
the crowd loops (settings.vector_objects)
and the cone-priming pass (settings.prime) where the settings ask for
them; a frame with march caps (settings.march_cap, shadow_march_cap)
takes the split path and its capped-march residual, whose frame equals
the uncapped one bitwise. The eager path ignores the caps, as surfjax's
does.

`render_rays` with backend="jnp" is differentiable in the scene parameters
and the rays (the march through engines/sdf.sphere_trace's IFT adjoint,
normals, AO and shading by autograd); the fit (diff/fit.py) calls it
directly, since `render_frame` and `render_sequence` run under no_grad.

The entry points run on the CUDA device unless the caller passes
device="cpu"; without a card a CUDA request raises.
"""

from __future__ import annotations

import numpy as np
import torch

from surfjax_torch.core.camera import Intrinsics, camera_ray_dirs_dyn
from surfjax_torch.core.math import BIG, f32, sqrt, vdot
from surfjax_torch.core.scene_compile import (
    ENGINE_ANALYTIC, ENGINE_MESH, ENGINE_SDF, LIGHT_POINT, SceneWithMeshes,
    params_to_device,
)
from surfjax_torch.core.types import FrameBuffers, Hit, RenderSettings
from surfjax_torch.engines.analytic import (
    intersect_analytic, object_normal_analytic,
)
from surfjax_torch.engines.mesh import (
    _mesh_arrays, clamp_ids, intersect_mesh, mesh_normal,
)
from surfjax_torch.engines.sdf import (
    ao_probes, eval_sdf, normal_fd, soft_shadow_march, sphere_trace,
)
from surfjax_torch.shade import shade_object
from surfjax_torch.utils.profiling import annotate


def trace_scene(static: SceneWithMeshes, settings: RenderSettings, params,
                o, d, t_min, t_max) -> Hit:
    """Nearest hit over all scene objects for a flat ray batch."""
    t_best = torch.full_like(o[0], BIG)
    obj_best = torch.full_like(o[0], -1, dtype=torch.int32)
    leaf_best = torch.zeros_like(o[0], dtype=torch.int32)
    for i, oir in enumerate(static.ir.objects):
        if oir.engine == ENGINE_ANALYTIC:
            t_i, leaf_i = intersect_analytic(
                oir, params["leaf_params"], o, d, t_min, t_max)
        elif oir.engine == ENGINE_SDF:
            t_i, _hit = sphere_trace(
                oir, params["leaf_params"], params["node_params"], o, d,
                t_min, t_max, settings.max_steps, settings.hit_eps,
                settings.hit_eps_scale)
            leaf_i = torch.zeros_like(t_i, dtype=torch.int32)
        elif oir.engine == ENGINE_MESH:
            t_i, leaf_i = intersect_mesh(static.mesh_static[oir.mesh],
                                         oir.mesh, params, o, d, t_min, t_max)
        else:
            raise ValueError(f"unknown engine {oir.engine}")
        better = t_i < t_best
        t_best = torch.where(better, t_i, t_best)
        obj_best = torch.where(better, i, obj_best).to(torch.int32)
        leaf_best = torch.where(better, leaf_i, leaf_best)
    mask = t_best < f32(BIG * 0.5)
    return Hit(t_best, obj_best, leaf_best, mask)


def _nonmesh_scene_sdf(static: SceneWithMeshes, params):
    """Scene-level SDF = min over all non-mesh objects (soft shadows /
    AO)."""
    sdf_objs = [oir for oir in static.ir.objects
                if oir.engine in (ENGINE_ANALYTIC, ENGINE_SDF)]
    if not sdf_objs:
        return None

    def f(p):
        v = eval_sdf(sdf_objs[0], params["leaf_params"],
                     params["node_params"], p)
        for oir in sdf_objs[1:]:
            v = torch.minimum(v, eval_sdf(oir, params["leaf_params"],
                                          params["node_params"], p))
        return v
    return f


def compute_normals(static: SceneWithMeshes, settings: RenderSettings,
                    params, p, hit: Hit, d):
    """Per-hit normals: analytic where possible, FD tetrahedron for SDF
    objects, barycentric for meshes, face-forwarded against the ray."""
    nx = torch.zeros_like(p[0])
    ny = torch.zeros_like(p[0])
    nz = torch.ones_like(p[0])
    for i, oir in enumerate(static.ir.objects):
        sel = hit.obj_id == i
        if oir.engine == ENGINE_ANALYTIC and settings.normals == "auto":
            n_i = object_normal_analytic(oir, params["leaf_params"], p,
                                         hit.leaf_id)
        elif oir.engine in (ENGINE_ANALYTIC, ENGINE_SDF):
            n_i = normal_fd(oir, params["leaf_params"],
                            params["node_params"], p, settings.normal_eps,
                            live=sel)
        else:
            n_i = mesh_normal(static.mesh_static[oir.mesh], oir.mesh, params,
                              p, hit.leaf_id)
        nx = torch.where(sel, n_i[0], nx)
        ny = torch.where(sel, n_i[1], ny)
        nz = torch.where(sel, n_i[2], nz)
    flip = vdot((nx, ny, nz), d) > 0.0
    s = torch.where(flip, -1.0, 1.0)
    return (nx * s, ny * s, nz * s)


def light_visibility(static: SceneWithMeshes, settings: RenderSettings,
                     params, p_off, scene_sdf):
    """Per-light (direction, color, visibility) terms. Hard shadows trace
    every object; soft shadows march the non-mesh scene SDF's penumbra,
    and meshes still occlude hard.

    Visibility carries no gradient, as in surfjax: the penumbra march is
    cut at its inputs and at the scene parameters (the usual visibility
    bias of inverse rendering), and hard visibility is piecewise constant."""
    ir = static.ir
    if settings.soft_shadows:
        nograd_params = {k: v.detach() for k, v in params.items()}
        scene_sdf_nograd = _nonmesh_scene_sdf(static, nograd_params)
    terms = []
    for li, kind in enumerate(ir.lights):
        lrow = params["lights"][li]
        if kind == LIGHT_POINT:
            lvx = lrow[0] - p_off[0]
            lvy = lrow[1] - p_off[1]
            lvz = lrow[2] - p_off[2]
            dist = sqrt((lvx * lvx + lvy * lvy) + lvz * lvz)
            inv = 1.0 / dist
            l = (lvx * inv, lvy * inv, lvz * inv)
        else:  # directional: lrow[0:3] is the direction light travels
            ones = torch.ones_like(p_off[0])
            l = (-lrow[0] * ones, -lrow[1] * ones, -lrow[2] * ones)
            dist = torch.full_like(p_off[0], f32(settings.t_max))
        lcol = (lrow[3], lrow[4], lrow[5])

        vis = torch.ones_like(p_off[0])
        if settings.shadows and ir.objects:
            if settings.soft_shadows and scene_sdf is not None:
                # area lights: penumbra sharpness k = dist / radius
                radius = lrow[6]
                soft_k = torch.where(radius > 0.0, dist / radius,
                               torch.full_like(dist,
                                               f32(settings.soft_shadow_k)))
                vis = vis * soft_shadow_march(
                    scene_sdf_nograd, tuple(c.detach() for c in p_off),
                    tuple(c.detach() for c in l), settings.soft_shadow_tmin,
                    dist.detach(), soft_k.detach(), settings.shadow_steps)
                for oir in ir.objects:
                    if oir.engine == ENGINE_MESH:
                        t_i, _ = intersect_mesh(
                            static.mesh_static[oir.mesh], oir.mesh, params,
                            p_off, l, settings.shadow_eps, dist)
                        vis = vis * torch.where(t_i < dist, 0.0, 1.0)
            else:
                with torch.no_grad():
                    sh = trace_scene(static, settings, params, p_off, l,
                                     settings.shadow_eps, dist)
                    vis = vis * torch.where(sh.mask & (sh.t < dist), 0.0, 1.0)
        terms.append((l, lcol, vis))
    return terms


def render_rays(static: SceneWithMeshes, settings: RenderSettings, params,
                o, d) -> FrameBuffers:
    """Trace and shade a flat ray batch -> flat FrameBuffers."""
    ir = static.ir
    hit = trace_scene(static, settings, params, o, d,
                      settings.t_min, settings.t_max)
    t = torch.where(hit.mask, hit.t, 0.0)
    p = (o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2])
    n = compute_normals(static, settings, params, p, hit, d)
    # secondary-ray origins offset along the GEOMETRIC normal for meshes:
    # a smooth (barycentric) normal can push the origin under the adjacent
    # facet's plane and give shadow-terminator acne
    n_off = n
    for i, oir in enumerate(ir.objects):
        if oir.engine == ENGINE_MESH:
            tri_n = _mesh_arrays(params, oir.mesh)["tri_n"][clamp_ids(
                hit.leaf_id, static.mesh_static[oir.mesh].n_tris)]
            gx, gy, gz = tri_n[:, 0], tri_n[:, 1], tri_n[:, 2]
            flip = (gx * d[0] + gy * d[1]) + gz * d[2] > 0.0
            s = torch.where(flip, -1.0, 1.0)
            sel = hit.obj_id == i
            n_off = (torch.where(sel, gx * s, n_off[0]),
                     torch.where(sel, gy * s, n_off[1]),
                     torch.where(sel, gz * s, n_off[2]))
    eps = f32(settings.shadow_eps)
    p_off = (p[0] + n_off[0] * eps, p[1] + n_off[1] * eps,
             p[2] + n_off[2] * eps)

    scene_sdf = _nonmesh_scene_sdf(static, params)
    light_terms = light_visibility(static, settings, params, p_off,
                                   scene_sdf)
    if settings.ao and scene_sdf is not None:
        ao = ao_probes(scene_sdf, p_off, n, settings.ao_samples,
                       settings.ao_radius, settings.ao_strength)
    else:
        ao = torch.ones_like(p[0])

    v = (-d[0], -d[1], -d[2])
    amb = params["ambient"]
    ambient = (amb[0], amb[1], amb[2])
    bg = settings.background
    r = torch.full_like(p[0], f32(bg[0]))
    g = torch.full_like(p[0], f32(bg[1]))
    b = torch.full_like(p[0], f32(bg[2]))
    for i, oir in enumerate(ir.objects):
        mat_row = params["materials"][oir.mat]
        ri, gi, bi = shade_object(mat_row, oir.shininess, ambient, ao, n, v,
                                  light_terms)
        sel = hit.mask & (hit.obj_id == i)
        r = torch.where(sel, ri, r)
        g = torch.where(sel, gi, g)
        b = torch.where(sel, bi, b)

    hitf = hit.mask.to(torch.float32)
    return FrameBuffers(
        rgb=torch.stack([r, g, b], dim=-1),
        depth=t,
        normal=torch.stack([n[0] * hitf, n[1] * hitf, n[2] * hitf], dim=-1),
        hit=hitf,
        obj_id=torch.where(hit.mask, hit.obj_id, -1).to(torch.int32),
    )


def _pixel_grid(intr: Intrinsics, device):
    rows = torch.arange(intr.height, dtype=torch.float32, device=device)
    cols = torch.arange(intr.width, dtype=torch.float32, device=device)
    rr, cc = torch.meshgrid(rows, cols, indexing="ij")
    return rr.reshape(-1), cc.reshape(-1)


def _check_backend(settings: RenderSettings) -> None:
    """The kernel paths raise on what they do not port (kernels/render_tile
    .check_scene); here only the backend name is checked."""
    if settings.backend not in ("jnp", "pallas"):
        raise ValueError(f"backend must be 'jnp' or 'pallas'; got "
                         f"{settings.backend!r}")


def frame_step(static, intr: Intrinsics, settings: RenderSettings, params,
               R_flat, cam_pos) -> FrameBuffers:
    """Trace+shade one full frame -> FrameBuffers shaped (H, W, ...)."""
    _check_backend(settings)
    H, W = intr.height, intr.width
    if settings.backend == "pallas":
        from surfjax_torch.kernels.render_tile import render_frame_pallas
        return render_frame_pallas(static, intr, settings, params, R_flat,
                                   cam_pos)
    rr, cc = _pixel_grid(intr, R_flat.device)
    d = camera_ray_dirs_dyn(intr, R_flat, rr, cc)
    o = tuple(cam_pos[k].expand(rr.shape) for k in range(3))
    fb = render_rays(static, settings, params, o, d)
    return FrameBuffers(
        rgb=fb.rgb.reshape(H, W, 3),
        depth=fb.depth.reshape(H, W),
        normal=fb.normal.reshape(H, W, 3),
        hit=fb.hit.reshape(H, W),
        obj_id=fb.obj_id.reshape(H, W),
    )


def _pose_tensors(camera, device):
    R = torch.as_tensor(np.asarray(camera.rotation, np.float32).reshape(9),
                        device=device)
    t = torch.as_tensor(np.asarray(camera.position, np.float32),
                        device=device)
    return R, t


def _as_f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available (torch.cuda.is_available() is false); "
                           "this package does not fall back to the CPU")
    return device


@torch.no_grad()
@annotate("surfjax_torch.render_frame")
def render_frame(scene, camera, settings: RenderSettings = RenderSettings(),
                 device="cuda") -> FrameBuffers:
    device = _check_device(device)
    static, params = scene.freeze()
    params = params_to_device(params, device)
    R_flat, cam_pos = _pose_tensors(camera, device)
    return frame_step(static, camera.intrinsics, settings, params,
                      R_flat, cam_pos)


@torch.no_grad()
@annotate("surfjax_torch.render_sequence")
def render_sequence(scene, camera, poses,
                    settings: RenderSettings = RenderSettings(),
                    device="cuda") -> FrameBuffers:
    """Batched camera path, all frames on `device`.

    poses: (R_flats (F, 9), positions (F, 3)). Returns FrameBuffers with a
    leading frame axis. With backend="pallas" the frames render as
    surfjax's _sequence_jit renders them, every kernel over all frames at
    once: an unprimed mesh-free scene in one fused launch; a mesh scene,
    a capped or a primed one in passes of whole frames
    (render_tile.PASS_RAYS rays at most; one pass for 16 frames of c4 at
    1920x1080), each pass launching each kernel once over all its frames
    (render_tile.render_sequence_pallas), where surfjax vmaps the whole
    sequence in one program. With backend="jnp" the eager pipeline renders
    frame after frame (surfjax vmaps it too; batched at 1080p, the eager
    pipeline's tensors would take tens of GB)."""
    device = _check_device(device)
    static, params = scene.freeze()
    _check_backend(settings)
    params = params_to_device(params, device)
    R_flats = _as_f32(poses[0], device).reshape(-1, 9)
    positions = _as_f32(poses[1], device).reshape(-1, 3)
    if settings.backend == "pallas":
        from surfjax_torch.kernels.render_tile import render_sequence_pallas
        return render_sequence_pallas(static, camera.intrinsics, settings,
                                      params, R_flats, positions)
    frames = [frame_step(static, camera.intrinsics, settings, params,
                         R_flats[f], positions[f])
              for f in range(R_flats.shape[0])]
    return FrameBuffers(*(torch.stack(parts) for parts in zip(*frames)))
