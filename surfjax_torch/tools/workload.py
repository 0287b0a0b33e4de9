"""The main paths' workloads, the mesh test scenes, and the timing
helpers that measure them.

The fused path's workload is the one `bench.py` pins: configs/c3_sdf.yaml
reframed to 1920x1080 at the config's vertical fov, 48 camera positions
each moved by 1e-4 * i on every axis, rendered in one `render_sequence`
call in the `value` (config settings) and `value_exact` (LoDs 0,
over_relax 1.0) modes. The split path's is configs/c4_mesh.yaml at its own
1920x1080 and tile_rows, 16 positions jittered the same way, in the
`config` mode (the yaml's settings: hard shadows, no AO) and the `ao` mode
(AO and soft shadows on). The split path's crowd kernels' is
surfjax_torch/configs/crowd_mesh.yaml (crowd_demo with c4's octasphere) at
1920x1080, 16 positions, modes `config` and `soft`
(crowd_mesh_main_path). The fit's is configs/c5_anim.yaml as it is
(256x256, its own `fit:` block), started from the perturbed pose and the
perturbed leaf parameters the command line's `fit` starts from.
`chip_smoke.py`, the CUDA tests, `surfjax_torch.tools.breakdown` and
`surfjax_torch.tools.fit_bench` share them.
"""

from __future__ import annotations

import os
import subprocess
from typing import Optional

import numpy as np
import torch

from surfjax_torch.api import Camera
from surfjax_torch.config import load_config
from surfjax_torch.core.camera import Intrinsics
from surfjax_torch.meshgen import octasphere

EXACT = dict(secondary_lod_iters=0, ao_lod_iters=0, over_relax=1.0)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
C3 = os.path.join(ROOT, "configs", "c3_sdf.yaml")
# the crowd with a mesh: the split path's crowd kernels' main path
CROWD_MESH = os.path.join(ROOT, "surfjax_torch", "configs", "crowd_mesh.yaml")


def gpu_line(fields: str = "name,power.limit") -> str:
    """`nvidia-smi --query-gpu=<fields> --format=csv,noheader` of card 0."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def reframe(camera, width: int, height: int):
    """The camera at width x height with the same vertical fov."""
    intr = camera.intrinsics
    fov = 2.0 * float(np.degrees(np.arctan(0.5 * intr.height / intr.fy)))
    return Camera(Intrinsics.from_fov(width, height, fov),
                  rotation=camera.rotation, position=camera.position)


def poses(camera, n_frames: int, jitter):
    """n_frames copies of the camera pose, position moved by jitter (F, 3)
    -> (R_flats (F, 9), positions (F, 3)), float32 numpy."""
    R = np.asarray(camera.rotation, np.float32).reshape(1, 9)
    pos = np.asarray(camera.position, np.float32)[None, :]
    return (np.repeat(R, n_frames, axis=0),
            (pos + jitter.astype(np.float32)).astype(np.float32))


def cam_rows_of(R_flats, positions, device):
    """(F, 9) and (F, 3) -> the (F, 12) float32 camera rows of frame_fused."""
    return torch.cat([torch.as_tensor(R_flats), torch.as_tensor(positions)],
                     dim=1).to(device=device, dtype=torch.float32).contiguous()


def jitter(n_frames: int):
    """(F, 3) float32: frame i moved by 1e-4 * i on every axis."""
    return np.float32(1e-4) * np.arange(
        n_frames, dtype=np.float32)[:, None] * np.ones((1, 3), np.float32)


def metric_workload(config: Optional[str] = None, width: int = 1920,
                    height: int = 1080, n_frames: int = 48):
    """THE pinned metric workload of `surfjax_torch.bench`: the config's
    (default configs/c3_sdf.yaml) scene with its camera reframed to
    width x height at the same vertical fov (kept as it is if it already
    has that size), and n_frames positions, frame i moved by 1e-4 * i on
    every axis -> (scene, camera, settings, R_flats (F, 9), positions
    (F, 3)), the poses float32 numpy. The settings are the config's; the
    caller picks the backend."""
    scene, camera, settings, _ = load_config(config or C3)
    intr = camera.intrinsics
    if (intr.width, intr.height) != (width, height):
        camera = reframe(camera, width, height)
    R_flats, positions = poses(camera, n_frames, jitter(n_frames))
    return scene, camera, settings, R_flats, positions


def main_path(config_path: str, n_frames: int = 48):
    """metric_workload at 1920x1080 -> (scene, camera, R_flats, positions,
    modes), modes a dict of the two fidelity modes' RenderSettings with
    backend pallas."""
    scene, camera, settings, Rs, ps = metric_workload(config_path,
                                                      n_frames=n_frames)
    modes = {"value": settings.with_(backend="pallas"),
             "value_exact": settings.with_(backend="pallas", **EXACT)}
    return scene, camera, Rs, ps, modes


def mesh_modes(settings):
    """The split path's two modes of a mesh config's settings."""
    return {"config": settings.with_(backend="pallas"),
            "ao": settings.with_(backend="pallas", ao=True,
                                 soft_shadows=True)}


def mesh_main_path(config_path: str, n_frames: int = 16):
    """-> (scene, camera, R_flats, positions, modes) of a mesh config at
    its own size and tile_rows, modes as mesh_modes."""
    scene, camera, settings, _ = load_config(config_path)
    Rs, ps = poses(camera, n_frames, jitter(n_frames))
    return scene, camera, Rs, ps, mesh_modes(settings)


def mesh_soft_ao_scene(api, size: int):
    """A 128-triangle mesh beside an SDF sphere over an analytic floor,
    AO and soft shadows on -> (scene, camera, settings); `api` is the
    package's api module (the same scene is built for surfjax)."""
    v, f = octasphere(2)
    v = v * 0.5 + np.asarray([0.6, -0.2, 2.8], np.float32)
    scene = api.Scene()
    scene.add(api.TriangleMesh(vertices=v, faces=f),
              api.Material.lambert(albedo=(0.8, 0.4, 0.3)))
    scene.add(api.Sphere(center=(-0.6, -0.1, 3.0), radius=0.5),
              api.Material.lambert(albedo=(0.3, 0.7, 0.4)), engine="sdf")
    scene.add(api.Plane(normal=(0.0, 1.0, 0.0), offset=-0.7),
              api.Material.lambert(albedo=(0.5, 0.5, 0.55)))
    scene.add_light(api.PointLight(position=(3.0, 4.0, -1.0)))
    cam = api.Camera.pinhole(size, size, 45.0, position=(0.0, 0.3, 0.0),
                             target=(0.0, 0.0, 3.0))
    st = api.RenderSettings(shadows=True, soft_shadows=True, ao=True,
                            ao_samples=5, max_steps=128, backend="pallas")
    return scene, cam, st


def two_mesh_scene(api, size: int):
    """Two meshes of 128 and 1 triangles, hard shadows -> (scene, camera,
    settings), built with the package's api module."""
    v1, f1 = octasphere(2)
    v1 = v1 * 0.6 + np.asarray([-0.8, 0.0, 3.0], np.float32)
    v2 = np.asarray([[0.5, -0.5, 2.5], [1.5, -0.5, 2.5], [1.0, 0.8, 3.0]],
                    np.float32)
    scene = api.Scene()
    scene.add(api.TriangleMesh(vertices=v1, faces=f1),
              api.Material.lambert(albedo=(0.8, 0.4, 0.3)))
    scene.add(api.TriangleMesh(vertices=v2,
                               faces=np.asarray([[0, 1, 2]], np.int32)),
              api.Material.lambert(albedo=(0.3, 0.4, 0.8)))
    scene.add_light(api.PointLight(position=(3.0, 4.0, -1.0)))
    return (scene, api.Camera.pinhole(size, size, 45.0),
            api.RenderSettings(shadows=True, backend="pallas"))


def _packed_mesh(api, v, f):
    """-> (the mesh's MeshStatic, its packed (F, 24) table)."""
    static, params = api.Scene().add(
        api.TriangleMesh(vertices=v, faces=f)).freeze()
    return static.mesh_static[0], params["mesh0_tri_packed"]


def mesh_probe_calls(api, device, rows: int = 16, tile_rows: int = 8):
    """Mesh kernel calls that the scenes' frames do not make -> [(label,
    mesh_tile's arguments)], each (rows, 128) rays from one origin:
      * `edges`: a 128-triangle octasphere, rays aimed exactly at its
        vertices (each shared by 4-6 triangles) and its edges' midpoints
        (each shared by 2), nearest hit; `edges any-hit`: the same rays
        as shadow rays that end past the sphere (two occluders each);
        `edges to target any-hit`: ending exactly at their target;
      * `layers any-hit`: three concentric octaspheres in one mesh, rays
        through all three, so that a ray has up to six occluders;
      * `overflow` and `overflow any-hit`: the edge rays with K = 8, so
        that every tile scans the whole table.
    Candidates come from mesh_candidates, the box from grid_box."""
    from surfjax_torch.kernels.mesh_tile import grid_box, mesh_candidates
    centre = np.asarray([0.1, -0.05, 3.0], np.float32)
    origin = np.asarray([0.02, 0.03, 0.0], np.float32)
    v, f = octasphere(2)
    sphere = (v * np.float32(0.6) + centre).astype(np.float32)
    mids = ((sphere[f] + sphere[np.roll(f, -1, axis=1)]) * np.float32(0.5))
    targets = np.concatenate([sphere, mids.reshape(-1, 3)]).astype(np.float32)
    layers_v = np.concatenate([(v * np.float32(r) + centre).astype(np.float32)
                               for r in (0.3, 0.6, 0.9)])
    layers_f = np.concatenate([f + k * len(v) for k in range(3)]
                              ).astype(np.int32)
    rng = np.random.default_rng(3)
    layer_targets = (centre + rng.uniform(-0.25, 0.25, (rows * 128, 3))
                     ).astype(np.float32)

    def rays(tg):
        tg = np.resize(tg, (rows * 128, 3))
        d = (tg - origin).astype(np.float32)
        dist = np.sqrt((d * d).sum(axis=1)).astype(np.float32)
        d = (d / dist[:, None]).astype(np.float32)
        o2 = tuple(torch.as_tensor(np.full((rows, 128), origin[k],
                                           np.float32), device=device)
                   for k in range(3))
        d2 = tuple(torch.as_tensor(np.ascontiguousarray(
            d[:, k].reshape(rows, 128)), device=device) for k in range(3))
        return o2, d2, torch.as_tensor(dist.reshape(rows, 128),
                                       device=device)

    calls = []
    for label, (mv, mf), tg in (("edges", (sphere, f), targets),
                                ("layers", (layers_v, layers_f),
                                 layer_targets)):
        ms, tri = _packed_mesh(api, mv, mf)
        tri = torch.as_tensor(tri, device=device)
        o2, d2, dist = rays(tg)
        far = torch.full_like(dist, 1e4)
        for hit_kind, t_max in (("", far), (" any-hit", dist * 3.0),
                                (" to target any-hit", dist)):
            if label == "layers" and hit_kind != " any-hit":
                continue
            any_hit = bool(hit_kind)
            cand, counts = mesh_candidates(ms, tri, o2, d2, 1e-3, t_max,
                                           tile_rows)
            args = (tri, cand, counts, o2, d2, t_max, 1e-3, ms.smooth,
                    any_hit, grid_box(ms))
            calls.append((label + hit_kind, args))
            if label == "edges" and hit_kind != " to target any-hit":
                calls.append(("overflow" + hit_kind,
                              (tri, cand[:, :8].contiguous()) + args[2:]))
    return calls


# --- crowd scenes (settings.vector_objects) ---------------------------------
# Built with the package's `api` module, so that the same scene can be
# built for surfjax; every random number comes from a seeded numpy
# generator. The settings leave vector_objects off: callers switch it.

_CROWD_MATS = (dict(albedo=(0.7, 0.4, 0.3)),
               dict(albedo=(0.3, 0.6, 0.8), shininess=16),
               dict(albedo=(0.8, 0.8, 0.3), shininess=32))


def _crowd_mats(api, n: int):
    return [api.Material.blinn_phong(**kw) if "shininess" in kw
            else api.Material.lambert(**kw) for kw in _CROWD_MATS[:n]]


def _crowd_view(api, scene, size=(128, 96), **settings):
    scene.add_light(api.PointLight(position=(3.0, 5.0, -1.0)))
    cam = api.Camera.pinhole(size[0], size[1], fov_y_deg=50.0,
                             position=(0.0, 0.6, -0.5),
                             target=(0.0, 0.0, 3.0))
    st = api.RenderSettings(backend="pallas", tile_rows=8, max_steps=96,
                            **settings)
    return scene, cam, st


def _spot(rng, y=(-0.6, 1.0), z=(2.2, 4.2)):
    return (float(rng.uniform(-1.6, 1.6)), float(rng.uniform(*y)),
            float(rng.uniform(*z)))


def crowd_scene(api, n_spheres=9, n_boxes=4, with_plane=True, engine="sdf",
                n_sdf_spheres=0, mesh=False, size=(128, 96), seed=7,
                **settings):
    """Small spheres and boxes (three materials, two of them shiny) over
    an optional floor -> (scene, camera, settings). engine None makes them
    analytic members; n_sdf_spheres more SDF spheres let both engines
    share the crowd; mesh adds a 128-triangle mesh, which sends the frame
    down the split path."""
    rng = np.random.default_rng(seed)
    scene = api.Scene()
    mats = _crowd_mats(api, 3 if engine else 2)
    for k in range(n_spheres):
        c = _spot(rng)
        scene.add(api.Sphere(center=c, radius=float(rng.uniform(0.15, 0.35))),
                  mats[k % len(mats)], engine=engine)
    for k in range(n_boxes):
        c = _spot(rng)
        h = tuple(float(x) for x in rng.uniform(0.1, 0.3, 3))
        scene.add(api.Box(center=c, half_extents=h),
                  mats[(k + 1) % len(mats)], engine=engine)
    for k in range(n_sdf_spheres):
        scene.add(api.Sphere(center=_spot(rng), radius=0.2),
                  mats[k % len(mats)], engine="sdf")
    if with_plane:
        scene.add(api.Plane(normal=(0.0, 1.0, 0.0), offset=-1.0),
                  api.Material.lambert(albedo=(0.5, 0.5, 0.5)))
    if mesh:
        v, f = octasphere(2)
        v = v * 0.5 + np.asarray([1.2, 0.0, 3.4], np.float32)
        scene.add(api.TriangleMesh(vertices=v, faces=f),
                  api.Material.blinn_phong(albedo=(0.7, 0.7, 0.75),
                                           shininess=32))
    return _crowd_view(api, scene, size, **settings)


def pair_scene(api, n_pairs=6, n_singles=3, size=(128, 96), seed=11,
               **settings):
    """Two-leaf SDF pairs rotating through all six CSG ops, one more hard
    union, single spheres, a Mandelbulb (which stays outside the crowd)
    and a floor -> (scene, camera, settings)."""
    rng = np.random.default_rng(seed)
    scene = api.Scene()
    mats = _crowd_mats(api, 2)
    S, B = api.Sphere, api.Box
    for k in range(n_pairs):
        c = _spot(rng, y=(-0.5, 1.0), z=(2.4, 4.2))
        a = S(center=c, radius=float(rng.uniform(0.15, 0.3)))
        if k % 2 == 0:
            b = S(center=(c[0] + 0.25, c[1], c[2]),
                  radius=float(rng.uniform(0.12, 0.25)))
        else:
            b = B(center=(c[0] + 0.2, c[1] + 0.1, c[2]), half_extents=tuple(
                float(x) for x in rng.uniform(0.08, 0.2, 3)))
        kk = float(rng.uniform(0.08, 0.25))
        # intersect and subtract keep the second leaf inside the first
        inner = S(center=(c[0] + 0.1, c[1], c[2]), radius=0.22)
        carve = S(center=(c[0] + 0.12, c[1] + 0.08, c[2]), radius=0.15)
        node = (api.union(a, b), api.intersect(a, inner),
                api.subtract(a, carve), api.smooth_union(a, b, kk),
                api.smooth_intersect(a, inner, kk),
                api.smooth_subtract(a, carve, kk))[k % 6]
        scene.add(node, mats[k % 2], engine="sdf")
    scene.add(api.union(S(center=(1.3, 1.2, 3.0), radius=0.2),
                        S(center=(1.55, 1.2, 3.0), radius=0.18)),
              mats[0], engine="sdf")
    for k in range(n_singles):
        scene.add(S(center=(-1.5 + 0.5 * k, 1.3, 3.2), radius=0.18),
                  mats[(k + 1) % 2], engine="sdf")
    scene.add(api.Mandelbulb(center=(0.0, -0.6, 4.6), scale=0.5),
              api.Material.lambert(albedo=(0.85, 0.6, 0.3)))
    scene.add(api.Plane(normal=(0.0, 1.0, 0.0), offset=-1.0),
              api.Material.lambert(albedo=(0.5, 0.5, 0.5)))
    return _crowd_view(api, scene, size, **settings)


def sphere_crowd(api, n_members: int, size=(64, 48), seed=11, **settings):
    """n_members SDF spheres of radius 0.25 (two materials) over a floor,
    hard shadows -> (scene, camera, settings): the member-count scaling
    scene."""
    rng = np.random.default_rng(seed)
    scene = api.Scene()
    for i in range(n_members):
        c = (float(rng.uniform(-3, 3)), float(rng.uniform(-1.5, 2)),
             float(rng.uniform(3, 8)))
        scene.add(api.Sphere(center=c, radius=0.25),
                  api.Material.lambert((0.3 + 0.4 * (i % 2), 0.5, 0.7)),
                  engine="sdf")
    scene.add(api.Plane(normal=(0, 1, 0), offset=-2.0),
              api.Material.lambert((0.5, 0.5, 0.5)))
    scene.add_light(api.PointLight(position=(3, 6, -1)))
    cam = api.Camera.pinhole(size[0], size[1], fov_y_deg=50.0,
                             position=(0, 0.5, -1), target=(0, 0, 4))
    st = api.RenderSettings(shadows=True, backend="pallas", tile_rows=8,
                            max_steps=48, **settings)
    return scene, cam, st


def cull_edge_scene(api, size=(61, 37), soft=False, seed=5):
    """The warp culling's edge cases -> (scene, camera, settings): sphere
    members (SDF and analytic) whose surface grazes the primary ray of a
    pixel at a warp's edge, from 1e-3 inside it to 3e-2 outside; boxes and
    pairs in front of a floor and a back wall, so that warps straddle
    depth edges; a point light with a radius as large as its distance
    (kf = dist/radius < 1.2 on the near receivers) and a directional
    light; AO and hard or soft shadows. size is best not a multiple of
    16x2, so that warps are ragged."""
    rng = np.random.default_rng(seed)
    scene = api.Scene()
    mats = _crowd_mats(api, 3)
    W, H = size
    cam = api.Camera.pinhole(W, H, fov_y_deg=50.0, position=(0.0, 0.6, -0.5),
                             target=(0.0, 0.0, 3.0))
    intr = cam.intrinsics
    R = np.asarray(cam.rotation, np.float64).reshape(3, 3)
    pos = np.asarray(cam.position, np.float64)
    edges = ((1, 15), (2, 16), (9, 31), (10, 32), (H - 1, W - 1), (17, 47),
             (0, 0), (H // 2, 16))
    offsets = (-1e-3, -1e-5, 0.0, 1e-6, 1e-5, 1e-4, 1e-3, 3e-2)
    for k, ((i, j), off) in enumerate(zip(edges, offsets)):
        d = R @ np.asarray([(j + 0.5 - intr.cx) / intr.fx,
                            (i + 0.5 - intr.cy) / intr.fy, 1.0])
        d /= np.linalg.norm(d)
        side = np.cross(d, (0.0, 1.0, 0.0))
        side /= np.linalg.norm(side)
        r = 0.12 + 0.03 * k
        c = pos + (2.4 + 0.35 * k) * d + (r + off) * side
        scene.add(api.Sphere(center=tuple(float(x) for x in c), radius=r),
                  mats[k % 3], engine="sdf" if k % 2 else None)
    for k in range(4):
        c = _spot(rng, y=(-0.8, 0.4), z=(2.6, 4.0))
        h = tuple(float(x) for x in rng.uniform(0.1, 0.25, 3))
        scene.add(api.Box(center=c, half_extents=h), mats[k % 3],
                  engine="sdf")
    for k in range(3):
        c = _spot(rng, y=(-0.5, 0.8), z=(2.8, 4.2))
        a = api.Sphere(center=c, radius=0.22)
        b = api.Sphere(center=(c[0] + 0.2, c[1] + 0.05, c[2]), radius=0.16)
        node = (api.smooth_union(a, b, 0.12), api.subtract(a, api.Sphere(
            center=(c[0] + 0.1, c[1], c[2] - 0.1), radius=0.14)),
            api.union(a, b))[k]
        scene.add(node, mats[k % 3], engine="sdf")
    lam = api.Material.lambert(albedo=(0.5, 0.5, 0.5))
    scene.add(api.Plane(normal=(0.0, 1.0, 0.0), offset=-1.0), lam)
    scene.add(api.Plane(normal=(0.0, 0.0, -1.0), offset=-5.0), lam)
    scene.add_light(api.PointLight(position=(1.5, 2.5, 1.5), radius=3.0))
    scene.add_light(api.DirectionalLight(direction=(-0.3, -1.0, 0.4),
                                         color=(0.3, 0.3, 0.35)))
    st = api.RenderSettings(backend="pallas", tile_rows=8, max_steps=96,
                            shadows=True, soft_shadows=soft, ao=True)
    return scene, cam, st


def crowd_cases(api, size=(128, 96)):
    """-> {name: (scene, camera, settings)}: the crowd shapes the kernels
    are held to (vector_objects still off in the settings)."""
    return {
        "crowd hard+ao": crowd_scene(api, size=size, shadows=True, ao=True),
        "crowd soft": crowd_scene(api, size=size, shadows=True,
                                  soft_shadows=True),
        "crowd only": crowd_scene(api, with_plane=False, size=size,
                                  shadows=True, ao=True),
        "pairs all ops": pair_scene(api, size=size, shadows=True, ao=True),
        "pairs soft": pair_scene(api, size=size, shadows=True,
                                 soft_shadows=True),
        "analytic members": crowd_scene(
            api, n_spheres=6, n_boxes=3, engine=None, n_sdf_spheres=3,
            seed=13, size=size, shadows=True, ao=True),
        "analytic members soft": crowd_scene(
            api, n_spheres=6, n_boxes=3, engine=None, n_sdf_spheres=3,
            seed=13, size=size, shadows=True, ao=True, soft_shadows=True),
        "crowd + mesh": crowd_scene(api, n_spheres=5, n_boxes=2, mesh=True,
                                    size=size, shadows=True, ao=True),
    }


def crowd_main_path(config_path: str, n_frames: int = 48):
    """-> (scene, camera at 1920x1080, R_flats, positions, modes) of a
    crowd config: `config` (the yaml's settings) and `soft` (soft shadows
    on), both with backend pallas."""
    scene, camera, settings, _ = load_config(config_path)
    camera = reframe(camera, 1920, 1080)
    Rs, ps = poses(camera, n_frames, jitter(n_frames))
    modes = {"config": settings.with_(backend="pallas"),
             "soft": settings.with_(backend="pallas", soft_shadows=True)}
    return scene, camera, Rs, ps, modes


def crowd_mesh_main_path(n_frames: int = 16):
    """The split path's crowd main path: surfjax_torch/configs/
    crowd_mesh.yaml (crowd_demo's 49 objects and c4's octasphere) as
    crowd_main_path has a crowd config, n_frames positions -> (scene,
    camera at 1920x1080, R_flats, positions, modes `config` and `soft`).
    The mesh sends every frame through K1 and K2 with the crowd's member
    loops, the mesh kernel and ao_fix."""
    return crowd_main_path(CROWD_MESH, n_frames)


def _floor_grid(api, scene, n: int, engine="sdf", radius=0.11, pitch=0.26,
                cols=12):
    """n small spheres on a grid just above the floor of _limit_view, close
    enough that a receiver's AO gate holds dozens of them."""
    mats = _crowd_mats(api, 3)
    for i in range(n):
        c = ((i % cols - (cols - 1) / 2) * pitch, -0.85 + 0.02 * (i % 3),
             2.2 + (i // cols) * pitch)
        scene.add(api.Sphere(center=c, radius=radius), mats[i % 3],
                  engine=engine)


def _limit_view(api, scene, size, plane=True, **settings):
    """A floor, a point light and a camera looking down at _floor_grid's
    spheres -> (scene, camera, settings with backend pallas)."""
    if plane:
        scene.add(api.Plane(normal=(0.0, 1.0, 0.0), offset=-1.0),
                  api.Material.lambert(albedo=(0.5, 0.5, 0.55)))
    scene.add_light(api.PointLight(position=(2.0, 4.0, 0.0)))
    cam = api.Camera.pinhole(size[0], size[1], fov_y_deg=55.0,
                             position=(0.0, 1.2, 0.6),
                             target=(0.0, -0.9, 3.4))
    st = api.RenderSettings(backend="pallas", tile_rows=8, max_steps=64,
                            shadow_steps=32, shadows=True, **settings)
    return scene, cam, st


def _chain(api, leaves, op, right: bool):
    """leaves joined by op (a function of two nodes) into a left-deep
    chain, op(op(l0, l1), l2)..., or a right-deep one, l0 op (l1 op ...)."""
    if right:
        node = leaves[-1]
        for lf in reversed(leaves[:-1]):
            node = op(lf, node)
        return node
    node = leaves[0]
    for lf in leaves[1:]:
        node = op(node, lf)
    return node


def tape_object(api, n_leaves: int, right: bool, smooth: bool = True):
    """One object of n_leaves spheres in a ring of blobs: an SDF smooth
    union (smooth) or an analytic union of spheres and boxes, a chain of
    2 * n_leaves - 1 nodes, left- or right-deep."""
    leaves = []
    for i in range(n_leaves):
        a = 2.0 * np.pi * i / n_leaves
        c = (0.7 * float(np.cos(a)), -0.55 + 0.25 * float(np.sin(3 * a)),
             3.2 + 0.7 * float(np.sin(a)))
        if not smooth and i % 3 == 2:
            leaves.append(api.Box(center=c, half_extents=(0.12, 0.15, 0.1)))
        else:
            leaves.append(api.Sphere(center=c, radius=0.18))
    if smooth:
        return _chain(api, leaves,
                      lambda a, b: api.smooth_union(a, b, 0.08), right)
    return _chain(api, leaves, api.union, right)


def limit_cases(api, size=(32, 32)):
    """-> {name: (scene, camera, settings)}: scenes past the kernels'
    former fixed bounds (64 objects outside the crowd, 32 tape nodes, 16
    analytic leaves), built with the package's api module; vector_objects
    is set where the case names a crowd, and only there.

      * `64 spheres`: 64 SDF spheres and a floor (65 objects), hard
        shadows and AO; `120+8`: 120 SDF spheres, 8 analytic boxes
        and a floor, hard and (`... soft`) soft shadows, AO on both;
      * `crowd 120+8+70`: the 128 beside 70 three-leaf SDF unions, which the
        crowd does not take, so 71 objects stay outside it;
      * `smooth 17 left|right`, `smooth 65 left|right`: one SDF smooth
        union of 17 or 65 spheres (33 and 129 nodes) over a floor;
      * `union 17`, `union 40`: one analytic union of spheres and boxes;
      * `mesh + 70`: a 32-triangle mesh beside 70 SDF spheres, through
        the split path, AO on;
      * `crowd 120+8+70 + mesh`: `crowd 120+8+70` with that mesh beside it,
        so the split path's crowd kernels take 71 objects outside the
        crowd.
    """
    def grid(n_sdf, boxes=0, threes=0, crowd=False, soft=False, mesh=None):
        scene = api.Scene()
        _floor_grid(api, scene, n_sdf)
        mats = _crowd_mats(api, 2)
        for k in range(boxes):
            c = ((k - 3.5) * 0.3, -0.3, 2.0)
            scene.add(api.Box(center=c, half_extents=(0.1, 0.1, 0.1)),
                      mats[k % 2], engine="analytic")
        for k in range(threes):
            c = ((k % 10 - 4.5) * 0.32, -0.45, 2.4 + (k // 10) * 0.32)
            S = api.Sphere
            scene.add(api.union(api.union(S(center=c, radius=0.07),
                                          S(center=(c[0] + 0.08, c[1], c[2]),
                                            radius=0.06)),
                                S(center=(c[0], c[1] + 0.08, c[2]),
                                  radius=0.05)), mats[k % 2], engine="sdf")
        if mesh is not None:
            v, f = octasphere(1)
            v = v * 0.35 + np.asarray(mesh, np.float32)
            scene.add(api.TriangleMesh(vertices=v, faces=f),
                      api.Material.lambert(albedo=(0.7, 0.7, 0.75)))
        return _limit_view(api, scene, size, ao=True, soft_shadows=soft,
                           vector_objects=crowd)

    def one(node, engine):
        scene = api.Scene()
        scene.add(node, api.Material.blinn_phong(albedo=(0.4, 0.7, 0.5),
                                                 shininess=16),
                  engine=engine)
        return _limit_view(api, scene, size, ao=True)

    cases = {
        "64 spheres": grid(64),
        "120+8": grid(120, boxes=8),
        "120+8 soft": grid(120, boxes=8, soft=True),
        "crowd 120+8+70": grid(120, boxes=8, threes=70, crowd=True),
        "mesh + 70": grid(70, mesh=(0.5, -0.55, 2.9)),
        "crowd 120+8+70 + mesh": grid(120, boxes=8, threes=70, crowd=True,
                                      mesh=(0.6, -0.55, 4.45)),
    }
    for n in (17, 65):
        for side in ("left", "right"):
            cases[f"smooth {n} {side}"] = one(
                tape_object(api, n, side == "right"), "sdf")
    for n in (17, 40):
        cases[f"union {n}"] = one(tape_object(api, n, True, smooth=False),
                                  "analytic")
    return cases


# the perturbed pose the pose fit starts from: (axis-angle w, position dt)
FIT_POSE_INIT = ((0.05, -0.04, 0.03), (0.05, -0.05, 0.0))


def sdf_fit_start(scene, seed: int = 0, sigma: float = 0.05):
    """The SDF fit's perturbed start -> (true leaf_params, init, mask):
    centre and size (columns 0-3) of every leaf of the SDF-engine objects
    moved by N(0, sigma) drawn from `seed`; analytic planes and hard-shadow
    edges carry no useful gradient and stay fixed."""
    from surfjax_torch.core.scene_compile import ENGINE_SDF
    static, true_params = scene.freeze()
    true_lp = np.array(true_params["leaf_params"], np.float32)
    mask = np.zeros_like(true_lp)
    for oir in static.ir.objects:
        if oir.engine == ENGINE_SDF:
            for lf in oir.leaves:
                mask[lf.slot, :4] = 1.0
    rng = np.random.default_rng(seed)
    init = true_lp + (rng.normal(0, sigma, true_lp.shape)
                      * mask).astype(np.float32)
    return true_lp, init, mask


def fit_main_path(config_path: str):
    """The fit's main path -> (scene, camera, settings with backend
    pallas, the config's fit block {"type", "steps", "lr"}, the pose fit's
    start (w, dt)): a fit config as it is, at its own size, started as the
    command line's `fit` starts it."""
    scene, camera, settings, extras = load_config(config_path)
    cfg = dict(extras.get("fit", {}))
    cfg = {"type": cfg.get("type", "pose"),
           "steps": int(cfg.get("steps", 100)),
           "lr": float(cfg.get("lr", 2e-2))}
    init = tuple(np.asarray(v, np.float32) for v in FIT_POSE_INIT)
    return scene, camera, settings.with_(backend="pallas"), cfg, init


def cuda_ms(fn, reps: int):
    """-> (list of per-call ms by CUDA events, last result)."""
    times, out = [], None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times, out
