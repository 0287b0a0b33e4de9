"""A configuration file -> the reference's own scene, camera and settings.

Plain Python and NumPy: it reads the configuration file that the harness
hands to the program and builds everything the reference renders from it
again (node trees, meshes, lights, intrinsics, the camera's rotation),
with none of the program's code. The schema is the repository's yaml
schema (camera, settings, objects, lights), written as JSON.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

OP_LEAF, OP_UNION, OP_INTERSECT, OP_SUBTRACT = 0, 1, 2, 3
OP_SMOOTH_UNION, OP_SMOOTH_INTERSECT, OP_SMOOTH_SUBTRACT = 4, 5, 6
SMOOTH_OPS = (OP_SMOOTH_UNION, OP_SMOOTH_INTERSECT, OP_SMOOTH_SUBTRACT)
_OPS = {"union": OP_UNION, "intersect": OP_INTERSECT,
        "subtract": OP_SUBTRACT, "smooth_union": OP_SMOOTH_UNION,
        "smooth_intersect": OP_SMOOTH_INTERSECT,
        "smooth_subtract": OP_SMOOTH_SUBTRACT}

# the render settings the reference reads, with the defaults of the
# renderer's published settings (a key the file leaves out takes these)
DEFAULTS = dict(
    max_steps=256, t_min=1e-3, t_max=1e4, hit_eps=1e-3, hit_eps_scale=0.0,
    normal_eps=5e-4, normals="auto", shadow_steps=64, shadows=True,
    soft_shadows=False, soft_shadow_k=8.0, soft_shadow_tmin=0.02,
    shadow_eps=1e-3, ao=False, ao_samples=5, ao_radius=0.5,
    ao_strength=1.0, background=(0.0, 0.0, 0.0), bulb_log="hw")


@dataclasses.dataclass(frozen=True)
class Sphere:
    center: tuple
    radius: float


@dataclasses.dataclass(frozen=True)
class Plane:
    normal: tuple
    offset: float = 0.0


@dataclasses.dataclass(frozen=True)
class Box:
    center: tuple
    half_extents: tuple


@dataclasses.dataclass(frozen=True)
class Mandelbulb:
    center: tuple = (0.0, 0.0, 0.0)
    scale: float = 1.0
    power: int = 8
    iterations: int = 8
    bailout: float = 2.0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    vertices: np.ndarray     # (V, 3) float32
    faces: np.ndarray        # (F, 3) int32
    smooth: bool = True


@dataclasses.dataclass(frozen=True)
class CSG:
    op: int
    a: object
    b: object
    k: float = 0.0


@dataclasses.dataclass(frozen=True)
class Material:
    albedo: tuple = (0.8, 0.8, 0.8)
    ka: float = 0.1
    kd: float = 0.9
    ks: float = 0.0
    shininess: int = 32
    specular_color: tuple = (1.0, 1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class Object:
    node: object
    material: Material
    engine: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class PointLight:
    position: tuple
    color: tuple = (1.0, 1.0, 1.0)
    radius: float = 0.0


@dataclasses.dataclass(frozen=True)
class DirectionalLight:
    direction: tuple
    color: tuple = (1.0, 1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class Scene:
    objects: List[Object]
    lights: list
    ambient: tuple = (1.0, 1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float


def octasphere(subdivisions: int):
    """A subdivided octahedron projected onto the unit sphere:
    8 * 4**subdivisions triangles -> (vertices (V, 3) float32, faces
    (F, 3) int32), midpoints normalised in float64, vertices numbered in
    the order they are made."""
    verts = [np.array(v, np.float64) for v in
             ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
              (0, 0, -1))]
    faces = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
             (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)]
    for _ in range(subdivisions):
        cache, new_faces = {}, []

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = (verts[i] + verts[j]) * 0.5
                cache[key] = len(verts)
                verts.append(m / np.sqrt(np.dot(m, m)))
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc),
                          (ab, bc, ca)]
        faces = new_faces
    return np.stack(verts).astype(np.float32), np.asarray(faces, np.int32)


def node(d: dict):
    t = d["type"]
    if t == "sphere":
        return Sphere(tuple(d["center"]), float(d["radius"]))
    if t == "plane":
        return Plane(tuple(d["normal"]), float(d.get("offset", 0.0)))
    if t == "box":
        return Box(tuple(d["center"]), tuple(d["half_extents"]))
    if t == "mandelbulb":
        return Mandelbulb(tuple(d.get("center", (0.0, 0.0, 0.0))),
                          float(d.get("scale", 1.0)), int(d.get("power", 8)),
                          int(d.get("iterations", 8)),
                          float(d.get("bailout", 2.0)))
    if t == "mesh":
        if d.get("generate") != "octasphere":
            raise ValueError("the reference builds only generated "
                             "octasphere meshes")
        v, f = octasphere(int(d.get("subdivisions", 2)))
        v = v * np.float32(d.get("scale", 1.0))
        v = v + np.asarray(d.get("translate", (0.0, 0.0, 0.0)), np.float32)
        return Mesh(v.astype(np.float32), f, bool(d.get("smooth", True)))
    if t in _OPS:
        return CSG(_OPS[t], node(d["a"]), node(d["b"]),
                   float(d.get("k", 0.0)))
    raise ValueError(f"unknown node type {t!r}")


def material(d: dict) -> Material:
    kind = d.get("type", "lambert")
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in d.items() if k != "type"}
    if kind == "lambert":
        return Material(**{"ks": 0.0, **kw})
    if kind == "blinn_phong":
        return Material(**{"kd": 0.7, "ks": 0.3, **kw})
    raise ValueError(f"unknown material type {kind!r}")


def scene_of(cfg: dict) -> Scene:
    objects = [Object(node(o["node"]), material(o.get("material", {})),
                      o.get("engine")) for o in cfg.get("objects", [])]
    lights = []
    for ld in cfg.get("lights", []):
        if ld.get("type", "point") == "point":
            lights.append(PointLight(tuple(ld["position"]),
                                     tuple(ld.get("color", (1, 1, 1))),
                                     float(ld.get("radius", 0.0))))
        else:
            lights.append(DirectionalLight(tuple(ld["direction"]),
                                           tuple(ld.get("color", (1, 1, 1)))))
    return Scene(objects, lights)


def settings_of(cfg: dict, mode: Optional[dict] = None) -> dict:
    """The configuration's settings over DEFAULTS, then the traffic's mode
    overrides; keys the reference does not read are dropped."""
    s = dict(DEFAULTS)
    for src in (cfg.get("settings", {}), mode or {}):
        s.update({k: v for k, v in src.items() if k in DEFAULTS})
    s["background"] = tuple(s["background"])
    return s


def intrinsics_of(cfg: dict) -> Intrinsics:
    """Pinhole intrinsics from the camera's size and vertical fov."""
    c = cfg["camera"]
    w, h = int(c["width"]), int(c["height"])
    f = 0.5 * h / math.tan(math.radians(float(c.get("fov", 45.0))) * 0.5)
    return Intrinsics(w, h, f, f, 0.5 * w, 0.5 * h)


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> Tuple[np.ndarray, tuple]:
    """world_from_cam rotation (row-major (9,) float32) of a camera at `eye`
    looking at `target`; camera +z forward, world up maps to camera -y."""
    fz = np.asarray(target, np.float64) - np.asarray(eye, np.float64)
    fz = fz / math.sqrt(float(np.dot(fz, fz)))
    up = np.asarray(up, np.float64)
    rx = np.cross(fz, up)
    if math.sqrt(float(np.dot(rx, rx))) < 1e-8:
        up = np.asarray((0.0, 0.0, 1.0) if abs(fz[2]) < 0.9
                        else (1.0, 0.0, 0.0))
        rx = np.cross(fz, up)
    rx = rx / math.sqrt(float(np.dot(rx, rx)))
    dy = np.cross(fz, rx)
    R = np.stack([rx, dy, fz], axis=1)
    return R.astype(np.float32).reshape(9), tuple(float(e) for e in eye)


def camera_pose(cfg: dict):
    """-> (R_flat (9,) float32, position (3,) float32) of the file's
    camera."""
    c = cfg["camera"]
    pos = tuple(c.get("position", (0.0, 0.0, 0.0)))
    if "target" in c:
        R, pos = look_at(pos, tuple(c["target"]),
                         tuple(c.get("up", (0.0, 1.0, 0.0))))
    else:
        R = np.eye(3, dtype=np.float32).reshape(9)
    return R, np.asarray(pos, np.float32)
