"""YAML scene/config loader: the schema of `surfjax/config.py`.

    camera:   {width, height, fov, position, target?, up?}
    settings: {any RenderSettings field}
    objects:  [{node: <node>, material: <mat>, engine?: analytic|sdf|mesh}]
    lights:   [{type: point|directional, ...}]
    animation?: {type: orbit, frames, radius, height, center?}

A mesh node is `generate: octasphere` (meshgen.py) or `obj: <path>`, a
path relative to the config file's directory unless absolute.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from surfjax_torch import api
from surfjax_torch.core.types import RenderSettings

_NODE_KEYS = {
    "sphere": {"type", "center", "radius"},
    "plane": {"type", "normal", "offset"},
    "box": {"type", "center", "half_extents"},
    "mandelbulb": {"type", "center", "scale", "power", "iterations",
                   "bailout"},
    "mesh": {"type", "generate", "subdivisions", "obj", "scale",
             "translate", "smooth", "grid_res"},
    "union": {"type", "a", "b"}, "intersect": {"type", "a", "b"},
    "subtract": {"type", "a", "b"},
    "smooth_union": {"type", "a", "b", "k"},
    "smooth_intersect": {"type", "a", "b", "k"},
    "smooth_subtract": {"type", "a", "b", "k"},
}


def _node(d: dict, base_dir: str = "") -> api.SceneNode:
    t = d["type"]
    if t in _NODE_KEYS:
        unknown = set(d) - _NODE_KEYS[t]
        if unknown:
            raise ValueError(
                f"unknown keys for node type {t!r}: {sorted(unknown)}")
    if t == "sphere":
        return api.Sphere(tuple(d["center"]), float(d["radius"]))
    if t == "plane":
        return api.Plane(tuple(d["normal"]), float(d.get("offset", 0.0)))
    if t == "box":
        return api.Box(tuple(d["center"]), tuple(d["half_extents"]))
    if t == "mandelbulb":
        return api.Mandelbulb(tuple(d.get("center", (0, 0, 0))),
                              float(d.get("scale", 1.0)),
                              int(d.get("power", 8)),
                              int(d.get("iterations", 8)),
                              float(d.get("bailout", 2.0)))
    if t == "mesh":
        return _mesh_node(d, base_dir)
    if t in ("union", "intersect", "subtract"):
        fn = {"union": api.union, "intersect": api.intersect,
              "subtract": api.subtract}[t]
        return fn(_node(d["a"], base_dir), _node(d["b"], base_dir))
    if t in ("smooth_union", "smooth_intersect", "smooth_subtract"):
        fn = {"smooth_union": api.smooth_union,
              "smooth_intersect": api.smooth_intersect,
              "smooth_subtract": api.smooth_subtract}[t]
        return fn(_node(d["a"], base_dir), _node(d["b"], base_dir),
                  float(d["k"]))
    raise ValueError(f"unknown node type {t!r}")


def _mesh_node(d: dict, base_dir: str) -> api.TriangleMesh:
    gen = d.get("generate")
    if gen == "octasphere":
        from surfjax_torch.meshgen import octasphere
        v, f = octasphere(int(d.get("subdivisions", 2)))
    elif "obj" in d:
        path = d["obj"]
        if not os.path.isabs(path) and base_dir:
            path = os.path.join(base_dir, path)
        v, f = load_obj(path)
    else:
        raise ValueError("mesh node needs generate: or obj:")
    v = np.asarray(v, np.float32) * float(d.get("scale", 1.0))
    v = v + np.asarray(d.get("translate", (0, 0, 0)), np.float32)
    return api.TriangleMesh(
        vertices=v, faces=f,
        grid_res=(tuple(d["grid_res"]) if "grid_res" in d else None),
        smooth=bool(d.get("smooth", True)))


def load_obj(path: str):
    """OBJ loader: v / f records, polygons triangulated as fans, 1-based
    or negative (relative) indices, i/j/k face syntax; malformed short v
    rows are skipped. -> (vertices (V,3) f32, faces (F,3) i32)."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                if len(parts) < 4:
                    continue
                try:
                    row = [float(x) for x in parts[1:4]]
                except ValueError:
                    continue
                verts.append(row)
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) for p in parts[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(faces, np.int32).reshape(-1, 3))


def _material(d: dict) -> api.Material:
    t = d.get("type", "lambert")
    kw = {k: v for k, v in d.items() if k != "type"}
    for key in ("albedo", "specular_color"):
        if key in kw:
            kw[key] = tuple(kw[key])
    if t == "lambert":
        return api.Material.lambert(**kw)
    if t == "blinn_phong":
        return api.Material.blinn_phong(**kw)
    raise ValueError(f"unknown material type {t!r}")


def load_config(path: str):
    """-> (scene, camera, settings, extras dict)."""
    import yaml
    with open(path) as fh:
        cfg = yaml.safe_load(fh)

    base_dir = os.path.dirname(os.path.abspath(path))
    scene = api.Scene()
    for od in cfg.get("objects", []):
        scene.add(_node(od["node"], base_dir),
                  _material(od.get("material", {})),
                  engine=od.get("engine"))
    for ld in cfg.get("lights", []):
        t = ld.get("type", "point")
        if t == "point":
            scene.add_light(api.PointLight(tuple(ld["position"]),
                                           tuple(ld.get("color", (1, 1, 1))),
                                           float(ld.get("radius", 0.0))))
        else:
            scene.add_light(api.DirectionalLight(
                tuple(ld["direction"]), tuple(ld.get("color", (1, 1, 1)))))

    c = cfg["camera"]
    camera = api.Camera.pinhole(int(c["width"]), int(c["height"]),
                                float(c.get("fov", 45.0)),
                                position=tuple(c.get("position", (0, 0, 0))),
                                target=(tuple(c["target"])
                                        if "target" in c else None),
                                up=tuple(c.get("up", (0, 1, 0))))

    s = dict(cfg.get("settings", {}))
    valid = {f.name for f in dataclasses.fields(RenderSettings)}
    unknown = set(s) - valid
    if unknown:
        raise ValueError(f"unknown settings: {sorted(unknown)}")
    if "background" in s:
        s["background"] = tuple(s["background"])
    settings = RenderSettings(**s)

    extras = {k: cfg[k] for k in ("animation", "fit") if k in cfg}
    return scene, camera, settings, extras
