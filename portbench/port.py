"""The system under test: the configuration handed to the port.

The one module of the harness that imports the program (`surfjax_torch`,
the PyTorch and CUDA port), and only its public interface: the scene
classes of `surfjax_torch.api`, `RenderSettings`, and the entry
`render_sequence` that the window drives.
"""

from __future__ import annotations

import numpy as np


def build(cfg: dict, mode: dict, intr, R_flat):
    """The configuration file's scene, the camera at the harness's
    intrinsics and rotation, and the settings with the traffic's mode over
    them and backend pallas -> (scene, camera, settings, entries) where
    entries = {"render_sequence": ...}."""
    from surfjax_torch import api
    from surfjax_torch.core.types import RenderSettings

    scene = api.Scene()
    for od in cfg["objects"]:
        scene.add(_node(api, od["node"]), _material(api, od.get("material",
                                                                {})),
                  engine=od.get("engine"))
    for ld in cfg["lights"]:
        if ld.get("type", "point") == "point":
            scene.add_light(api.PointLight(tuple(ld["position"]),
                                           tuple(ld.get("color", (1, 1, 1))),
                                           float(ld.get("radius", 0.0))))
        else:
            scene.add_light(api.DirectionalLight(
                tuple(ld["direction"]), tuple(ld.get("color", (1, 1, 1)))))
    camera = api.Camera.from_intrinsics(
        intr.width, intr.height, intr.fx, intr.fy, intr.cx, intr.cy,
        rotation=rotation(R_flat))
    s = dict(cfg["settings"], **mode, backend="pallas")
    s["background"] = tuple(s["background"])
    return scene, camera, RenderSettings(**s), {
        "render_sequence": api.render_sequence}


def rotation(R_flat) -> tuple:
    """(9,) row-major -> the api's 3x3 tuple of floats."""
    R = np.asarray(R_flat, np.float32).reshape(3, 3)
    return tuple(tuple(float(x) for x in row) for row in R)


def _node(api, d: dict):
    t = d["type"]
    if t == "sphere":
        return api.Sphere(tuple(d["center"]), float(d["radius"]))
    if t == "plane":
        return api.Plane(tuple(d["normal"]), float(d.get("offset", 0.0)))
    if t == "box":
        return api.Box(tuple(d["center"]), tuple(d["half_extents"]))
    if t == "mandelbulb":
        return api.Mandelbulb(tuple(d.get("center", (0.0, 0.0, 0.0))),
                              float(d.get("scale", 1.0)),
                              int(d.get("power", 8)),
                              int(d.get("iterations", 8)),
                              float(d.get("bailout", 2.0)))
    if t == "mesh":
        from portbench.reference.scene import node
        mesh = node(d)
        return api.TriangleMesh(vertices=mesh.vertices, faces=mesh.faces,
                                smooth=mesh.smooth)
    ops = {"union": api.union, "intersect": api.intersect,
           "subtract": api.subtract}
    if t in ops:
        return ops[t](_node(api, d["a"]), _node(api, d["b"]))
    smooth = {"smooth_union": api.smooth_union,
              "smooth_intersect": api.smooth_intersect,
              "smooth_subtract": api.smooth_subtract}
    if t in smooth:
        return smooth[t](_node(api, d["a"]), _node(api, d["b"]),
                         float(d["k"]))
    raise ValueError(f"unknown node type {t!r}")


def _material(api, d: dict):
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in d.items() if k != "type"}
    if d.get("type", "lambert") == "blinn_phong":
        return api.Material.blinn_phong(**kw)
    return api.Material.lambert(**kw)
