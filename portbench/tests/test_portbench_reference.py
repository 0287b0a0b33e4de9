"""The plain reference at a tiny size against known buffers: the
repository's NumPy golden oracle on the same scene, camera and settings;
and the control (the reference in bfloat16) far from it."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import check, port
from portbench.reference import golden, scene as rs
from portbench.spec import PKG

CASES = [("c3_sdf", {}), ("c4_mesh", {}),
         ("c4_mesh", {"ao": True, "soft_shadows": True})]
W, H = 40, 24


def _setup(name, mode):
    with open(os.path.join(PKG, "configs", name + ".json")) as fh:
        cfg = json.load(fh)
    cfg["camera"].update(width=W, height=H)
    intr = rs.intrinsics_of(cfg)
    R, pos = rs.camera_pose(cfg)
    rows, cols = torch.meshgrid(torch.arange(H), torch.arange(W),
                                indexing="ij")
    rows, cols = rows.reshape(-1), cols.reshape(-1)

    def render(dtype):
        o, d = golden.camera_rays(intr, torch.as_tensor(R)[None],
                                  torch.as_tensor(pos)[None],
                                  torch.zeros_like(rows), rows, cols, dtype)
        out = golden.render_rays(rs.scene_of(cfg), rs.settings_of(cfg, mode),
                                 o, d, dtype)
        return {k: v.float().numpy() for k, v in out.items()}
    return cfg, intr, R, pos, render


@pytest.mark.parametrize("name,mode", CASES)
def test_reference_matches_the_numpy_golden(name, mode):
    """Against surfjax_torch.golden.renderer (NumPy, float32) on the same
    scene: hits and ids equal; rgb, depth and normal within a few float32
    ULPs (the two libraries' log and division may round differently)."""
    from surfjax_torch.golden import renderer as numpy_golden
    cfg, intr, R, pos, render = _setup(name, mode)
    scene, camera, settings, _ = port.build(cfg, mode, intr, R)
    camera = type(camera)(camera.intrinsics, camera.rotation,
                          tuple(float(x) for x in pos))
    gold = numpy_golden.render(scene, camera, settings)
    ref = render(torch.float32)
    np.testing.assert_array_equal(ref["hit"], gold["hit"].reshape(-1))
    np.testing.assert_array_equal(ref["obj_id"], gold["obj_id"].reshape(-1))
    for k in ("rgb", "depth", "normal"):
        np.testing.assert_allclose(ref[k].reshape(gold[k].shape), gold[k],
                                   rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name,mode", CASES)
def test_control_in_bfloat16_reads_far_from_the_reference(name, mode):
    """The control: the same renderer with every value held in bfloat16.
    Its rgb is off by far more than the port's figures (c3 about 4e-3,
    c4 1e-8 to 1e-5), and it loses hits."""
    *_, render = _setup(name, mode)
    nums = check.numbers(render(torch.bfloat16), render(torch.float32))
    assert nums["rgb_abs_mean"] > 1e-2
    assert nums["depth_err_mean"] > 1e-3


# every node, light and material kind the schema has, in one scene: the
# cells' configurations use some of them, the cells of PERF.md's open
# questions (crowds of spheres, boxes and CSG pairs) the others
ALL_KINDS = {
    "camera": {"width": W, "height": H, "fov": 50.0,
               "position": [0.0, 0.6, -0.5], "target": [0.0, 0.0, 3.0]},
    "settings": {"shadows": True, "soft_shadows": False, "ao": True,
                 "ao_samples": 4, "t_max": 30.0, "max_steps": 96},
    "objects": [
        {"node": {"type": "subtract",
                  "a": {"type": "box", "center": [-1.0, -0.2, 3.0],
                        "half_extents": [0.4, 0.4, 0.4]},
                  "b": {"type": "sphere", "center": [-1.0, -0.2, 2.6],
                        "radius": 0.35}},
         "material": {"type": "blinn_phong", "albedo": [0.7, 0.3, 0.3]}},
        {"node": {"type": "intersect",
                  "a": {"type": "sphere", "center": [0.2, 0.1, 3.4],
                        "radius": 0.5},
                  "b": {"type": "box", "center": [0.2, 0.1, 3.4],
                        "half_extents": [0.45, 0.3, 0.45]}}},
        {"node": {"type": "union",
                  "a": {"type": "sphere", "center": [1.1, 0.4, 3.0],
                        "radius": 0.25},
                  "b": {"type": "sphere", "center": [1.3, 0.2, 3.1],
                        "radius": 0.25}}},
        {"engine": "sdf",
         "node": {"type": "smooth_subtract", "k": 0.1,
                  "a": {"type": "smooth_intersect", "k": 0.1,
                        "a": {"type": "box", "center": [0.4, -0.6, 2.4],
                              "half_extents": [0.3, 0.2, 0.3]},
                        "b": {"type": "sphere", "center": [0.4, -0.6, 2.4],
                              "radius": 0.35}},
                  "b": {"type": "sphere", "center": [0.4, -0.45, 2.2],
                        "radius": 0.15}}},
        {"node": {"type": "mandelbulb", "center": [-0.3, 0.6, 3.6],
                  "scale": 0.4, "power": 7, "iterations": 6}},
        {"node": {"type": "mesh", "generate": "octasphere",
                  "subdivisions": 2, "scale": 0.3, "smooth": False,
                  "translate": [1.0, -0.6, 2.6]}},
        {"node": {"type": "plane", "normal": [0.0, 2.0, 0.0],
                  "offset": -2.0}}],
    "lights": [{"type": "point", "position": [2.0, 3.0, 0.0],
                "color": [1.0, 0.9, 0.8]},
               {"type": "directional", "direction": [-0.3, -1.0, 0.4],
                "color": [0.3, 0.3, 0.35]}],
}


def test_reference_matches_the_numpy_golden_on_every_kind():
    """Analytic event CSG (union, intersect, subtract), SDF smooth
    intersect and subtract, a power-7 Mandelbulb, a flat-shaded mesh, a
    scaled plane normal, a directional light."""
    from surfjax_torch.golden import renderer as numpy_golden
    cfg = ALL_KINDS
    intr = rs.intrinsics_of(cfg)
    R, pos = rs.camera_pose(cfg)
    scene, camera, settings, _ = port.build(
        dict(cfg, settings=dict(rs.DEFAULTS, **cfg["settings"])), {}, intr,
        R)
    camera = type(camera)(camera.intrinsics, camera.rotation,
                          tuple(float(x) for x in pos))
    gold = numpy_golden.render(scene, camera, settings)
    rows, cols = torch.meshgrid(torch.arange(H), torch.arange(W),
                                indexing="ij")
    rows, cols = rows.reshape(-1), cols.reshape(-1)
    o, d = golden.camera_rays(intr, torch.as_tensor(R)[None],
                              torch.as_tensor(pos)[None],
                              torch.zeros_like(rows), rows, cols,
                              torch.float32)
    ref = {k: v.numpy() for k, v in golden.render_rays(
        rs.scene_of(cfg), rs.settings_of(cfg), o, d).items()}
    assert len(set(ref["obj_id"].tolist())) == 8    # all seven, and misses
    np.testing.assert_array_equal(ref["obj_id"], gold["obj_id"].reshape(-1))
    # the power-7 bulb goes through exp, log, arccos and atan2, which the
    # two libraries round differently by an ULP; the finite-difference
    # normal (offsets of 5e-4) turns that into up to ~2e-4
    for k, tol in (("rgb", 1e-4), ("depth", 1e-4), ("normal", 1e-3)):
        np.testing.assert_allclose(ref[k].reshape(gold[k].shape), gold[k],
                                   rtol=tol, atol=tol, err_msg=k)
