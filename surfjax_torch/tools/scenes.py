"""The benchmark's scenes, built with this package's api: the SPEC configs'
fixture scenes (`config1_sphere` .. `config4_mesh`, as the JAX package's
tests build them), the 65-object crowd of its performance gate
(`crowd64`) and the orbit poses of its c5 sequence row (`c5_orbit_poses`).

World convention: right-handed, y up; the camera looks along +z with x
right and y down. Floors are solid y <= offset (normal (0, 1, 0)); lights
sit at positive y.
"""

from __future__ import annotations

import numpy as np
import torch

from surfjax_torch.api import (
    Box, Camera, DirectionalLight, Mandelbulb, Material, Plane, PointLight,
    Scene, Sphere, TriangleMesh, intersect, smooth_union, subtract,
)
from surfjax_torch.core.camera import orbit_pose
from surfjax_torch.core.types import RenderSettings
from surfjax_torch.meshgen import octasphere


def config1_sphere(size=256):
    """Config 1: one analytic sphere, pinhole camera, Lambert."""
    scene = Scene()
    scene.add(Sphere(center=(0.0, 0.0, 3.0), radius=1.0),
              Material.lambert(albedo=(0.8, 0.3, 0.2)))
    scene.add_light(PointLight(position=(3.0, 4.0, -2.0),
                               color=(1.0, 1.0, 1.0)))
    cam = Camera.pinhole(size, size, fov_y_deg=45.0)
    return scene, cam, RenderSettings(shadows=False)


def config2_csg(size=512):
    """Config 2: spheres, a plane and a box under CSG, Blinn-Phong, hard
    shadows from a point and a directional light."""
    scene = Scene()
    scene.add(Plane(normal=(0.0, 1.0, 0.0), offset=-1.5),
              Material.lambert(albedo=(0.6, 0.6, 0.6)))
    scene.add(
        subtract(Box(center=(-1.2, -0.5, 4.0), half_extents=(0.8, 0.8, 0.8)),
                 Sphere(center=(-1.2, -0.5, 3.2), radius=0.9)),
        Material.blinn_phong(albedo=(0.2, 0.5, 0.8), shininess=64))
    scene.add(
        intersect(Sphere(center=(1.1, -0.6, 3.6), radius=0.9),
                  Sphere(center=(1.7, -0.6, 3.6), radius=0.9)),
        Material.blinn_phong(albedo=(0.9, 0.7, 0.2), ks=0.5, shininess=16))
    scene.add(Sphere(center=(0.0, 0.6, 5.0), radius=0.7),
              Material.blinn_phong(albedo=(0.8, 0.2, 0.4), shininess=32))
    scene.add_light(PointLight(position=(4.0, 5.0, 0.0),
                               color=(1.0, 1.0, 1.0)))
    scene.add_light(DirectionalLight(direction=(-0.3, -1.0, 0.4),
                                     color=(0.25, 0.25, 0.3)))
    cam = Camera.pinhole(size, size, fov_y_deg=50.0,
                         position=(0.0, 0.6, 0.0), target=(0.0, -0.3, 4.0))
    return scene, cam, RenderSettings(shadows=True)


def config3_sdf(size=1024):
    """Config 3: a smooth-union blob and a Mandelbulb over an analytic
    floor, soft shadows and AO."""
    scene = Scene()
    blob = smooth_union(
        Sphere(center=(-0.9, -0.35, 3.2), radius=0.55),
        smooth_union(Sphere(center=(-0.35, 0.25, 3.1), radius=0.4),
                     Box(center=(-0.7, -0.05, 3.4),
                         half_extents=(0.45, 0.3, 0.3)), 0.25), 0.3)
    scene.add(blob, Material.blinn_phong(albedo=(0.3, 0.7, 0.5),
                                         shininess=32), engine="sdf")
    scene.add(Mandelbulb(center=(1.0, 0.0, 3.0), scale=0.9),
              Material.lambert(albedo=(0.85, 0.6, 0.3)))
    scene.add(Plane(normal=(0.0, 1.0, 0.0), offset=-1.0),
              Material.lambert(albedo=(0.5, 0.5, 0.55)))
    scene.add_light(PointLight(position=(3.0, 4.0, -1.0),
                               color=(1.0, 0.98, 0.95)))
    cam = Camera.pinhole(size, size, fov_y_deg=45.0,
                         position=(0.0, 0.4, 0.0), target=(0.0, 0.0, 3.0))
    return scene, cam, RenderSettings(shadows=True, soft_shadows=True,
                                      ao=True, ao_samples=5)


def make_test_mesh():
    """The 128-triangle subdivided octahedron -> (vertices, faces)."""
    return octasphere(2)


def config4_mesh(width=1920, height=1080):
    """Config 4's fixture: the 128-triangle mesh over an analytic floor,
    hard shadows."""
    v, f = make_test_mesh()
    v = v * 0.9
    v[:, 2] += 3.0
    scene = Scene()
    scene.add(TriangleMesh(vertices=v, faces=f),
              Material.blinn_phong(albedo=(0.7, 0.7, 0.75), shininess=32))
    scene.add(Plane(normal=(0.0, 1.0, 0.0), offset=-1.2),
              Material.lambert(albedo=(0.45, 0.5, 0.45)))
    scene.add_light(PointLight(position=(3.0, 4.0, -1.0)))
    cam = Camera.pinhole(width, height, fov_y_deg=40.0,
                         position=(0.0, 0.5, 0.0), target=(0.0, 0.0, 3.0))
    return scene, cam, RenderSettings(shadows=True)


def crowd64(size=256):
    """64 SDF spheres on a jittered grid and a floor, one light, hard
    shadows, `vector_objects` on: the crowd row of the performance gate
    (65 objects; the tape walker takes at most 64)."""
    scene = Scene()
    rng = np.random.RandomState(7)
    for i in range(64):
        c = (float(i % 6 - 2.5), float(i // 6 - 2.0), 4.0 + float(rng.rand()))
        scene.add(Sphere(center=c, radius=0.3),
                  Material.lambert((0.2 + 0.02 * i, 0.5, 0.8)), engine="sdf")
    scene.add(Plane(normal=(0.0, 1.0, 0.0), offset=-2.5),
              Material.lambert((0.5, 0.5, 0.5)))
    scene.add_light(PointLight(position=(3.0, 5.0, -1.0),
                               color=(1.0, 1.0, 1.0)))
    cam = Camera.pinhole(size, size, 45.0, position=(0.0, 0.0, -2.0),
                         target=(0.0, 0.0, 4.0))
    return scene, cam, RenderSettings(shadows=True, max_steps=96,
                                      vector_objects=True)


def c5_orbit_poses(animation: dict, frames: int):
    """`frames` poses evenly around configs/c5_anim.yaml's orbit (its
    `animation:` block: radius, height, centre), frame i at angle
    2 pi i / frames -> (R_flats (F, 9), positions (F, 3)), float32 numpy."""
    center = np.asarray(animation.get("center", (0, 0, 0)), np.float32)
    radius = torch.tensor(float(animation.get("radius", 4.0)))
    height = torch.tensor(float(animation.get("height", -1.0)))
    Rs, ts = [], []
    for i in range(frames):
        th = torch.tensor(np.float32(2.0 * np.pi * i / frames))
        R, t = orbit_pose(radius, height, th)
        Rs.append(R.numpy().astype(np.float32).reshape(9))
        ts.append(t.numpy().astype(np.float32) + center)
    return np.stack(Rs), np.stack(ts)
