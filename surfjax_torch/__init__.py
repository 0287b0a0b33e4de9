"""surfjax_torch -- the PyTorch + CUDA port of surfjax.

The same scene API, settings and outputs as `surfjax`, rendered with
PyTorch tensors on the CUDA device, or on the CPU when the caller passes
device="cpu". `RenderSettings(backend="jnp")` runs the eager tensor
pipeline; `backend="pallas"` runs the kernel paths: the fused frame for
mesh-free scenes, the split pipeline with the mesh packet kernel for mesh
scenes. Each launches its hand-written CUDA kernels (kernels/csrc/) on a
CUDA device and their plain PyTorch versions on the CPU. `surfjax_torch.diff`
fits poses and SDF parameters through either backend. The package imports
torch and numpy, never jax.

Public API:
    Scene, Camera, Material, PointLight, DirectionalLight,
    Sphere, Plane, Box, Mandelbulb, TriangleMesh,
    union, intersect, subtract,
    smooth_union, smooth_intersect, smooth_subtract,
    render, render_sequence, RenderSettings, FrameBuffers
"""

from surfjax_torch.api import (
    Box,
    Camera,
    DirectionalLight,
    Mandelbulb,
    Material,
    Plane,
    PointLight,
    Scene,
    Sphere,
    TriangleMesh,
    intersect,
    render,
    render_sequence,
    smooth_intersect,
    smooth_subtract,
    smooth_union,
    subtract,
    union,
)
from surfjax_torch.core.types import FrameBuffers, RenderSettings

__all__ = [
    "Scene", "Camera", "Material", "PointLight", "DirectionalLight",
    "Sphere", "Plane", "Box", "Mandelbulb", "TriangleMesh",
    "union", "intersect", "subtract",
    "smooth_union", "smooth_intersect", "smooth_subtract",
    "render", "render_sequence", "RenderSettings", "FrameBuffers",
]
