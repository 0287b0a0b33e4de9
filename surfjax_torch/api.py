"""User-facing scene / camera / material API.

The same classes and builders as `surfjax/api.py`; `render` and
`render_sequence` take a `device=` argument and return tensors on it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union as TUnion

from surfjax_torch.core.camera import IDENTITY3, Intrinsics, Mat3, look_at
from surfjax_torch.core.types import FrameBuffers, RenderSettings

Vec3f = Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class Material:
    """Phong-family material. Lambert == ks = 0. shininess is a static
    integer (evaluated by repeated squaring)."""
    albedo: Vec3f = (0.8, 0.8, 0.8)
    ka: float = 0.1
    kd: float = 0.9
    ks: float = 0.0
    shininess: int = 32
    specular_color: Vec3f = (1.0, 1.0, 1.0)

    @staticmethod
    def lambert(albedo: Vec3f = (0.8, 0.8, 0.8), ka: float = 0.1,
                kd: float = 0.9) -> "Material":
        return Material(albedo=albedo, ka=ka, kd=kd, ks=0.0)

    @staticmethod
    def blinn_phong(albedo: Vec3f = (0.8, 0.8, 0.8), ka: float = 0.1,
                    kd: float = 0.7, ks: float = 0.3, shininess: int = 32,
                    specular_color: Vec3f = (1.0, 1.0, 1.0)) -> "Material":
        return Material(albedo=albedo, ka=ka, kd=kd, ks=ks,
                        shininess=int(shininess),
                        specular_color=specular_color)


@dataclasses.dataclass(frozen=True)
class PointLight:
    position: Vec3f
    color: Vec3f = (1.0, 1.0, 1.0)
    radius: float = 0.0    # >0 enables area soft shadows (k = dist/radius)


@dataclasses.dataclass(frozen=True)
class DirectionalLight:
    direction: Vec3f       # direction the light *travels* (world space)
    color: Vec3f = (1.0, 1.0, 1.0)


Light = TUnion[PointLight, DirectionalLight]


class SceneNode:
    """Base for primitive leaves and CSG combinator nodes."""


@dataclasses.dataclass(frozen=True)
class Sphere(SceneNode):
    center: Vec3f
    radius: float


@dataclasses.dataclass(frozen=True)
class Plane(SceneNode):
    """Halfspace dot(normal, p) <= offset (solid below the normal)."""
    normal: Vec3f
    offset: float = 0.0


@dataclasses.dataclass(frozen=True)
class Box(SceneNode):
    """Axis-aligned box, center + half extents."""
    center: Vec3f
    half_extents: Vec3f


@dataclasses.dataclass(frozen=True)
class Mandelbulb(SceneNode):
    """Power-n Mandelbulb distance-estimator fractal (SDF engine only)."""
    center: Vec3f = (0.0, 0.0, 0.0)
    scale: float = 1.0
    power: int = 8
    iterations: int = 8
    bailout: float = 2.0


@dataclasses.dataclass(frozen=True)
class TriangleMesh(SceneNode):
    """Triangle mesh, intersected by the packet kernel (kernels/mesh_tile)
    on the pallas backend and by the grid DDA (engines/mesh) on the jnp
    backend. vertices: (V, 3) float array-like; faces: (F, 3) int
    array-like; grid_res None sizes the grid from the triangle count."""
    vertices: object
    faces: object
    grid_res: Optional[Tuple[int, int, int]] = None
    smooth: bool = True

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


OP_LEAF = 0
OP_UNION = 1
OP_INTERSECT = 2
OP_SUBTRACT = 3
OP_SMOOTH_UNION = 4
OP_SMOOTH_INTERSECT = 5
OP_SMOOTH_SUBTRACT = 6
SMOOTH_OPS = (OP_SMOOTH_UNION, OP_SMOOTH_INTERSECT, OP_SMOOTH_SUBTRACT)


@dataclasses.dataclass(frozen=True)
class CSG(SceneNode):
    op: int
    a: SceneNode
    b: SceneNode
    k: float = 0.0         # smoothing radius for smooth_* ops


def union(a: SceneNode, b: SceneNode, *rest: SceneNode) -> CSG:
    node = CSG(OP_UNION, a, b)
    for r in rest:
        node = CSG(OP_UNION, node, r)
    return node


def intersect(a: SceneNode, b: SceneNode) -> CSG:
    return CSG(OP_INTERSECT, a, b)


def subtract(a: SceneNode, b: SceneNode) -> CSG:
    """A minus B."""
    return CSG(OP_SUBTRACT, a, b)


def smooth_union(a: SceneNode, b: SceneNode, k: float) -> CSG:
    return CSG(OP_SMOOTH_UNION, a, b, k=float(k))


def smooth_intersect(a: SceneNode, b: SceneNode, k: float) -> CSG:
    return CSG(OP_SMOOTH_INTERSECT, a, b, k=float(k))


def smooth_subtract(a: SceneNode, b: SceneNode, k: float) -> CSG:
    return CSG(OP_SMOOTH_SUBTRACT, a, b, k=float(k))


@dataclasses.dataclass(frozen=True)
class SceneObject:
    node: SceneNode
    material: Material
    engine: Optional[str] = None  # None=auto | "analytic" | "sdf" | "mesh"


class Scene:
    def __init__(self):
        self.objects: List[SceneObject] = []
        self.lights: List[Light] = []
        self.ambient: Vec3f = (1.0, 1.0, 1.0)
        self._frozen = None

    def add(self, node: SceneNode, material: Optional[Material] = None,
            engine: Optional[str] = None) -> "Scene":
        self.objects.append(SceneObject(node, material or Material.lambert(),
                                        engine))
        self._frozen = None
        return self

    def add_light(self, light: Light) -> "Scene":
        self.lights.append(light)
        self._frozen = None
        return self

    @staticmethod
    def csg_union(a: SceneNode, b: SceneNode, *rest: SceneNode) -> CSG:
        return union(a, b, *rest)

    @staticmethod
    def csg_intersect(a: SceneNode, b: SceneNode) -> CSG:
        return intersect(a, b)

    @staticmethod
    def csg_subtract(a: SceneNode, b: SceneNode) -> CSG:
        return subtract(a, b)

    def freeze(self):
        """Compile to (SceneWithMeshes static, params dict of numpy
        float32 arrays); memoized until the scene is mutated."""
        if self._frozen is None:
            from surfjax_torch.core.scene_compile import compile_scene
            self._frozen = compile_scene(self)
        return self._frozen


@dataclasses.dataclass(frozen=True)
class Camera:
    intrinsics: Intrinsics
    rotation: Mat3 = IDENTITY3          # world_from_cam
    position: Vec3f = (0.0, 0.0, 0.0)

    @staticmethod
    def pinhole(width: int, height: int, fov_y_deg: float = 45.0,
                position: Vec3f = (0.0, 0.0, 0.0),
                target: Optional[Vec3f] = None,
                up: Vec3f = (0.0, 1.0, 0.0)) -> "Camera":
        intr = Intrinsics.from_fov(width, height, fov_y_deg)
        if target is None:
            return Camera(intr, IDENTITY3, position)
        R, t = look_at(position, target, up)
        return Camera(intr, R, t)

    @staticmethod
    def from_intrinsics(width: int, height: int, fx: float, fy: float,
                        cx: float, cy: float,
                        rotation: Mat3 = IDENTITY3,
                        position: Vec3f = (0.0, 0.0, 0.0)) -> "Camera":
        return Camera(Intrinsics(width, height, fx, fy, cx, cy),
                      rotation, position)


def render(scene: Scene, camera: Camera,
           settings: RenderSettings = RenderSettings(),
           device="cuda") -> FrameBuffers:
    """Render one frame on `device` (the card unless the caller asks for
    "cpu"); tensors come back on that device."""
    from surfjax_torch.pipeline.frame import render_frame
    return render_frame(scene, camera, settings, device=device)


def render_sequence(scene: Scene, camera: Camera, poses,
                    settings: RenderSettings = RenderSettings(),
                    device="cuda") -> FrameBuffers:
    """Render a batch of frames on `device` (the card unless the caller
    asks for "cpu").

    poses: (R_flats (F, 9), positions (F, 3)) world_from_cam poses."""
    from surfjax_torch.pipeline.frame import render_sequence as _rs
    return _rs(scene, camera, poses, settings, device=device)
