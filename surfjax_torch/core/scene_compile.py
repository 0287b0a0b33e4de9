"""Scene compiler: Python scene graph -> static SceneIR + float32 tables.

The numpy compiler of `surfjax/core/scene_compile.py`, over this package's
own `api` types, producing the same structures:
  * SceneIR -- the static structure (tuples of ints, hashable); CSG trees
    are post-order node tapes;
  * params  -- a dict of float32 tables (leaf parameter rows, smooth-k
    table, materials, lights, ambient) plus, per triangle mesh i, the
    `mesh{i}_*` arrays of engines/mesh.build_grid (int32 for faces and the
    CSR grid).

`from_reference` carries a scene frozen by surfjax across unchanged.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from surfjax_torch import api
from surfjax_torch.api import (
    Box, CSG, DirectionalLight, Mandelbulb, Plane, PointLight, Scene,
    SceneNode, Sphere, TriangleMesh,
    OP_LEAF, OP_SMOOTH_SUBTRACT, OP_SUBTRACT, SMOOTH_OPS as _SMOOTH,
)

# Leaf kinds
LEAF_SPHERE = 0
LEAF_PLANE = 1
LEAF_BOX = 2
LEAF_MANDELBULB = 3

# Engines
ENGINE_ANALYTIC = 0
ENGINE_SDF = 1
ENGINE_MESH = 2

# Light kinds
LIGHT_POINT = 0
LIGHT_DIRECTIONAL = 1

LEAF_PARAM_W = 8     # leaf_params row width
MAT_PARAM_W = 9      # albedo3, ka, kd, ks, spec3
LIGHT_PARAM_W = 7    # pos/dir3, color3, radius


class LeafIR(NamedTuple):
    kind: int
    slot: int          # global row in params["leaf_params"]
    sign: int          # +1 / -1: normal orientation parity under SUBTRACT
    p0: int            # static int param (mandelbulb power)
    p1: int            # static int param (mandelbulb iterations)


class NodeIR(NamedTuple):
    op: int
    a: int             # child node index (object-local post-order, < self)
    b: int
    leaf: int          # object-local leaf index when op == OP_LEAF, else -1
    pslot: int         # global row in params["node_params"] (smooth k), -1


class ObjectIR(NamedTuple):
    engine: int
    nodes: Tuple[NodeIR, ...]    # post-order; root is last
    leaves: Tuple[LeafIR, ...]
    mat: int                     # row in params["materials"]
    shininess: int               # static (pow_int exponent)
    mesh: int                    # index into mesh tables, -1 if not a mesh


class SceneIR(NamedTuple):
    objects: Tuple[ObjectIR, ...]
    lights: Tuple[int, ...]      # light kinds
    n_leaves: int
    n_meshes: int


class SceneWithMeshes(NamedTuple):
    """Hashable static scene: SceneIR + per-mesh static grid descriptors
    (engines/mesh.MeshStatic)."""
    ir: SceneIR
    mesh_static: Tuple


def _node_needs_sdf(node: SceneNode) -> bool:
    if isinstance(node, Mandelbulb):
        return True
    if isinstance(node, CSG):
        if node.op in _SMOOTH:
            return True
        return _node_needs_sdf(node.a) or _node_needs_sdf(node.b)
    return False


def _node_has_mesh(node: SceneNode) -> bool:
    if isinstance(node, TriangleMesh):
        return True
    if isinstance(node, CSG):
        return _node_has_mesh(node.a) or _node_has_mesh(node.b)
    return False


def _leaf_row(node: SceneNode) -> Tuple[int, np.ndarray, int, int]:
    """-> (kind, params row (LEAF_PARAM_W,), p0, p1)."""
    row = np.zeros(LEAF_PARAM_W, np.float32)
    if isinstance(node, Sphere):
        row[0:3] = node.center
        row[3] = node.radius
        return LEAF_SPHERE, row, 0, 0
    if isinstance(node, Plane):
        n = np.asarray(node.normal, np.float64)
        ln = np.sqrt(np.dot(n, n))
        n = n / ln
        row[0:3] = n.astype(np.float32)
        # normalizing the normal rescales the equation: offset / |normal|
        row[3] = np.float32(float(node.offset) / ln)
        return LEAF_PLANE, row, 0, 0
    if isinstance(node, Box):
        row[0:3] = node.center
        row[3:6] = node.half_extents
        return LEAF_BOX, row, 0, 0
    if isinstance(node, Mandelbulb):
        row[0:3] = node.center
        row[3] = node.scale
        row[4] = node.bailout
        return LEAF_MANDELBULB, row, int(node.power), int(node.iterations)
    raise TypeError(f"unknown primitive: {type(node).__name__}")


def compile_scene(scene: Scene):
    """Scene -> (SceneWithMeshes, params dict of np.float32 arrays)."""
    objects = []
    leaf_rows = []
    node_k = []
    mesh_tables = []

    for obj in scene.objects:
        node = obj.node
        m = obj.material
        if obj.engine == "mesh" or _node_has_mesh(node):
            if not isinstance(node, TriangleMesh):
                raise ValueError("TriangleMesh must be a bare scene object "
                                 "(no CSG over meshes)")
            from surfjax_torch.engines.mesh import build_grid
            objects.append((ObjectIR(ENGINE_MESH, (), (), mat=-1,
                                     shininess=int(m.shininess),
                                     mesh=len(mesh_tables)), m))
            mesh_tables.append(build_grid(node))
            continue
        if obj.engine == "sdf":
            engine = ENGINE_SDF
        elif obj.engine == "analytic":
            if _node_needs_sdf(node):
                raise ValueError("smooth ops / Mandelbulb require the SDF "
                                 "engine")
            engine = ENGINE_ANALYTIC
        else:
            engine = ENGINE_SDF if _node_needs_sdf(node) else ENGINE_ANALYTIC

        leaves: list = []
        nodes: list = []

        def walk(n: SceneNode, sign: int) -> int:
            """post-order; returns node index; appends to nodes/leaves."""
            if isinstance(n, CSG):
                ia = walk(n.a, sign)
                flip = -sign if n.op in (OP_SUBTRACT, OP_SMOOTH_SUBTRACT) \
                    else sign
                ib = walk(n.b, flip)
                pslot = -1
                if n.op in _SMOOTH:
                    pslot = len(node_k)
                    node_k.append(np.float32(n.k))
                nodes.append(NodeIR(n.op, ia, ib, -1, pslot))
                return len(nodes) - 1
            kind, row, p0, p1 = _leaf_row(n)
            slot = len(leaf_rows)
            leaf_rows.append(row)
            leaves.append(LeafIR(kind, slot, sign, p0, p1))
            nodes.append(NodeIR(OP_LEAF, -1, -1, len(leaves) - 1, -1))
            return len(nodes) - 1

        walk(node, +1)
        objects.append((ObjectIR(engine, tuple(nodes), tuple(leaves),
                                 mat=-1, shininess=int(m.shininess),
                                 mesh=-1), m))

    # material table: dedupe identical materials
    mat_list: list = []
    mat_index: Dict[api.Material, int] = {}
    final_objects = []
    for oir, m in objects:
        if m not in mat_index:
            mat_index[m] = len(mat_list)
            mat_list.append(m)
        final_objects.append(oir._replace(mat=mat_index[m]))

    materials = np.zeros((max(len(mat_list), 1), MAT_PARAM_W), np.float32)
    for i, m in enumerate(mat_list):
        materials[i, 0:3] = m.albedo
        materials[i, 3] = m.ka
        materials[i, 4] = m.kd
        materials[i, 5] = m.ks
        materials[i, 6:9] = m.specular_color

    light_kinds = []
    lights = np.zeros((max(len(scene.lights), 1), LIGHT_PARAM_W), np.float32)
    for i, l in enumerate(scene.lights):
        if isinstance(l, PointLight):
            light_kinds.append(LIGHT_POINT)
            lights[i, 0:3] = l.position
            lights[i, 3:6] = l.color
            lights[i, 6] = l.radius
        elif isinstance(l, DirectionalLight):
            light_kinds.append(LIGHT_DIRECTIONAL)
            d = np.asarray(l.direction, np.float64)
            d = d / np.sqrt(np.dot(d, d))
            lights[i, 0:3] = d.astype(np.float32)
            lights[i, 3:6] = l.color
        else:
            raise TypeError(f"unknown light: {type(l).__name__}")

    params = {
        "leaf_params": (np.stack(leaf_rows) if leaf_rows
                        else np.zeros((1, LEAF_PARAM_W), np.float32)),
        "node_params": (np.asarray(node_k, np.float32).reshape(-1, 1)
                        if node_k else np.zeros((1, 1), np.float32)),
        "materials": materials,
        "lights": lights,
        "ambient": np.asarray(scene.ambient, np.float32),
    }
    for i, tbl in enumerate(mesh_tables):
        for key, arr in tbl.arrays.items():
            params[f"mesh{i}_{key}"] = arr
    ir = SceneIR(tuple(final_objects), tuple(light_kinds),
                 n_leaves=len(leaf_rows), n_meshes=len(mesh_tables))
    return SceneWithMeshes(ir, tuple(t.static for t in mesh_tables)), params


def params_to_device(params, device) -> Dict[str, torch.Tensor]:
    """numpy tables -> tensors on `device`: integer tables (mesh faces and
    grids) as int32, everything else as float32."""
    out = {}
    for k, v in params.items():
        a = np.asarray(v)
        dt = np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32
        out[k] = torch.as_tensor(np.asarray(a, dt), device=device)
    return out


def from_reference(static, params, device="cuda"):
    """A scene frozen by surfjax -> (this package's SceneWithMeshes, dict of
    tensors on `device`: the card unless the caller asks for the CPU, as
    every entry point of the package).

    `static` is surfjax's SceneWithMeshes of namedtuples (mesh statics
    included) and `params` its dict of numpy arrays; both are read by
    field name, so surfjax itself is never imported."""
    from surfjax_torch.engines.mesh import MeshStatic
    ir = static.ir
    objects = tuple(
        ObjectIR(int(o.engine),
                 tuple(NodeIR(*map(int, nd)) for nd in o.nodes),
                 tuple(LeafIR(*map(int, lf)) for lf in o.leaves),
                 int(o.mat), int(o.shininess), int(o.mesh))
        for o in ir.objects)
    meshes = tuple(
        MeshStatic(int(ms.nx), int(ms.ny), int(ms.nz), int(ms.n_tris),
                   int(ms.len_cell_tris), int(ms.k_max),
                   tuple(float(x) for x in ms.bbox_min),
                   tuple(float(x) for x in ms.cell_size), bool(ms.smooth))
        for ms in static.mesh_static)
    port_ir = SceneIR(objects, tuple(int(k) for k in ir.lights),
                      int(ir.n_leaves), int(ir.n_meshes))
    return SceneWithMeshes(port_ir, meshes), params_to_device(params, device)
