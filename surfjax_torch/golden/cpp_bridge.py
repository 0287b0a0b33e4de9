"""ctypes bridge to the C++ golden renderer (`cpp/golden.cpp`).

Builds the source with g++ and strict FP flags (-fno-fast-math
-ffp-contract=off) at first use and exposes `render(scene, camera,
settings)` with the output dict of `golden.renderer.render`. The scene
arrives as the flat tables this package's `core/scene_compile.py` emits;
the C++ math is an implementation of its own. It runs on the host's
threads (SJ_GOLDEN_THREADS, else one per core), never on the card.

The library goes to `build/surfjax_torch/` at the root of the checkout,
beside the CUDA kernels' library, named by a hash of the source and the
flags and written to a per-process temp file that is renamed into place,
so concurrent processes never load a partial file. A missing g++ or a
failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict

import numpy as np

from surfjax_torch.core.scene_compile import ENGINE_MESH, compile_scene
from surfjax_torch.kernels._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp",
                    "golden.cpp")
FLAGS = ("-O2", "-fno-fast-math", "-ffp-contract=off", "-pthread",
         "-shared", "-fPIC")


def library_path() -> str:
    h = hashlib.sha256(repr(FLAGS).encode())
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libgolden_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it is already built -> its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the C++ golden is built from "
                           "source at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *FLAGS, "-o", tmp, _SRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _load():
    lib = ctypes.CDLL(build())
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.sj_golden_render.argtypes = [
        f32p, i32p, i32p, ctypes.c_int, i32p, i32p, f32p, f32p, f32p,
        f32p, i32p, ctypes.c_int, f32p, f32p, i32p, i32p,
        f32p, f32p, f32p, f32p, i32p,
    ]
    lib.sj_golden_render.restype = None
    return lib


def render(scene, camera, settings) -> Dict[str, np.ndarray]:
    """-> {"rgb", "depth", "normal", "hit", "obj_id"} as numpy arrays of
    the frame's shape, as `golden.renderer.render` returns them."""
    static, params = compile_scene(scene)
    ir = static.ir

    # mesh pools (vertex indices offset per mesh)
    mesh_verts = []
    mesh_vnorm = []
    mesh_faces = []
    mesh_obj_rows = []
    v_off = 0
    f_off = 0
    mesh_face_ranges = {}
    for mi in range(ir.n_meshes):
        verts = params[f"mesh{mi}_verts"]
        vnorm = params[f"mesh{mi}_vert_n"]
        faces = params[f"mesh{mi}_faces"]
        mesh_verts.append(np.asarray(verts, np.float32))
        mesh_vnorm.append(np.asarray(vnorm, np.float32))
        mesh_faces.append(np.asarray(faces, np.int32) + v_off)
        mesh_face_ranges[mi] = (f_off, faces.shape[0])
        v_off += verts.shape[0]
        f_off += faces.shape[0]

    objs = []
    nodes = []
    leaf_meta = []
    leaf_rows = []
    node_off = 0
    for o in ir.objects:
        leaf_off = len(leaf_meta)
        objs.append([o.engine, node_off, len(o.nodes), leaf_off,
                     len(o.leaves), o.mat, o.shininess])
        if o.engine == ENGINE_MESH:
            off, cnt = mesh_face_ranges[o.mesh]
            smooth = int(static.mesh_static[o.mesh].smooth)
            mesh_obj_rows.append([off, cnt, smooth])
        else:
            mesh_obj_rows.append([0, 0, 0])
        for nd in o.nodes:
            nodes.append([nd.op, nd.a, nd.b, nd.leaf, max(nd.pslot, 0)])
        for lf in o.leaves:
            leaf_meta.append([lf.kind, lf.sign, lf.p0, lf.p1])
            leaf_rows.append(params["leaf_params"][lf.slot])
        node_off += len(o.nodes)

    intr = camera.intrinsics
    R = np.asarray(camera.rotation, np.float32).reshape(9)
    pos = np.asarray(camera.position, np.float32)
    headerf = np.asarray(
        [intr.fx, intr.fy, intr.cx, intr.cy, *R, *pos,
         settings.t_min, settings.t_max, settings.hit_eps,
         settings.hit_eps_scale,
         settings.normal_eps, settings.shadow_eps,
         settings.soft_shadow_k, settings.soft_shadow_tmin,
         settings.ao_radius, settings.ao_strength,
         *settings.background, *scene.ambient], np.float32)
    headeri = np.asarray(
        [intr.width, intr.height, settings.max_steps, settings.shadow_steps,
         settings.ao_samples, int(settings.shadows),
         int(settings.soft_shadows), int(settings.ao),
         int(settings.normals == "fd"),
         int(settings.bulb_log == "portable")], np.int32)

    n = intr.width * intr.height
    out_rgb = np.zeros(3 * n, np.float32)
    out_depth = np.zeros(n, np.float32)
    out_normal = np.zeros(3 * n, np.float32)
    out_hit = np.zeros(n, np.float32)
    out_obj = np.zeros(n, np.int32)

    light_kinds = np.asarray(list(ir.lights) or [0], np.int32)
    _load().sj_golden_render(
        headerf, headeri,
        np.asarray(objs, np.int32).reshape(-1),
        len(objs),
        np.asarray(nodes, np.int32).reshape(-1),
        np.asarray(leaf_meta, np.int32).reshape(-1),
        (np.stack(leaf_rows).astype(np.float32).reshape(-1)
         if leaf_rows else np.zeros(8, np.float32)),
        params["node_params"].astype(np.float32).reshape(-1),
        params["materials"].astype(np.float32).reshape(-1),
        params["lights"].astype(np.float32).reshape(-1),
        light_kinds, len(ir.lights),
        (np.concatenate(mesh_verts).reshape(-1) if mesh_verts
         else np.zeros(3, np.float32)),
        (np.concatenate(mesh_vnorm).reshape(-1) if mesh_vnorm
         else np.zeros(3, np.float32)),
        (np.concatenate(mesh_faces).reshape(-1).astype(np.int32)
         if mesh_faces else np.zeros(3, np.int32)),
        np.asarray(mesh_obj_rows, np.int32).reshape(-1),
        out_rgb, out_depth, out_normal, out_hit, out_obj)

    H, W = intr.height, intr.width
    return {
        "rgb": out_rgb.reshape(H, W, 3),
        "depth": out_depth.reshape(H, W),
        "normal": out_normal.reshape(H, W, 3),
        "hit": out_hit.reshape(H, W),
        "obj_id": out_obj.reshape(H, W),
    }
