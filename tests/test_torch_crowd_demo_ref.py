"""The port's crowd path against the benchmark's plain reference, on the
CPU at a small size.

`api.render_sequence` with `vector_objects` (KF's plain twin with the
crowd's member loops, what `kf_frame_kernel<true>` equals bitwise on the
card) renders two frames jittered from a seed; the plain reference
(`portbench/reference/golden.py`, plain PyTorch, nothing of the port)
renders the same rays in float32, and `portbench.check.numbers` compares
all five buffers:

  * crowd_demo as the benchmark runs it (`portbench/configs/crowd_demo.json`
    through `portbench.port.build` and `portbench.reference.scene`: 48
    members in 36 two-leaf CSG pairs of all six ops and 12 spheres, a
    plane, a point and a directional light, hard shadows, AO), at 64x36;
  * a seeded random crowd (`tools/workload.crowd_scene`: analytic spheres
    and boxes beside SDF spheres, with random SDF pairs of all six ops
    added, and a directional light beside its point light), at 48x36;

and the same reference in bfloat16, put in the program's place, fails the
tolerances.

    python -m pytest tests/test_torch_crowd_demo_ref.py -q
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench import check, port  # noqa: E402
from portbench.reference import golden  # noqa: E402
from portbench.reference import scene as rs  # noqa: E402
from surfjax_torch import api  # noqa: E402
from surfjax_torch.kernels import render_tile as rt  # noqa: E402
from surfjax_torch.tools import workload  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2300000000041
BUFFERS = ("rgb", "depth", "normal", "hit", "obj_id")

# The program's gap to the reference is the fused march's, as on c3 (the
# golden oracles' finding): KF marches the SDF members over-relaxed
# (over_relax 1.4) from their bounding spheres and stops within hit_eps of
# the surface, where the reference's plain sphere trace stops elsewhere
# within hit_eps. Readings (crowd_demo on four seeds; the random crowd): no
# hit or id differs, rgb 4.1-4.6e-5 and 1.8e-5, depth 6.4-6.7e-6 and
# 5.5e-6, normals 7.1-8.9e-5 and 3.8e-5. The bfloat16 reference reads rgb
# 0.15-0.27 and 4.8e-2, ids 7.9-8.5% and 11.2%, depth 3.3e-3 and 9.3e-3,
# normals 1.4-2.3e-3 and 2.4e-2, and 2.3-4.0% of its pixels not finite.
TOLERANCES = {
    # exact: neither side may leave a NaN or an infinity in any buffer
    "nonfinite_share": 0.0,
    # a silhouette pixel whose ray grazes a member can miss on one side
    # and hit on the other where the two marches stop apart: at most one
    # pixel in 500
    "hit_mismatch": 2e-3,
    "id_mismatch": 2e-3,
    # the hit points within hit_eps of each other shift the Blinn-Phong
    # terms, the shadow rays' origins and AO's probes: over 20x the readings
    "rgb_abs_mean": 1e-3,
    # |t - t_ref| <= hit_eps per pixel (1e-3 over depths of 2-10), and
    # most pixels are the plane's, found in closed form on both sides
    "depth_err_mean": 1e-4,
    # finite-difference normals (normal_eps 5e-4) taken at those points
    "normal_abs_mean": 1e-3,
}


def _flat(t, n):
    """A buffer -> (n, 3) for rgb and normal, (n,) for the others."""
    a = t.float().numpy()
    return a.reshape(n, 3) if a.size == 3 * n else a.reshape(n)


def _reference(cfg_scene, settings, intr, R, P, dtype):
    """The reference's five buffers at every pixel of the frames (R, P),
    flat as check.numbers takes them."""
    F, H, W = P.shape[0], intr.height, intr.width
    f, rows, cols = (g.reshape(-1) for g in torch.meshgrid(
        torch.arange(F), torch.arange(H), torch.arange(W), indexing="ij"))
    o, d = golden.camera_rays(intr, torch.as_tensor(R), torch.as_tensor(P),
                              f, rows, cols, dtype)
    with torch.no_grad():
        out = golden.render_rays(cfg_scene, settings, o, d, dtype)
    return {k: _flat(out[k], F * H * W) for k in BUFFERS}


def _program(scene, camera, st, R, P):
    fb = api.render_sequence(scene, camera, (R, P), st, device="cpu")
    return {k: _flat(getattr(fb, k), fb.hit.numel()) for k in BUFFERS}


def _poses(R_flat, position, seed):
    rng = np.random.default_rng(seed)
    P = (np.asarray(position, np.float64)[None]
         + rng.uniform(-1e-2, 1e-2, (2, 3))).astype(np.float32)
    return np.repeat(np.asarray(R_flat, np.float32).reshape(1, 9), 2, 0), P


def _crowd_demo():
    """crowd_demo as the benchmark builds it for both sides, at 64x36 ->
    (program scene, camera, settings, reference scene, its settings,
    intrinsics, R, P)."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           "crowd_demo.json")) as fh:
        cfg = json.load(fh)
    cfg["camera"].update(width=64, height=36)
    intr = rs.intrinsics_of(cfg)
    R0, p0 = rs.camera_pose(cfg)
    scene, camera, st, _ = port.build(cfg, {}, intr, R0)
    R, P = _poses(R0, p0, SEED)
    return (scene, camera, st, rs.scene_of(cfg), rs.settings_of(cfg), intr,
            R, P)


def _ref_node(n) -> dict:
    """An api node -> the configuration schema's dict."""
    if isinstance(n, api.Sphere):
        return {"type": "sphere", "center": list(n.center),
                "radius": n.radius}
    if isinstance(n, api.Box):
        return {"type": "box", "center": list(n.center),
                "half_extents": list(n.half_extents)}
    if isinstance(n, api.Plane):
        return {"type": "plane", "normal": list(n.normal),
                "offset": n.offset}
    ops = {api.OP_UNION: "union", api.OP_INTERSECT: "intersect",
           api.OP_SUBTRACT: "subtract", api.OP_SMOOTH_UNION: "smooth_union",
           api.OP_SMOOTH_INTERSECT: "smooth_intersect",
           api.OP_SMOOTH_SUBTRACT: "smooth_subtract"}
    return {"type": ops[n.op], "a": _ref_node(n.a), "b": _ref_node(n.b),
            "k": n.k}


def _random_crowd():
    """workload.crowd_scene's analytic members beside SDF spheres, six
    random SDF pairs (one of each op, as workload.pair_scene makes them)
    and a directional light, at 48x36 -> as _crowd_demo."""
    scene, cam, st = workload.crowd_scene(
        api, n_spheres=6, n_boxes=3, engine=None, n_sdf_spheres=4,
        size=(48, 36), seed=SEED)
    rng = np.random.default_rng([SEED, 1])
    S, B = api.Sphere, api.Box
    for k in range(6):
        c = tuple(float(x) for x in (rng.uniform(-1.6, 1.6),
                                     rng.uniform(-0.5, 1.0),
                                     rng.uniform(2.4, 4.2)))
        a = S(center=c, radius=float(rng.uniform(0.15, 0.3)))
        b = B(center=(c[0] + 0.2, c[1] + 0.1, c[2]), half_extents=tuple(
            float(x) for x in rng.uniform(0.08, 0.2, 3)))
        inner = S(center=(c[0] + 0.1, c[1], c[2]), radius=0.22)
        carve = S(center=(c[0] + 0.12, c[1] + 0.08, c[2]), radius=0.15)
        kk = float(rng.uniform(0.08, 0.25))
        node = (api.union(a, b), api.intersect(a, inner),
                api.subtract(a, carve), api.smooth_union(a, b, kk),
                api.smooth_intersect(a, inner, kk),
                api.smooth_subtract(a, carve, kk))[k]
        scene.add(node, api.Material.blinn_phong(
            albedo=(0.3, 0.6, 0.8), shininess=16), engine="sdf")
    scene.add_light(api.DirectionalLight(direction=(-0.3, -1.0, 0.4),
                                         color=(0.2, 0.2, 0.25)))
    st = st.with_(ao=True, vector_objects=True)
    crowd = rt.split_crowd(scene.freeze()[0], st)[0]
    assert crowd is not None and len(crowd.members) == 19
    assert len(crowd.pair_specs) >= 4 and crowd.n_sph_ana > 0
    cfg = {"objects": [
        {"node": _ref_node(o.node), "engine": o.engine,
         "material": dict(dataclasses.asdict(o.material),
                          type="blinn_phong")}
        for o in scene.objects],
        "lights": [{"type": "point", "position": list(lt.position),
                    "color": list(lt.color), "radius": lt.radius}
                   if isinstance(lt, api.PointLight) else
                   {"type": "directional", "direction": list(lt.direction),
                    "color": list(lt.color)} for lt in scene.lights],
        "settings": dataclasses.asdict(st)}
    R0 = np.asarray(cam.rotation, np.float32).reshape(9)
    R, P = _poses(R0, cam.position, SEED + 1)
    return (scene, cam, st, rs.scene_of(cfg), rs.settings_of(cfg),
            cam.intrinsics, R, P)


CASES = {"crowd_demo": _crowd_demo, "random crowd": _random_crowd}


@pytest.mark.parametrize("case", list(CASES))
def test_crowd_path_matches_the_plain_reference(case):
    scene, camera, st, ref_scene, ref_st, intr, R, P = CASES[case]()
    assert st.vector_objects and rt.launches_crowd(scene.freeze()[0], st)
    prog = _program(scene, camera, st, R, P)
    ref = _reference(ref_scene, ref_st, intr, R, P, torch.float32)
    assert prog["hit"].mean() > 0.3
    nums = check.numbers(prog, ref)
    judged = check.judge(nums, TOLERANCES)
    assert all(j["ok"] for j in judged.values()), judged


def test_bfloat16_reference_fails_the_tolerances():
    """The control: the reference in bfloat16 in the program's place."""
    _, _, _, ref_scene, ref_st, intr, R, P = _crowd_demo()
    ref = _reference(ref_scene, ref_st, intr, R, P, torch.float32)
    low = _reference(ref_scene, ref_st, intr, R, P, torch.bfloat16)
    judged = check.judge(check.numbers(low, ref), TOLERANCES)
    failed = sorted(k for k, j in judged.items() if not j["ok"])
    assert {"rgb_abs_mean", "depth_err_mean", "id_mismatch"} <= set(failed)
