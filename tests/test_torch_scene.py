"""surfjax_torch scene compilation, settings and camera against surfjax.

The port's own loader + compiler must produce exactly the static SceneIR
and the float32 tables that surfjax freezes, and `from_reference` must
carry a surfjax scene across unchanged.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import surfjax.config as sj_config  # noqa: E402
import surfjax.core.camera as sj_camera  # noqa: E402
from surfjax.core.types import RenderSettings as SjSettings  # noqa: E402
from surfjax.io.image import ulp_diff_f32  # noqa: E402

import surfjax_torch.config as pt_config  # noqa: E402
import surfjax_torch.core.camera as pt_camera  # noqa: E402
from surfjax_torch import api as pt_api  # noqa: E402
from surfjax_torch.core.scene_compile import from_reference  # noqa: E402
from surfjax_torch.core.types import RenderSettings as PtSettings  # noqa: E402

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "configs")
CONFIGS = ["c1_sphere", "c2_csg", "c3_sdf", "c3_sdf_std", "c3_sdf_portlog",
           "c5_anim", "crowd_demo"]


@pytest.mark.parametrize("name", CONFIGS)
def test_compile_matches_reference(name):
    path = os.path.join(CONFIG_DIR, name + ".yaml")
    sj_scene, sj_cam, sj_st, sj_extras = sj_config.load_config(path)
    pt_scene, pt_cam, pt_st, pt_extras = pt_config.load_config(path)
    ref_static, ref_params = sj_scene.freeze()
    static, params = pt_scene.freeze()
    carried_static, carried_params = from_reference(ref_static, ref_params,
                                                    device="cpu")

    # IR tuples: namedtuples compare as tuples, field by field
    assert static == ref_static
    assert carried_static == ref_static
    assert sorted(params) == sorted(ref_params) == sorted(carried_params)
    for key, ref in ref_params.items():
        for got in (params[key], carried_params[key].numpy()):
            assert got.dtype == np.float32 and got.shape == ref.shape, key
            assert got.tobytes() == ref.tobytes(), key
    assert dataclasses.asdict(pt_st) == dataclasses.asdict(sj_st)
    assert dataclasses.asdict(pt_cam.intrinsics) == \
        dataclasses.asdict(sj_cam.intrinsics)
    assert pt_cam.rotation == sj_cam.rotation
    assert pt_cam.position == sj_cam.position
    assert pt_extras == sj_extras


def test_crowd_demo_fused_path_raises():
    """crowd_demo keeps vector_objects on. The crowd loops are carried, so
    the fused path renders the scene through them. With march caps the
    frames take the split path (the fused path takes no caps) and its
    capped-march residual, and come out as the uncapped ones, bitwise."""
    scene, cam, st, _ = pt_config.load_config(
        os.path.join(CONFIG_DIR, "crowd_demo.yaml"))
    assert st.vector_objects
    cam = dataclasses.replace(
        cam, intrinsics=pt_camera.Intrinsics.from_fov(8, 8, 55.0))
    R = np.asarray(cam.rotation, np.float32).reshape(1, 9)
    pos = np.asarray(cam.position, np.float32).reshape(1, 3)
    fb = pt_api.render_sequence(scene, cam, (R, pos),
                                st.with_(backend="pallas"), device="cpu")
    assert fb.rgb.shape == (1, 8, 8, 3) and float(fb.hit.mean()) > 0.3
    capped = pt_api.render_sequence(
        scene, cam, (R, pos),
        st.with_(backend="pallas", march_cap=2, shadow_march_cap=2),
        device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(capped, fb))


def test_render_settings_fields_and_defaults():
    assert [f.name for f in dataclasses.fields(PtSettings)] == \
        [f.name for f in dataclasses.fields(SjSettings)]
    assert dataclasses.asdict(PtSettings()) == dataclasses.asdict(SjSettings())


def test_camera_matches_reference_within_1ulp():
    """look_at is host Python (identical); ray directions and orbit poses
    are float32 tensor arithmetic in the same association, compared to
    within 1 ULP (eager JAX ops, each rounded on its own)."""
    rng = np.random.default_rng(3)
    for _ in range(8):
        eye = tuple(rng.uniform(-3, 3, 3))
        target = tuple(rng.uniform(-3, 3, 3) + np.array([0.0, 0.0, 6.0]))
        assert pt_camera.look_at(eye, target) == sj_camera.look_at(eye, target)

    intr = pt_camera.Intrinsics.from_fov(24, 16, 50.0)
    sj_intr = sj_camera.Intrinsics.from_fov(24, 16, 50.0)
    R = rng.normal(size=9).astype(np.float32)
    rows = np.repeat(np.arange(16, dtype=np.float32), 24)
    cols = np.tile(np.arange(24, dtype=np.float32), 16)
    got = pt_camera.camera_ray_dirs_dyn(intr, torch.from_numpy(R),
                                        torch.from_numpy(rows),
                                        torch.from_numpy(cols))
    ref = sj_camera.camera_ray_dirs_dyn(sj_intr, jnp.asarray(R),
                                        jnp.asarray(rows), jnp.asarray(cols))
    for g, r in zip(got, ref):
        assert ulp_diff_f32(g.numpy(), np.asarray(r)).max() <= 1

    # orbit_pose: the eye is sin/cos of two libraries, which differ by up to
    # 1 ULP; the rotation is two normalizations later, within 2 ULP
    for theta in rng.uniform(0.0, 2.0 * np.pi, 8).astype(np.float32):
        args = (np.float32(4.0), np.float32(1.0), theta)
        R_got, eye_got = pt_camera.orbit_pose(*(torch.tensor(a) for a in args))
        R_ref, eye_ref = sj_camera.orbit_pose(*(jnp.asarray(a) for a in args))
        assert ulp_diff_f32(eye_got.numpy(), np.asarray(eye_ref)).max() <= 1
        assert ulp_diff_f32(R_got.numpy(), np.asarray(R_ref)).max() <= 2


def test_main_path_workload_matches_bench():
    """chip_smoke.py measures the workload bench.py pins: the same 1080p
    intrinsics, rotation and jittered positions to the bit, and the same
    settings apart from the backend."""
    import bench
    from surfjax_torch.tools.workload import EXACT, main_path

    path = os.path.join(CONFIG_DIR, "c3_sdf.yaml")
    scene, cam, R_flats, positions, modes = main_path(path, 48)
    _, _, _, intr, st, R_flat, ref_pos = bench.metric_workload(path)
    assert dataclasses.asdict(cam.intrinsics) == dataclasses.asdict(intr)
    assert R_flats.shape == (48, 9) and positions.shape == (48, 3)
    assert (R_flats == np.asarray(R_flat)[None, :]).all()
    assert positions.tobytes() == np.asarray(ref_pos).tobytes()
    assert len(scene.objects) == 3
    value = dataclasses.asdict(st.with_(backend="pallas"))
    assert dataclasses.asdict(modes["value"]) == value
    assert dataclasses.asdict(modes["value_exact"]) == {**value, **EXACT}


def test_port_compiles_meshes_like_reference():
    """The three mesh inputs that the port refused before it had the mesh
    engine now compile: a scene holding a TriangleMesh, c4_mesh.yaml
    through the port's loader (the generated octasphere), and a c4 scene
    frozen by surfjax carried across by from_reference. Each gives
    surfjax's SceneIR, MeshStatic and tables bit for bit (int32 for faces
    and the CSR grid)."""
    from surfjax import api as sj_api
    verts = np.array([[0, 0, 3], [1, 0, 3], [0, 1, 3]], np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    pairs = [(pt_api.Scene().add(pt_api.TriangleMesh(verts, faces)).freeze(),
              sj_api.Scene().add(sj_api.TriangleMesh(verts, faces)).freeze())]
    path = os.path.join(CONFIG_DIR, "c4_mesh.yaml")
    ref = sj_config.load_config(path)[0].freeze()
    pairs.append((pt_config.load_config(path)[0].freeze(), ref))
    static, params = from_reference(*ref, device="cpu")
    pairs.append(((static, {k: v.numpy() for k, v in params.items()}), ref))
    for (static, params), (ref_static, ref_params) in pairs:
        assert static == ref_static
        assert static.ir.n_meshes == len(static.mesh_static) == 1
        assert sorted(params) == sorted(ref_params)
        for key, a in ref_params.items():
            b = np.asarray(params[key])
            assert b.dtype == a.dtype and b.shape == a.shape, key
            assert b.tobytes() == a.tobytes(), key
    assert pairs[1][0][0].mesh_static[0].n_tris == 8192
