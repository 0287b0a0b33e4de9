"""The port's golden oracles (surfjax_torch/golden/) against surfjax's, and
the port's renders against them.

  * the NumPy golden equal to surfjax's to the bit on the pinned fixture
    scenes (tests/test_fixtures.py's sizes), within those cases' ULP of
    tests/fixtures/golden_c*.npz, and render_parallel equal to render;
  * the C++ golden equal to surfjax's C++ golden to the bit (the port's
    copy also writes obj_id, checked against the NumPy golden's) and
    within tests/test_cpp_golden.py's ULP of the port's NumPy golden, on
    that file's scenes at its sizes;
  * the port's eager path (backend jnp) within 1 ULP of the golden on
    surfjax's strict cases (tests/test_parity_config1.py:28,
    tests/test_parity_configs.py:22,57,81): c1, c2, c3 without the
    Mandelbulb, c5;
  * the plain version of the fused kernel (backend pallas on the CPU)
    against the golden on c1, held to chip_smoke.py phase 20's c1 bounds.

Both packages build the same scene: tests/scenes.py's surfjax scene is
carried into the port's api types field by field (`port`).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import surfjax.api as sj_api  # noqa: E402
from surfjax.golden import cpp_bridge as sj_cpp  # noqa: E402
from surfjax.golden import renderer as sj_golden  # noqa: E402

import surfjax_torch.api as pt_api  # noqa: E402
from surfjax_torch.core.camera import Intrinsics  # noqa: E402
from surfjax_torch.core.types import RenderSettings  # noqa: E402
from surfjax_torch.golden import cpp_bridge as pt_cpp  # noqa: E402
from surfjax_torch.golden import renderer as pt_golden  # noqa: E402
from surfjax_torch.io.image import max_ulp, ulp_diff_f32  # noqa: E402
from surfjax_torch.kernels import _build  # noqa: E402

from tests.scenes import (  # noqa: E402
    config1_sphere, config2_csg, config3_sdf, config4_mesh,
    config5_anim_scene,
)
from tests.test_parity_configs import _config3_no_mandelbulb  # noqa: E402

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
_PORT_TYPES = {"Intrinsics": Intrinsics, "RenderSettings": RenderSettings}


def port(x):
    """A surfjax scene, camera, settings or scene node -> the same in the
    port's types, field by field."""
    if isinstance(x, tuple) and x and isinstance(x[0], sj_api.Scene):
        return tuple(port(v) for v in x)
    if isinstance(x, sj_api.Scene):
        scene = pt_api.Scene()
        for obj in x.objects:
            scene.add(port(obj.node), port(obj.material), obj.engine)
        for light in x.lights:
            scene.add_light(port(light))
        scene.ambient = x.ambient
        return scene
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        name = type(x).__name__
        cls = _PORT_TYPES.get(name) or getattr(pt_api, name)
        return cls(**{f.name: port(getattr(x, f.name))
                      for f in dataclasses.fields(x)})
    return x


def assert_bitwise(a, b, keys=None):
    for k in keys or b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# tests/test_fixtures.py's cases: (name, scene, kwargs, ULP to the pinned
# frame)
FIXTURES = [
    ("c1", config1_sphere, {"size": 64}, 0),
    ("c2", config2_csg, {"size": 64}, 0),
    ("c3", config3_sdf, {"size": 64}, 2),
    ("c4", config4_mesh, {"width": 96, "height": 54}, 0),
]


@pytest.fixture(scope="module")
def fixture_frames():
    """name -> (surfjax's NumPy golden frame, the port's), rendered once."""
    out = {}
    for name, mk, kw, _ in FIXTURES:
        sj = mk(**kw)
        out[name] = (sj_golden.render(*sj), pt_golden.render(*port(sj)))
    return out


@pytest.mark.parametrize("name", [c[0] for c in FIXTURES])
def test_numpy_golden_bitwise_equal_to_surfjax(fixture_frames, name):
    ref, got = fixture_frames[name]
    assert sorted(got) == sorted(ref)
    assert_bitwise(got, ref)
    assert 0.05 < float(got["hit"].mean()) <= 1.0


@pytest.mark.parametrize("name,ulp", [(c[0], c[3]) for c in FIXTURES])
def test_numpy_golden_matches_pinned_fixture(fixture_frames, name, ulp):
    """hit equal, rgb within the case's ULP of the pinned frame (c3's
    2: the trig-free bulb's log, as in tests/test_fixtures.py)."""
    _, got = fixture_frames[name]
    with np.load(os.path.join(FIXDIR, f"golden_{name}.npz")) as z:
        np.testing.assert_array_equal(got["hit"], z["hit"])
        assert max_ulp(got["rgb"], z["rgb"]) <= ulp


def test_render_parallel_bitwise_equal_to_render():
    """Row blocks on threads with global row indices: the same per-lane
    arithmetic as one render, so equal to the bit (c2 at 64: 8 blocks)."""
    scene, cam, st = port(config2_csg(size=64))
    a = pt_golden.render(scene, cam, st)
    b = pt_golden.render_parallel(scene, cam, st, n_workers=4)
    assert_bitwise(b, a)


def _area_light_scene(api):
    scene = api.Scene()
    scene.add(api.Sphere(center=(0.0, 0.6, 3.0), radius=0.5),
              api.Material.lambert(albedo=(0.7, 0.4, 0.4)), engine="sdf")
    scene.add(api.Plane(normal=(0.0, 1.0, 0.0), offset=-1.0),
              api.Material.lambert(albedo=(0.5, 0.5, 0.5)))
    scene.add_light(api.PointLight(position=(0.0, 5.0, 3.0), radius=0.6))
    cam = api.Camera.pinhole(96, 72, fov_y_deg=45.0,
                             position=(0.0, 1.0, 0.0), target=(0.0, 0.0, 3.0))
    return scene, cam, api.RenderSettings(shadows=True, soft_shadows=True)


def _mesh_occluder_scene(api):
    from surfjax.meshgen import octasphere
    v, f = octasphere(2)
    v = v * 0.5
    v[:, 1] += 0.8
    v[:, 2] += 3.0
    scene = api.Scene()
    scene.add(api.TriangleMesh(vertices=v, faces=f),
              api.Material.lambert(albedo=(0.7, 0.7, 0.75)))
    scene.add(api.Sphere(center=(2.0, 0.0, 3.0), radius=0.3),
              api.Material.lambert(albedo=(0.4, 0.6, 0.4)), engine="sdf")
    scene.add(api.Plane(normal=(0.0, 1.0, 0.0), offset=-1.0),
              api.Material.lambert(albedo=(0.5, 0.5, 0.5)))
    scene.add_light(api.PointLight(position=(0.0, 6.0, 3.0)))
    cam = api.Camera.pinhole(96, 72, fov_y_deg=45.0,
                             position=(0.0, 1.0, 0.0), target=(0.0, 0.0, 3.0))
    return scene, cam, api.RenderSettings(shadows=True, soft_shadows=True)


def _fd_normals_scene(api):
    scene = api.Scene()
    scene.add(api.Sphere(center=(0.0, 0.0, 3.0), radius=1.0),
              api.Material.blinn_phong(albedo=(0.6, 0.5, 0.4), shininess=16))
    scene.add_light(api.PointLight(position=(3.0, 4.0, -1.0)))
    cam = api.Camera.pinhole(64, 64, fov_y_deg=45.0)
    return scene, cam, api.RenderSettings(shadows=False, normals="fd")


def _crowd():
    from tests.test_crowd import _crowd_scene
    return _crowd_scene(n_spheres=9, n_boxes=4, shadows=True, ao=True)


# tests/test_cpp_golden.py's scenes at its sizes
CPP_CASES = [
    ("c1", lambda: config1_sphere(size=96)),
    ("c2", lambda: config2_csg(size=96)),
    ("c3_no_bulb", lambda: _config3_no_mandelbulb(64)),
    ("c4", lambda: config4_mesh(width=96, height=54)),
    ("area_light", lambda: _area_light_scene(sj_api)),
    ("mesh_soft", lambda: _mesh_occluder_scene(sj_api)),
    ("fd_normals", lambda: _fd_normals_scene(sj_api)),
    ("crowd", _crowd),
]


@pytest.mark.parametrize("name,make", CPP_CASES,
                         ids=[c[0] for c in CPP_CASES])
def test_cpp_golden(name, make):
    """The port's C++ golden: rgb, depth, normal and hit bitwise equal to
    surfjax's C++ golden; against the port's NumPy golden hit and obj_id
    equal, rgb, depth and normal within 1 ULP (0 measured on every case;
    tests/test_cpp_golden.py allows surfjax's pair 4 ULP on the area
    light, the mesh occluder and the FD normals)."""
    sj = make()
    scene, cam, st = port(sj)
    got = pt_cpp.render(scene, cam, st)
    assert_bitwise(got, sj_cpp.render(*sj))
    ref = pt_golden.render(scene, cam, st)
    np.testing.assert_array_equal(got["hit"], ref["hit"])
    np.testing.assert_array_equal(got["obj_id"], ref["obj_id"])
    for field in ("rgb", "depth", "normal"):
        assert max_ulp(got[field], ref[field]) <= 1, field
    assert 0.05 < float(got["hit"].mean()) <= 1.0


def test_cpp_golden_builds_under_build_named_by_its_source():
    path = pt_cpp.library_path()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libgolden_")
    assert pt_cpp.build() == path and os.path.exists(path)


# surfjax's strict cases against the golden, at 96 px
STRICT = [
    ("c1", lambda: config1_sphere(size=96)),
    ("c2", lambda: config2_csg(size=96)),
    ("c3_no_bulb", lambda: _config3_no_mandelbulb(96)),
    ("c5", lambda: (lambda s, c, st: (s, c, st.with_(max_steps=128)))(
        *config5_anim_scene(size=96))),
]


@pytest.mark.parametrize("name,make", STRICT, ids=[c[0] for c in STRICT])
def test_eager_path_within_one_ulp_of_golden(name, make):
    """backend jnp on the CPU rounds every op on its own in the golden's
    order: hit and obj_id equal, rgb, depth and normal within 1 ULP."""
    scene, cam, st = port(make())
    gold = pt_golden.render(scene, cam, st)
    fb = pt_api.render(scene, cam, st.with_(backend="jnp"), device="cpu")
    np.testing.assert_array_equal(fb.hit.numpy(), gold["hit"])
    np.testing.assert_array_equal(fb.obj_id.numpy(), gold["obj_id"])
    for field in ("rgb", "depth", "normal"):
        m = max_ulp(getattr(fb, field).numpy(), gold[field])
        assert m <= 1, f"{name} {field} differs by {m} ULP"
    assert float(gold["hit"].mean()) > 0.05


def test_fused_plain_version_against_golden_c1():
    """c1 at 64 through the fused kernel's plain version (backend pallas
    on the CPU) against the C++ golden, held to chip_smoke.py phase 20's
    c1 bounds (tests/test_parity_config1.py:43-52): hit equal, rgb within
    5e-4, more than half of the rgb values within 1 ULP."""
    scene, cam, st = port(config1_sphere(size=64))
    gold = pt_cpp.render(scene, cam, st)
    fb = pt_api.render(scene, cam, st.with_(backend="pallas"), device="cpu")
    np.testing.assert_array_equal(fb.hit.numpy(), gold["hit"])
    rgb = fb.rgb.numpy()
    assert np.abs(rgb.astype(np.float64) - gold["rgb"]).max() <= 5e-4
    assert (ulp_diff_f32(rgb, gold["rgb"]) <= 1).mean() > 0.5
