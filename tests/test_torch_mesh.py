"""The port's mesh engine (meshgen, grid build, grid DDA, barycentric
normals), its mesh scene compilation, and its eager (jnp) pipeline on mesh
scenes, against surfjax.

Inputs come from numpy seeds; the jnp-path comparisons run surfjax as its
own tests do (jit on the CPU). Tolerances: hit masks equal and t within
1e-5 relative for the DDA (tests/test_mesh.py holds surfjax's DDA to
brute force the same way); whole frames within the bounds
tests/test_mesh.py holds surfjax to against its golden oracle (hits agree
on more than 99.9% of pixels, rgb and normals within 1e-3).
"""

import os
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import surfjax.api as sj_api  # noqa: E402
import surfjax.config as sj_config  # noqa: E402
from surfjax.engines import mesh as sj_mesh  # noqa: E402
from surfjax.meshgen import octasphere as sj_octasphere  # noqa: E402

import surfjax_torch.api as pt_api  # noqa: E402
import surfjax_torch.config as pt_config  # noqa: E402
from surfjax_torch.core.scene_compile import from_reference  # noqa: E402
from surfjax_torch.engines import mesh as pt_mesh  # noqa: E402
from surfjax_torch.meshgen import octasphere  # noqa: E402
from surfjax_torch.tools.workload import (  # noqa: E402
    mesh_soft_ao_scene, two_mesh_scene,
)

from tests.test_torch_pipeline import gaps, load_pair  # noqa: E402

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "configs")


def _fixture_mesh(subdivisions=2, scale=0.8, z=3.0):
    v, f = octasphere(subdivisions)
    return v * np.float32(scale) + np.asarray([0.0, 0.0, z], np.float32), f


def _rays(n, seed, spread=0.35):
    """n rays from the origin into a cone around +z, as numpy float32."""
    ang = np.random.default_rng(seed).uniform(-spread, spread, (2, n))
    dx = np.sin(ang[0]).astype(np.float32)
    dy = np.sin(ang[1]).astype(np.float32)
    dz = np.sqrt(1.0 - dx * dx - dy * dy).astype(np.float32)
    return [np.zeros(n, np.float32)] * 3, [dx, dy, dz]


@pytest.mark.parametrize("subdivisions", [0, 1, 2, 3])
def test_octasphere_matches_reference(subdivisions):
    for got, ref in zip(octasphere(subdivisions),
                        sj_octasphere(subdivisions)):
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()


def _c4_mesh(module):
    scene = module.load_config(os.path.join(CONFIG_DIR, "c4_mesh.yaml"))[0]
    return scene.objects[0].node


@pytest.mark.parametrize("which", ["octasphere3", "c4"])
def test_build_grid_matches_reference(which):
    """The numpy binning gives surfjax's CSR (its C++ builder) bit for
    bit, and every other table and the MeshStatic with it."""
    if which == "c4":
        got = pt_mesh.build_grid(_c4_mesh(pt_config))
        ref = sj_mesh.build_grid(_c4_mesh(sj_config))
    else:
        v, f = _fixture_mesh(3)
        got = pt_mesh.build_grid(pt_api.TriangleMesh(vertices=v, faces=f))
        ref = sj_mesh.build_grid(sj_api.TriangleMesh(vertices=v, faces=f))
    assert got.static == ref.static
    assert sorted(got.arrays) == sorted(ref.arrays)
    for key, a in ref.arrays.items():
        b = got.arrays[key]
        assert b.dtype == a.dtype and b.shape == a.shape, key
        assert b.tobytes() == a.tobytes(), key


def _dda_pair(v, f, o, d, t_min=1e-3, t_max=1e4):
    """The DDA of both packages on the same rays -> (t_port, tri_port,
    t_ref, tri_ref) as numpy."""
    ref_static, ref_params = sj_api.Scene().add(
        sj_api.TriangleMesh(vertices=v, faces=f)).freeze()
    t_r, tri_r = sj_mesh.intersect_mesh(
        ref_static.mesh_static[0], 0,
        {k: jnp.asarray(a) for k, a in ref_params.items()},
        tuple(jnp.asarray(c) for c in o), tuple(jnp.asarray(c) for c in d),
        t_min, t_max)
    static, params = from_reference(ref_static, ref_params, device="cpu")
    t_p, tri_p = pt_mesh.intersect_mesh(
        static.mesh_static[0], 0, params,
        tuple(torch.from_numpy(c) for c in o),
        tuple(torch.from_numpy(c) for c in d), t_min, t_max)
    return t_p.numpy(), tri_p.numpy(), np.asarray(t_r), np.asarray(tri_r)


def test_intersect_mesh_matches_reference():
    v, f = _fixture_mesh(2)
    o, d = _rays(1024, seed=1)
    t_p, tri_p, t_r, tri_r = _dda_pair(v, f, o, d)
    hit_p, hit_r = t_p < 1e29, t_r < 1e29
    np.testing.assert_array_equal(hit_p, hit_r)
    np.testing.assert_allclose(t_p[hit_p], t_r[hit_r], rtol=1e-5)
    assert 0.2 < hit_p.mean() < 1.0
    # triangle ids may differ only where two triangles share an edge
    assert (tri_p[hit_p] != tri_r[hit_r]).mean() < 0.01


def test_intersect_mesh_from_inside_and_per_ray_t_max():
    """Rays from inside the mesh (every one hits), and a per-ray t_max
    tensor that cuts half of them short (the shadow-ray form)."""
    v, f = octasphere(1)
    ang = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    o = [np.zeros(64, np.float32)] * 3
    d = [np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32),
         np.zeros(64, np.float32)]
    t_p, _, t_r, _ = _dda_pair(v, f, o, d)
    np.testing.assert_allclose(t_p, t_r, rtol=1e-5)
    assert (t_p < 2.0).all()
    t_max = np.where(np.arange(64) % 2 == 0, 0.5, 10.0).astype(np.float32)
    ref_static, ref_params = sj_api.Scene().add(
        sj_api.TriangleMesh(vertices=v, faces=f)).freeze()
    static, params = from_reference(ref_static, ref_params, device="cpu")
    t_cut, _ = pt_mesh.intersect_mesh(
        static.mesh_static[0], 0, params,
        tuple(torch.from_numpy(c) for c in o),
        tuple(torch.from_numpy(c) for c in d), 1e-3,
        torch.from_numpy(t_max))
    hit = t_cut.numpy() < 1e29
    np.testing.assert_array_equal(hit, np.arange(64) % 2 == 1)


@pytest.mark.parametrize("smooth", [True, False])
def test_mesh_normal_matches_reference(smooth):
    v, f = _fixture_mesh(2)
    o, d = _rays(512, seed=2)
    ref_static, ref_params = sj_api.Scene().add(
        sj_api.TriangleMesh(vertices=v, faces=f, smooth=smooth)).freeze()
    static, params = from_reference(ref_static, ref_params, device="cpu")
    t, tri = pt_mesh.intersect_mesh(
        static.mesh_static[0], 0, params,
        tuple(torch.from_numpy(c) for c in o),
        tuple(torch.from_numpy(c) for c in d), 1e-3, 1e4)
    hit = t < 1e29
    t = torch.where(hit, t, 0.0)
    p = [torch.from_numpy(o[k]) + t * torch.from_numpy(d[k])
         for k in range(3)]
    got = pt_mesh.mesh_normal(static.mesh_static[0], 0, params, p, tri)
    ref = sj_mesh.mesh_normal(
        ref_static.mesh_static[0], 0,
        {k: jnp.asarray(a) for k, a in ref_params.items()},
        tuple(jnp.asarray(c.numpy()) for c in p), jnp.asarray(tri.numpy()))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy()[hit.numpy()],
                                   np.asarray(b)[hit.numpy()], atol=1e-5)


def test_load_obj_matches_reference(tmp_path):
    """The port's OBJ parser against surfjax's loader: quads as fans,
    i/j/k face syntax, negative indices, a malformed short v row."""
    path = tmp_path / "mesh.obj"
    path.write_text(textwrap.dedent("""\
        # comment
        v 0.0 0.0 0.0
        v 1.0 0.0 0.0
        v 1.0 1.0 0.5
        v 0.0 1.0 0.0
        v 0.5 0.5 2.0
        f 1 2 3 4
        f 1/1 2/2 5/3
        f -3//1 -2//2 -1//3
        """))
    got = pt_config.load_obj(str(path))
    ref = sj_config.load_obj(str(path))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert got[1].shape == (4, 3)


def test_obj_mesh_node_loads_relative_to_the_config(tmp_path):
    (tmp_path / "tri.obj").write_text("v 0 0 3\nv 1 0 3\nv 0 1 3\nf 1 2 3\n")
    (tmp_path / "scene.yaml").write_text(textwrap.dedent("""\
        camera: {width: 8, height: 8, fov: 45.0}
        objects:
          - node: {type: mesh, obj: tri.obj, scale: 2.0}
        lights:
          - {type: point, position: [0.0, 2.0, 0.0]}
        """))
    got = pt_config.load_config(str(tmp_path / "scene.yaml"))[0].freeze()
    ref = sj_config.load_config(str(tmp_path / "scene.yaml"))[0].freeze()
    assert got[0] == ref[0]
    for key, a in ref[1].items():
        assert got[1][key].tobytes() == a.tobytes(), key


def _scene_pair(name, size):
    """(surfjax scene, camera, settings), (port ...), both jnp backend."""
    if name == "c4":
        (sj_s, sj_c, sj_st), (pt_s, pt_c, pt_st), _ = load_pair(
            "c4_mesh", size, n_frames=1)
        return (sj_s, sj_c, sj_st), (pt_s, pt_c, pt_st)
    build = mesh_soft_ao_scene if name == "mesh_soft_ao" else two_mesh_scene
    pairs = [build(m, size) for m in (sj_api, pt_api)]
    return tuple((s, c, st.with_(backend="jnp")) for s, c, st in pairs)


@pytest.mark.parametrize("name", ["c4", "mesh_soft_ao", "two_meshes"])
def test_jnp_path_matches_reference(name):
    """The eager pipeline against surfjax's jnp path (jit): measured at
    32x32, hits and obj_id agree on every pixel and rgb, depth and
    normals within 4e-5; asserted with the bounds of tests/test_mesh.py."""
    (sj_s, sj_c, sj_st), (pt_s, pt_c, pt_st) = _scene_pair(name, 32)
    ref = sj_api.render(sj_s, sj_c, sj_st)
    got = pt_api.render(pt_s, pt_c, pt_st, device="cpu")
    g = gaps(ref, got)
    assert g["hit_agree"] > 0.999 and g["obj_agree"] > 0.999, g
    assert g["rgb_max"] < 1e-3 and g["normal_max"] < 1e-3, g
    assert 0.2 < float(np.asarray(ref.hit).mean()), g
