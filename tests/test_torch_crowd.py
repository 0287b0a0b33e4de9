"""The port's crowd loops (settings.vector_objects) on the CPU, where the
wrappers run the plain versions.

  (a) membership: the port's `split_crowd` and `crowd_meta` equal surfjax's
      row for row on every tested scene, and `from_reference` carries what
      the crowd reads;
  (b) crowd on against crowd off inside the port: depth, normal, hit and
      obj_id bitwise equal, rgb within 2 ULP (surfjax's own bound; the port
      rounds every op alone, so 0 was measured everywhere);
  (c) the port against surfjax with the crowd on (its Pallas kernels in
      interpret mode), on the fused and the split path: hits and object ids
      equal, depth within 1e-4 * max(1, t), rgb within 2e-4, normals within
      5e-4 (the jit tolerances of tests/test_torch_pipeline.py: the gap is
      XLA:CPU's fused arithmetic); soft penumbra edges get the wider rgb
      bound stated with the test;
  (f) crowds of 64 and 256 members load and render, with the crowd and
      without it.

Scenes are those of tests/test_crowd.py, built for either package by
surfjax_torch/tools/workload.py from seeded numpy generators. Sizes are
128x96 and below, tile_rows 8, max_steps <= 96.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import surfjax.api as sj_api  # noqa: E402
import surfjax.config as sj_config  # noqa: E402
from surfjax.kernels import render_tile as sj_rt  # noqa: E402

import surfjax_torch.api as pt_api  # noqa: E402
import surfjax_torch.config as pt_config  # noqa: E402
from surfjax_torch.core.scene_compile import from_reference  # noqa: E402
from surfjax_torch.kernels import render_tile as pt_rt  # noqa: E402
from surfjax_torch.tools import workload  # noqa: E402

from tests.test_torch_pipeline import CONFIG_DIR, gaps  # noqa: E402

CASES = tuple(workload.crowd_cases(pt_api))
SMALL = (64, 48)


def _ulp(a, b):
    """Distance in float32 representable values between two tensors."""
    def key(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (key(a) - key(b)).abs()


def _assert_on_equals_off(on, off):
    for name in ("depth", "normal", "hit", "obj_id"):
        assert torch.equal(getattr(on, name), getattr(off, name)), name
    assert int(_ulp(on.rgb, off.rgb).max()) <= 2


def _ineligible_scene(api):
    """A three-leaf tape and an analytic pair stay outside the crowd; an
    SDF subtract pair and a single sphere join it."""
    S = api.Sphere
    scene = api.Scene()
    lam = api.Material.lambert()
    scene.add(api.union(api.subtract(S(center=(0, 0, 3), radius=0.4),
                                     S(center=(0.2, 0, 3), radius=0.3)),
                        S(center=(0.5, 0, 3), radius=0.2)), lam, engine="sdf")
    scene.add(api.subtract(S(center=(1, 0, 3), radius=0.3),
                           S(center=(1.1, 0, 3), radius=0.2)), lam,
              engine="sdf")
    scene.add(api.union(S(center=(-1, 0, 3), radius=0.3),
                        S(center=(-0.8, 0, 3), radius=0.2)), lam)
    scene.add(S(center=(0, 1, 3), radius=0.3), lam, engine="sdf")
    return scene


def _membership_scene(api, name):
    if name == "ineligible shapes":
        return _ineligible_scene(api)
    if name == "crowd_demo":
        mod = sj_config if api is sj_api else pt_config
        return mod.load_config(f"{CONFIG_DIR}/crowd_demo.yaml")[0]
    return workload.crowd_cases(api)[name][0]


@pytest.mark.parametrize("name", CASES + ("ineligible shapes", "crowd_demo"))
def test_crowd_membership_equals_reference(name):
    """split_crowd and crowd_meta of the port, on the scene compiled by
    the port and on surfjax's frozen scene carried across, against
    surfjax's: the same members in the same sections, the same meta rows."""
    static, params = _membership_scene(sj_api, name).freeze()
    sj_st = sj_api.RenderSettings(vector_objects=True)
    ref_crowd, ref_ana, ref_sdf = sj_rt.split_crowd(static, sj_st)
    ref_meta = sj_rt._crowd_meta_cached(static, sj_st)
    pt_st = pt_api.RenderSettings(vector_objects=True)
    own_static, _ = _membership_scene(pt_api, name).freeze()
    for pstatic in (from_reference(static, params, device="cpu")[0],
                    own_static):
        crowd, rest_ana, rest_sdf = pt_rt.split_crowd(pstatic, pt_st)
        assert [i for i, _ in crowd.members] == \
            [i for i, _ in ref_crowd.members]
        assert crowd[1:] == tuple(ref_crowd[1:])
        assert [i for i, _ in rest_ana] == [i for i, _ in ref_ana]
        assert [i for i, _ in rest_sdf] == [i for i, _ in ref_sdf]
        meta = pt_rt.crowd_meta(pstatic, pt_st)
        assert meta.dtype == np.int32
        np.testing.assert_array_equal(meta, ref_meta)
        off = pt_rt.crowd_meta(pstatic, pt_api.RenderSettings())
        np.testing.assert_array_equal(off, np.zeros((1, 6), np.int32))
    if name == "pairs all ops":
        assert len({sp[2] for sp in ref_crowd.pair_specs}) == 6
    if name == "crowd_demo":
        assert len(ref_crowd.members) == 48 and len(ref_ana) == 1


def test_crowd_needs_two_members_and_the_flag():
    scene = pt_api.Scene()
    scene.add(pt_api.Sphere(center=(0, 0, 3), radius=0.4), engine="sdf")
    static, _ = scene.freeze()
    on = pt_api.RenderSettings(vector_objects=True)
    assert pt_rt.split_crowd(static, on)[0] is None
    static, _ = workload.crowd_cases(pt_api)["crowd soft"][0].freeze()
    assert pt_rt.split_crowd(static, on)[0] is not None
    crowd, ana, sdf = pt_rt.split_crowd(static, pt_api.RenderSettings())
    assert crowd is None and len(ana) == 1 and len(sdf) == 13


@pytest.mark.parametrize("name", CASES)
def test_crowd_on_equals_crowd_off(name):
    scene, cam, st = workload.crowd_cases(pt_api)[name]
    on = pt_api.render(scene, cam, st.with_(vector_objects=True),
                       device="cpu")
    off = pt_api.render(scene, cam, st, device="cpu")
    _assert_on_equals_off(on, off)
    assert float(on.hit.mean()) > 0.1
    assert len(torch.unique(on.obj_id)) > 5
    if name == "crowd + mesh":   # the mesh is in view: the split path ran
        assert int((on.obj_id == len(scene.objects) - 1).sum()) > 10


def test_crowd_sequence_on_equals_off_and_frames():
    """A 3-frame fused sequence with singles and a smooth pair: the crowd
    changes nothing, and each frame equals render() of its camera."""
    scene, cam, st = workload.crowd_scene(pt_api, n_spheres=5, n_boxes=2,
                                          size=SMALL, shadows=True)
    scene.add(pt_api.smooth_union(
        pt_api.Sphere(center=(0.6, 0.9, 3.4), radius=0.22),
        pt_api.Sphere(center=(0.85, 0.9, 3.4), radius=0.18), 0.12),
        pt_api.Material.lambert(albedo=(0.4, 0.7, 0.4)), engine="sdf")
    Rs, ps = workload.poses(cam, 3, np.random.default_rng(3).normal(
        0.0, 0.05, (3, 3)))
    on = pt_api.render_sequence(scene, cam, (Rs, ps),
                                st.with_(vector_objects=True), device="cpu")
    off = pt_api.render_sequence(scene, cam, (Rs, ps), st, device="cpu")
    _assert_on_equals_off(on, off)
    single = pt_api.render(scene, dataclasses.replace(
        cam, position=tuple(float(x) for x in ps[2])),
        st.with_(vector_objects=True), device="cpu")
    for a, b in zip(single, on):
        assert torch.equal(a, b[2])
    assert not torch.equal(on.depth[0], on.depth[2])


@pytest.mark.parametrize("name", ["crowd hard+ao", "pairs all ops",
                                  "analytic members", "crowd + mesh",
                                  "crowd soft", "analytic members soft"])
def test_crowd_matches_reference_pallas(name):
    """The port's crowd render (fused path; split path for the mesh case)
    against surfjax's pallas render with vector_objects on, at 64x48.
    Hits and obj_id are equal everywhere and depth is within 1e-4 *
    max(1, t) (measured 1.7e-5). With hard shadows rgb is within 2e-4
    (measured 1.5e-4) and normals within 5e-4 (measured 3.5e-4). With soft
    shadows a few pixels on penumbra edges move further (measured: rgb
    9.2e-4 and 1.1e-3 at most, two lanes above 1e-3; XLA:CPU's fused
    arithmetic in the penumbra march, as on the split path's scene), so
    rgb is held to q99 <= 2e-4, 5e-3 at most and at most 4 lanes above
    1e-3."""
    sj_scene, sj_cam, sj_st = workload.crowd_cases(sj_api, SMALL)[name]
    pt_scene, pt_cam, pt_st = workload.crowd_cases(pt_api, SMALL)[name]
    ref = sj_api.render(sj_scene, sj_cam, sj_st.with_(vector_objects=True))
    got = pt_api.render(pt_scene, pt_cam, pt_st.with_(vector_objects=True),
                        device="cpu")
    g = gaps(ref, got)
    assert g["hit_agree"] == 1.0 and g["obj_agree"] == 1.0, g
    assert g["depth_rel_max"] <= 1e-4 and g["normal_max"] <= 5e-4, g
    if pt_st.soft_shadows:
        assert g["rgb_q99"] <= 2e-4 and g["rgb_max"] <= 5e-3, g
        assert g["lanes_rgb_gt_1e-3"] <= 4, g
    else:
        assert g["rgb_max"] <= 2e-4, g
    assert float(got.hit.mean()) > 0.1


def test_crowd_demo_config_renders_through_the_cli(tmp_path, capsys):
    """`python -m surfjax_torch render` on configs/crowd_demo.yaml (the
    yaml sets vector_objects), its camera shrunk to 48x32 in a copy."""
    import yaml
    from surfjax_torch.__main__ import main
    with open(f"{CONFIG_DIR}/crowd_demo.yaml") as fh:
        cfg = yaml.safe_load(fh)
    assert cfg["settings"]["vector_objects"] is True
    cfg["camera"].update(width=48, height=32)
    path = tmp_path / "crowd_small.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = tmp_path / "crowd.png"
    main(["render", "--config", str(path), "--backend", "pallas",
          "--device", "cpu", "--out", str(out)])
    assert "rendered 48x32" in capsys.readouterr().out
    assert out.stat().st_size > 500


@pytest.mark.parametrize("n_members", [64, 256])
def test_large_crowds_load_and_render(n_members):
    """More members than the kernels' former 64-object limit: the crowd
    renders them, and without the crowd the same scene renders too, each
    object on its own (the warning still points at vector_objects), with
    the crowd's geometry and rgb within 2 ULP."""
    scene, cam, st = workload.sphere_crowd(pt_api, n_members)
    fb = pt_api.render(scene, cam, st.with_(vector_objects=True),
                       device="cpu")
    assert float(fb.hit.mean()) > 0.3
    assert len(torch.unique(fb.obj_id)) > 40
    with pytest.warns(RuntimeWarning, match="crowd-eligible"):
        off = pt_api.render(scene, cam, st, device="cpu")
    _assert_on_equals_off(fb, off)


def test_crowd_tables_for_the_kernels():
    """pack_scene with a crowd: members leave the per-object march orders,
    each object row names its member row, and each crowd row carries the
    member's type and tag behind crowd_meta's six columns."""
    scene, _, st = workload.crowd_cases(pt_api)["pairs all ops"]
    static, _ = scene.freeze()
    on = st.with_(vector_objects=True)
    crowd, rest_ana, rest_sdf = pt_rt.split_crowd(static, on)
    objects, _, _, order, _, rows, counts = pt_rt.pack_scene(static, on)
    n_ana, n_sdf, n_crowd, sdf_end, single_end = counts
    assert (n_ana, n_sdf) == (len(rest_ana), len(rest_sdf)) == (1, 1)
    assert n_crowd == len(crowd.members) == 10
    assert sdf_end == single_end == crowd.n_singles == 3
    assert len(order) == 2 * (n_ana + n_sdf)
    members = [i for i, _ in crowd.members]
    assert not set(order) & set(members)
    assert [int(objects[i, 10]) for i in members] == list(range(n_crowd))
    assert rows.shape == (n_crowd, pt_rt.CROWD_W)
    np.testing.assert_array_equal(rows[:, :6], pt_rt.crowd_meta(static, on))
    assert rows[:3, 6].tolist() == [pt_rt.CROWD_SDF] * 3
    assert rows[3:, 6].tolist() == [pt_rt.CROWD_PAIR] * 7
    assert sorted({int(t) >> 2 for t in rows[3:, 7]}) == [1, 2, 3, 4, 5, 6]
    off = pt_rt.pack_scene(static, st)
    assert off[-1][:3] == (1, 11, 0) and (off[0][:, 10] == -1).all()


def test_soft_crowd_at_128_matches_reference_but_one_pixel():
    """`analytic members soft` at 128x96 (ROADMAP queue 3 item 2): the
    port against surfjax's pallas render is within the 64x48 bounds but on
    one pixel (57, 120), where it differs by 0.248 in rgb. There surfjax's
    two backends disagree: its jnp backend shades the pixel 0.0502 (the
    receiver lies in a sphere's umbra: the light ray passes 0.014 from its
    centre, radius 0.15), its pallas backend 0.298; the port agrees with the
    jnp backend. Measured: rgb q99 1.2e-5, one lane above 1e-3."""
    sj_scene, sj_cam, sj_st = workload.crowd_cases(
        sj_api, (128, 96))["analytic members soft"]
    pt_scene, pt_cam, pt_st = workload.crowd_cases(
        pt_api, (128, 96))["analytic members soft"]
    ref = sj_api.render(sj_scene, sj_cam, sj_st.with_(vector_objects=True))
    got = pt_api.render(pt_scene, pt_cam, pt_st.with_(vector_objects=True),
                        device="cpu")
    g = gaps(ref, got)
    assert g["hit_agree"] == 1.0 and g["obj_agree"] == 1.0, g
    assert g["rgb_q99"] <= 2e-4 and g["lanes_rgb_gt_1e-3"] <= 1, g
    d = np.abs(got.rgb.numpy() - np.asarray(ref.rgb)).max(axis=-1)
    i, j = np.unravel_index(int(d.argmax()), d.shape)
    assert (int(i), int(j)) == (57, 120)
    jnp_ref = sj_api.render(sj_scene, sj_cam, sj_st.with_(backend="jnp"))
    assert float(np.abs(got.rgb.numpy()[i, j]
                        - np.asarray(jnp_ref.rgb)[i, j]).max()) < 1e-3
    assert float(np.abs(np.asarray(ref.rgb)[i, j]
                        - np.asarray(jnp_ref.rgb)[i, j]).max()) > 0.2
