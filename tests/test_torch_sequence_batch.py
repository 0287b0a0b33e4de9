"""The batched sequence: `render_sequence` with backend="pallas" renders a
mesh, capped or primed camera path in passes of whole frames, each pass
launching every kernel once over all its frames (render_tile.
render_sequence_pallas, _render_pass), and a shard's frames the same way
(parallel/mesh.render_sequence_shard). On the CPU the wrappers run their
plain versions.

  (a) every buffer of the sequence bitwise equal to each frame rendered
      alone by render(), with render_tile.PASS_RAYS set to one frame, two
      frames (a pass ending inside the sequence) and every frame: a mesh
      beside an SDF sphere with AO and soft shadows (64x48 x 3), a crowd
      beside a mesh (64x36 x 2), the same mesh scene capped (march_cap 24,
      shadow_march_cap 12; 64x48 x 2) and primed c3 (96x96 x 2);
  (b) the kernel calls of each such run: per pass one K1 call, one
      mesh_tile call per mesh for the primary rays and one per mesh and
      light, ao_fix and K2 as often as for one frame; a primed mesh-free
      pass one prime_tile and one frame_fused call;
  (c) the primed sequence against surfjax's render_sequence (its vmapped
      frames, interpret mode) within the c3 carve-out (c4's batched split
      path against it: tests/test_torch_sequence_batch_ref.py);
  (d) each rank's batched shard of a simulated world of 1 and of 3 ranks
      bitwise equal to its frames' shards rendered one by one;
  (e) on the card (marked `cuda`): c4 at 256x192 x 4, every frame bitwise
      equal to render() and K1 launched once.
Besides: mesh_candidates taken in groups of tiles equals one group.

surfjax (and jax) are imported inside the test that compares with it, so
the card's machine runs (e) with `python -m pytest --noconftest -m cuda
tests/test_torch_sequence_batch.py`.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from surfjax_torch import api  # noqa: E402
from surfjax_torch.config import load_config  # noqa: E402
from surfjax_torch.core.scene_compile import params_to_device  # noqa: E402
from surfjax_torch.core.types import FrameBuffers  # noqa: E402
from surfjax_torch.kernels import mesh_tile as mt  # noqa: E402
from surfjax_torch.kernels import render_tile as rt  # noqa: E402
from surfjax_torch.meshgen import octasphere  # noqa: E402
from surfjax_torch.parallel.mesh import (  # noqa: E402
    render_frame_shard, render_sequence_shard,
)
from surfjax_torch.tools import workload  # noqa: E402
from surfjax_torch.tools.kernel_check import capture_calls  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C3 = os.path.join(ROOT, "configs", "c3_sdf.yaml")
CPU = torch.device("cpu")


def _case(name):
    """-> (scene, camera, settings, pose arrays) of a case, its frames
    jittered with numpy from a seed."""
    if name == "crowd + mesh":
        scene, cam, st = workload.crowd_cases(api, (64, 36))[name]
        st, n = st.with_(vector_objects=True, tile_rows=8), 2
    elif name == "primed c3":
        scene, cam, st, _ = load_config(C3)
        cam = workload.reframe(cam, 96, 96)
        st, n = st.with_(backend="pallas", prime=True, prime_min=64), 2
    else:
        scene, cam, st = workload.mesh_soft_ao_scene(api, 64)
        cam = workload.reframe(cam, 64, 48)
        st, n = st.with_(tile_rows=8), 3
        if name == "capped":
            st, n = st.with_(march_cap=24, shadow_march_cap=12), 2
    jitter = np.random.default_rng(7).normal(0.0, 0.02, (n, 3))
    return scene, cam, st, workload.poses(cam, n, jitter)


CASES = ("mesh_soft_ao", "crowd + mesh", "capped", "primed c3")
# (case, frames per pass): one, two and every frame of each case
RUNS = [(c, p) for c in CASES for p in (1, 2, 3)
        if p <= (3 if c == "mesh_soft_ao" else 2)]


@functools.lru_cache(maxsize=None)
def _alone(name):
    """Each frame of the case rendered alone by render()."""
    scene, cam, st, (Rs, ps) = _case(name)
    return [api.render(scene, dataclasses.replace(
        cam, position=tuple(float(x) for x in p)), st, device="cpu")
        for p in ps]


@functools.lru_cache(maxsize=None)
def _batched(name, per):
    """render_sequence of the case with PASS_RAYS at `per` frames -> (its
    buffers, the names of its recorded kernel calls, its frame_fused
    calls)."""
    scene, cam, st, poses = _case(name)
    limit = rt.PASS_RAYS
    fused = rt.frame_fused
    kf_calls = []

    def counted(*args, **kw):
        kf_calls.append(args)
        return fused(*args, **kw)

    rt.PASS_RAYS = per * rt.pass_rays(scene.freeze()[0], cam.intrinsics, st)
    rt.frame_fused = counted
    try:
        with capture_calls() as calls:
            fb = api.render_sequence(scene, cam, poses, st, device="cpu")
    finally:
        rt.PASS_RAYS, rt.frame_fused = limit, fused
    return fb, [c[0] for c in calls], len(kf_calls)


def _assert_bitwise(got, ref, label):
    for field, a, b in zip(FrameBuffers._fields, got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, (label, field)
        assert torch.equal(a, b), (label, field)


@pytest.mark.parametrize("name, per", RUNS)
def test_batched_sequence_equals_frames_alone(name, per):
    """(a) Every buffer of every frame bitwise equal to render() of that
    frame, whatever the pass size."""
    fb, _, _ = _batched(name, per)
    alone = _alone(name)
    assert fb.rgb.shape[0] == len(alone)
    for f, single in enumerate(alone):
        _assert_bitwise([a[f] for a in fb], single, f"{name} frame {f}")
    assert 0.3 < float(fb.hit.mean()) < 0.95
    assert float((fb.depth[0] - fb.depth[-1]).abs().max()) > 1e-4


def _calls_of_pass(scene, cam, st):
    """The recorded kernel calls of one pass, in order: the priming call
    where it applies; then K1 (and its residual re-run under a cap), the
    candidates and the mesh kernel per mesh, ao_fix where AO meets a mesh
    and another object, and per light K2 (and its re-run) and the
    candidates and the mesh kernel per mesh; none more for a mesh-free
    scene, which takes KF."""
    static = scene.freeze()[0]
    names = ["prime_tile"] * rt.prime_applies(static, cam.intrinsics, st)
    if rt.fused_frame_ok(static, st):
        return names
    meshes = len(rt._split(static)[2])
    names += ["render_tile"] + ["render_tile_redo"] * bool(st.march_cap)
    names += ["mesh_candidates", "mesh_tile"] * meshes
    if st.ao and meshes and len(static.ir.objects) > meshes:
        names.append("ao_fix")
    for _ in static.ir.lights:
        names += ["trace_rays"] + ["trace_rays_redo"] * bool(
            st.shadow_march_cap) + ["mesh_candidates", "mesh_tile"] * meshes
    return names


@pytest.mark.parametrize("name, per", RUNS)
def test_kernel_calls_per_pass(name, per):
    """(b) The calls of a run are one pass's calls once per pass, not per
    frame: one K1 call, the mesh kernel once per mesh for the primary rays
    and once per mesh and light, ao_fix and K2 as for a single frame; a
    primed mesh-free pass one prime_tile and one frame_fused call."""
    scene, cam, st, (Rs, _) = _case(name)
    passes = -(-Rs.shape[0] // per)
    _, names, kf = _batched(name, per)
    one = _calls_of_pass(scene, cam, st)
    assert names == one * passes, names
    assert names.count("render_tile") == passes * (name != "primed c3")
    fused = rt.fused_frame_ok(scene.freeze()[0], st)
    assert kf == passes * fused
    if name == "primed c3":
        assert one == ["prime_tile"]
    else:
        assert names.count("mesh_tile") == passes * (1 + len(scene.lights))


def test_primed_sequence_matches_surfjax():
    """(c) The primed c3 sequence at 96x96 x 2 against surfjax's
    render_sequence (its frames vmapped in one program, interpret mode on
    the CPU): per frame hits agree on more than 99.5% of the pixels and
    the rgb difference has q99 below 5e-2 (the c3 carve-out of
    tests/test_torch_prime.py)."""
    import surfjax.config as sj_config
    from surfjax.pipeline.frame import render_sequence as sj_rs

    from tests.test_torch_pipeline import gaps
    _, cam, st, poses = _case("primed c3")
    sj_scene, _, sj_st, _ = sj_config.load_config(C3)
    ref = sj_rs(sj_scene, cam, poses, sj_st.with_(
        backend="pallas", prime=True, prime_min=64))
    got, _, _ = _batched("primed c3", 2)
    for f in range(2):
        g = gaps([np.asarray(a)[f] for a in ref], [a[f] for a in got])
        assert g["hit_agree"] > 0.995 and g["rgb_q99"] < 5e-2, (f, g)


@pytest.mark.parametrize("per", [1, 3])
@pytest.mark.parametrize("count", [1, 3])
def test_sequence_shard_equals_frame_shards(count, per):
    """(d) Each rank of a simulated world of `count` ranks ((1, count):
    every frame's rays over 'tile'): its batched shard of three frames,
    with PASS_RAYS at one frame and at every frame, bitwise equal to its
    frames' shards rendered one by one. 50x41 = 2050 rays: each frame's
    block (2050 and 684 rays) ends inside a tile and is padded on its
    own."""
    scene, cam, st = workload.mesh_soft_ao_scene(api, 64)
    cam = workload.reframe(cam, 50, 41)
    st = st.with_(tile_rows=8)
    Rs, ps = (torch.as_tensor(a) for a in workload.poses(
        cam, 3, np.random.default_rng(8).normal(0.0, 0.02, (3, 3))))
    static, params = scene.freeze()
    params = params_to_device(params, CPU)
    intr = cam.intrinsics
    n_pad = -(-2050 // count)
    n_pad = -(-n_pad // (8 * rt.LANES)) * 8 * rt.LANES
    limit = rt.PASS_RAYS
    rt.PASS_RAYS = per * n_pad
    try:
        with torch.no_grad(), capture_calls() as calls:
            got = [render_sequence_shard(static, st, params, intr, Rs, ps,
                                         (0, r), (1, count))
                   for r in range(count)]
    finally:
        rt.PASS_RAYS = limit
    k1 = [c[0] for c in calls].count("render_tile")
    assert k1 == count * -(-3 // per)
    for r in range(count):
        with torch.no_grad():
            ref = [render_frame_shard(static, st, params, intr, Rs[f], ps[f],
                                      r, count) for f in range(3)]
        _assert_bitwise(got[r], [torch.stack(p) for p in zip(*ref)],
                        f"rank {r} of {count}")


def test_mesh_candidates_in_groups_of_tiles():
    """mesh_candidates with CAND_ENTRIES at three tiles' worth (a group
    ending inside the batch) equals it in one group, bitwise."""
    v, f = octasphere(3)
    scene = api.Scene().add(api.TriangleMesh(
        vertices=v * np.float32(0.8) + np.float32([0.0, 0.0, 3.0]),
        faces=f))
    static, params = scene.freeze()
    ms, tri = static.mesh_static[0], torch.as_tensor(
        params["mesh0_tri_packed"])
    rng = np.random.default_rng(9)
    ang = rng.uniform(-0.4, 0.4, (2, 20, 128)).astype(np.float32)
    d = [np.sin(ang[0]), np.sin(ang[1])]
    d.append(np.sqrt(1.0 - d[0] * d[0] - d[1] * d[1]))
    d = tuple(torch.as_tensor(c.astype(np.float32)) for c in d)
    o = tuple(torch.zeros(20, 128) for _ in range(3))
    whole = mt.mesh_candidates(ms, tri, o, d, 1e-3, 1e4, 2)
    limit = mt.CAND_ENTRIES
    mt.CAND_ENTRIES = 3 * tri.shape[0]
    try:
        grouped = mt.mesh_candidates(ms, tri, o, d, 1e-3, 1e4, 2)
    finally:
        mt.CAND_ENTRIES = limit
    assert whole[0].shape == (10, mt.PACKET_K)
    assert int(whole[1].max()) > 0
    for a, b in zip(whole, grouped):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_c4_sequence_on_the_card():
    """(e) c4 at 256x192 x 4 on the card: one pass, K1 launched once and
    the mesh kernel once for the primary rays and once for the light, and
    every frame bitwise equal to render() of that frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    scene, cam, st, _ = load_config(os.path.join(ROOT, "configs",
                                                 "c4_mesh.yaml"))
    cam = workload.reframe(cam, 256, 192)
    st = st.with_(backend="pallas")
    Rs, ps = workload.poses(cam, 4, np.random.default_rng(10).normal(
        0.0, 0.02, (4, 3)))
    wrappers = (rt.render_tile, mt.mesh_tile, rt.frame_fused)
    before = [w.launches for w in wrappers]
    fb = api.render_sequence(scene, cam, (Rs, ps), st, device=dev)
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1, 2, 0]
    for f in range(4):
        single = api.render(scene, dataclasses.replace(
            cam, position=tuple(float(x) for x in ps[f])), st, device=dev)
        _assert_bitwise([a[f] for a in fb], single, f"c4 frame {f}")
