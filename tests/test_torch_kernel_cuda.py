"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

Marked `cuda`: without a CUDA device every test here skips (the decision
is taken inside the fixture). On the card, where jax is absent and so
tests/conftest.py cannot load: `python -m pytest --noconftest -m cuda
tests/test_torch_kernel_cuda.py`.

Both sides round every float operation on its own (the kernels are built
with -fmad=false and IEEE division and sqrt), so each kernel must equal
its plain version bitwise on every buffer.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from surfjax_torch.api import render_sequence  # noqa: E402
from surfjax_torch.config import load_config  # noqa: E402
from surfjax_torch.core.camera import Intrinsics  # noqa: E402
from surfjax_torch.core.scene_compile import params_to_device  # noqa: E402
from surfjax_torch.kernels.render_tile import (  # noqa: E402
    SceneTensors, frame_fused, frame_fused_reference,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT = dict(secondary_lod_iters=0, ao_lod_iters=0, over_relax=1.0)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name, over", [
    ("c1_sphere", {}), ("c2_csg", {}), ("c5_anim", {}), ("c3_sdf", {}),
    ("c3_sdf", EXACT), ("c3_sdf_portlog", EXACT)])
def test_kernel_matches_twin_at_64(cuda_device, name, over):
    scene, cam, st, _ = load_config(os.path.join(ROOT, "configs",
                                                 name + ".yaml"))
    intr = cam.intrinsics
    fov = 2.0 * float(np.degrees(np.arctan(0.5 * intr.height / intr.fy)))
    intr = Intrinsics.from_fov(64, 64, fov)
    st = st.with_(backend="pallas", **over)
    static, params = scene.freeze()
    scene_t = SceneTensors(static, params_to_device(params, cuda_device))
    pos = np.asarray(cam.position, np.float32)[None, :] + \
        np.random.default_rng(0).normal(0, 1e-3, (2, 3)).astype(np.float32)
    R = np.repeat(np.asarray(cam.rotation, np.float32).reshape(1, 9), 2, 0)
    rows = torch.as_tensor(np.concatenate([R, pos], axis=1),
                           device=cuda_device)
    before = frame_fused.launches
    got = frame_fused(scene_t, st, intr, rows)
    torch.cuda.synchronize()
    assert frame_fused.launches == before + 1
    ref = frame_fused_reference(scene_t, st, intr, rows)
    for a, b in zip(got, ref):
        assert a.shape == (2, 64, 64)
        assert torch.equal(a, b)
    assert float(got[8].mean()) > 0.1


def test_render_sequence_on_cuda_uses_the_kernel(cuda_device):
    scene, cam, st, _ = load_config(os.path.join(ROOT, "configs",
                                                 "c5_anim.yaml"))
    R = np.asarray(cam.rotation, np.float32).reshape(1, 9)
    pos = np.asarray(cam.position, np.float32).reshape(1, 3)
    before = frame_fused.launches
    fb = render_sequence(scene, cam, (R, pos), st.with_(backend="pallas"),
                         device=cuda_device)
    assert frame_fused.launches == before + 1
    assert fb.rgb.device.type == "cuda"
    assert bool(torch.isfinite(fb.rgb).all())


# --- the split path's kernels (K1, K2, ao_fix, mesh_tile) -------------------

def _split_scene(name):
    from surfjax_torch import api
    from surfjax_torch.tools.workload import (
        mesh_modes, mesh_soft_ao_scene, two_mesh_scene,
    )
    if name.startswith("c4"):
        scene, cam, st, _ = load_config(os.path.join(ROOT, "configs",
                                                     "c4_mesh.yaml"))
        cam = api.Camera(Intrinsics.from_fov(64, 48, 40.0), cam.rotation,
                         cam.position)
        return scene, cam, mesh_modes(st)[name.split()[1]].with_(tile_rows=8)
    build = mesh_soft_ao_scene if name == "mesh_soft_ao" else two_mesh_scene
    scene, cam, st = build(api, 48)
    return scene, cam, st.with_(tile_rows=8)


@pytest.mark.parametrize("name", ["c4 config", "c4 ao", "mesh_soft_ao",
                                  "two_meshes"])
def test_split_kernels_match_plain(cuda_device, name):
    """Every kernel call of one split-path frame, replayed through the
    kernel and the plain version on the same inputs: bitwise equal."""
    from surfjax_torch.api import render
    from surfjax_torch.tools.kernel_check import capture_calls, compare
    scene, cam, st = _split_scene(name)
    with capture_calls() as calls:
        fb = render(scene, cam, st, device=cuda_device)
    torch.cuda.synchronize()
    names = {c[0] for c in calls}
    assert {"render_tile", "trace_rays", "mesh_tile"} <= names, names
    if st.ao and name != "two_meshes":
        assert "ao_fix" in names
    for k, (kname, args) in enumerate(calls):
        compare(kname, args, f"{name} call {k}")
    assert float(fb.hit.mean()) > 0.1


def _c5_split_calls(device):
    """The K1 and K2 calls of the split path's forward on c5 at 64x64 (the
    fit's), with its hard shadows and with a soft area light and AO."""
    from surfjax_torch import api
    from surfjax_torch.core.camera import flat_camera_rays
    from surfjax_torch.kernels.render_tile import render_rays_pallas
    from surfjax_torch.tools.kernel_check import capture_calls
    from surfjax_torch.tools.workload import reframe
    out = []
    for soft in (False, True):
        scene, cam, st, _ = load_config(os.path.join(ROOT, "configs",
                                                     "c5_anim.yaml"))
        cam = reframe(cam, 64, 64)
        st = st.with_(backend="pallas", tile_rows=8)
        if soft:
            scene.lights[0] = api.PointLight(position=(3.0, 4.0, -1.0),
                                             radius=0.4)
            st = st.with_(soft_shadows=True, ao=True)
        static, params = scene.freeze()
        o, d, _ = flat_camera_rays(
            cam.intrinsics,
            torch.as_tensor(np.asarray(cam.rotation, np.float32).reshape(9),
                            device=device),
            torch.as_tensor(np.asarray(cam.position, np.float32),
                            device=device))
        with capture_calls() as calls:
            render_rays_pallas(static, st, params_to_device(params, device),
                               o, d)
        out += calls
    return out


@pytest.mark.parametrize("entry", ["render_tile", "trace_rays"])
@pytest.mark.parametrize("name", ["c4 config", "c4 ao", "c5"])
def test_staged_split_kernel_and_profile_match_plain(cuda_device, entry,
                                                      name):
    """K1 and K2 without a crowd (split_staged.cu) on every call of a
    frame: the wrapper launches the staged kernel, the production kernel
    and its profiling instantiation equal the plain version bitwise, and
    the profile's SDF evaluations equal the plain version's less the FD
    normals'."""
    from surfjax_torch.api import render
    from surfjax_torch.kernels import render_tile as rt
    from surfjax_torch.tools.kernel_check import KERNELS, capture_calls, flat
    if name == "c5":
        calls = _c5_split_calls(cuda_device)
    else:
        scene, cam, st = _split_scene(name)
        with capture_calls() as calls:
            render(scene, cam, st, device=cuda_device)
    calls = [(k, a) for k, a in calls if k == entry]
    assert calls
    wrapper, reference = KERNELS[entry][:2]
    for kname, args in calls:
        with rt.count_ops() as c:
            ref = flat(reference(*args))
        before = wrapper.launches
        got = flat(wrapper(*args))
        assert wrapper.launches == before + 1
        launch, out, prof = rt.staged_split_launcher(
            entry, args[0], args[1], args[2:], profile=True)
        launch()
        torch.cuda.synchronize()
        for a, b, p in zip(got, ref, out):
            assert torch.equal(a, b) and torch.equal(p, b)
        fd = rt.fd_normal_evals(args[0].static, args[1], ref[1]) \
            if entry == "render_tile" else 0
        assert int(prof[:, :, 2].sum()) + fd == c["evals"]


@pytest.mark.parametrize("name", ["c4 ao", "mesh_soft_ao"])
def test_staged_ao_fix_and_profile_match_plain(cuda_device, name):
    """ao_fix without a crowd (ao_fix_staged.cu) on every call of a frame:
    the wrapper launches the staged kernel, the production kernel and its
    profiling instantiation equal the plain version bitwise, and the
    profile's SDF evaluations equal the plain version's."""
    from surfjax_torch.api import render
    from surfjax_torch.kernels import render_tile as rt
    from surfjax_torch.tools.kernel_check import capture_calls
    scene, cam, st = _split_scene(name)
    with capture_calls() as calls:
        render(scene, cam, st, device=cuda_device)
    calls = [a for k, a in calls if k == "ao_fix"]
    assert calls
    for args in calls:
        with rt.count_ops() as c:
            ref = rt.ao_fix_reference(*args)
        before = rt.ao_fix.launches
        got = rt.ao_fix(*args)
        assert rt.ao_fix.launches == before + 1
        launch, (out,), prof = rt.staged_split_launcher(
            "ao_fix", args[0], args[1], args[2:], profile=True)
        launch()
        torch.cuda.synchronize()
        assert torch.equal(got, ref) and torch.equal(out, ref)
        assert int(prof[:, :, 2].sum()) == c["evals"]


PROBES = ["edges", "overflow", "edges any-hit", "overflow any-hit",
          "edges to target any-hit", "layers any-hit"]


@pytest.mark.parametrize("label", PROBES)
def test_mesh_kernel_matches_plain_on_probes(cuda_device, label):
    """Rays at a mesh's vertices and edges, several occluders, tiles that
    overflow K (workload.mesh_probe_calls): the kernel equals the plain
    version bitwise."""
    from surfjax_torch import api
    from surfjax_torch.tools.kernel_check import compare
    from surfjax_torch.tools.workload import mesh_probe_calls
    args = dict(mesh_probe_calls(api, cuda_device))[label]
    compare("mesh_tile", args, label)


@pytest.mark.parametrize("name", ["c4 config", "mesh_soft_ao"])
def test_mesh_profile_votes_and_counts(cuda_device, name):
    """The profiling instantiation writes the kernel's outputs, votes as
    mesh_warp_masks does and counts per lane the culled count_tests."""
    from surfjax_torch.api import render
    from surfjax_torch.kernels.mesh_tile import (
        mesh_tile_launcher, mesh_tile_reference, mesh_warp_masks,
    )
    from surfjax_torch.tools.kernel_check import capture_calls, flat
    scene, cam, st = _split_scene(name)
    with capture_calls() as calls:
        render(scene, cam, st, device=cuda_device)
    mesh = [args for kname, args in calls if kname == "mesh_tile"]
    assert mesh
    for args in mesh:
        launch, out, (rec, tests, masks) = mesh_tile_launcher(
            *args, profile=True)
        launch()
        ref = mesh_tile_reference(*args)
        assert all(torch.equal(a, b) for a, b in zip(flat(out), flat(ref)))
        votes = mesh_warp_masks(*args[:7], args[9])
        assert torch.equal(masks, votes.masks)
        culled = mesh_tile_reference(*args, count_tests=True,
                                     masks=votes.masks)
        assert torch.equal(tests, culled[3].to(torch.int32))


def test_render_on_cuda_uses_the_split_kernels(cuda_device):
    from surfjax_torch.api import render
    from surfjax_torch.kernels.mesh_tile import mesh_tile
    from surfjax_torch.kernels.render_tile import ao_fix, render_tile, \
        trace_rays
    from surfjax_torch.kernels.mesh_tile import mesh_candidates
    scene, cam, st = _split_scene("c4 ao")
    wrappers = (render_tile, trace_rays, ao_fix, mesh_tile, frame_fused,
                mesh_candidates)
    before = [w.launches for w in wrappers]
    fb = render(scene, cam, st, device=cuda_device)
    assert [w.launches - b for w, b in zip(wrappers, before)] == \
        [1, 1, 1, 2, 0, 2]
    assert fb.rgb.device.type == "cuda"
    assert bool(torch.isfinite(fb.rgb).all())


# --- the candidate kernel (csrc/mesh_candidates.cu) at c4's size ----------

def _c4_pass(device, mode):
    """c4's main path (1920x1080 x 16 frames, one pass) in `mode` ->
    (FrameBuffers, the pass's mesh_candidates calls)."""
    from surfjax_torch.tools.kernel_check import capture_calls
    from surfjax_torch.tools.workload import mesh_main_path
    scene, camera, Rs, ps, modes = mesh_main_path(
        os.path.join(ROOT, "configs", "c4_mesh.yaml"))
    with capture_calls() as calls:
        fb = render_sequence(scene, camera, (Rs, ps), modes[mode],
                             device=device)
    return fb, [a for k, a in calls if k == "mesh_candidates"]


@pytest.mark.parametrize("mode", ["config", "ao"])
def test_candidates_at_c4_size_equal_the_plain_version_on_the_cpu(
        cuda_device, mode):
    """Both mesh_candidates calls of a 16-frame 1080p c4 pass (primary and
    shadow): one launch each, and (cand, counts) bitwise those of the
    plain version run on CPU copies of the same inputs."""
    from surfjax_torch.kernels.mesh_tile import (
        mesh_candidates, mesh_candidates_reference,
    )

    def cpu(a):
        # the ray tuples; the mesh's MeshStatic (a NamedTuple) as it is
        if isinstance(a, torch.Tensor):
            return a.cpu()
        return tuple(cpu(x) for x in a) if type(a) is tuple else a

    _, calls = _c4_pass(cuda_device, mode)
    assert len(calls) == 2
    for k, args in enumerate(calls):
        before = mesh_candidates.launches
        got = mesh_candidates(*args)
        torch.cuda.synchronize()
        assert mesh_candidates.launches == before + 1
        ref = mesh_candidates_reference(*cpu(args))
        for a, b in zip(got, ref):
            assert torch.equal(a.cpu(), b), f"{mode} call {k}"
        over = float((ref[1] > ref[0].shape[1]).float().mean())
        print(f"c4 {mode} call {k}: {ref[1].numel()} tiles, share past "
              f"K {over:.4f}, counts max {int(ref[1].max())}")


def test_c4_frames_equal_a_parent_checkout(cuda_device, tmp_path):
    """Every FrameBuffers buffer of c4's 16-frame 1080p pass, both modes,
    bitwise equal to those of another checkout of the port (its root in
    SURFJAX_PARENT_CHECKOUT) rendering the same poses on the same card in
    a subprocess: a change to the candidate sets' construction must not
    move a pixel."""
    import subprocess
    import sys
    parent = os.environ.get("SURFJAX_PARENT_CHECKOUT")
    if not parent:
        pytest.skip("set SURFJAX_PARENT_CHECKOUT to the root of the "
                    "checkout to compare with")
    script = (
        "import sys, torch\n"
        "from surfjax_torch.api import render_sequence\n"
        "from surfjax_torch.tools.workload import mesh_main_path\n"
        "scene, camera, Rs, ps, modes = mesh_main_path(sys.argv[1])\n"
        "for mode in ('config', 'ao'):\n"
        "    fb = render_sequence(scene, camera, (Rs, ps), modes[mode],\n"
        "                         device=torch.device('cuda', 0))\n"
        "    torch.save({f: getattr(fb, f).cpu() for f in fb._fields},\n"
        "               f'{sys.argv[2]}/{mode}.pt')\n")
    subprocess.run([sys.executable, "-c", script,
                    os.path.join(ROOT, "configs", "c4_mesh.yaml"),
                    str(tmp_path)], check=True, cwd=parent,
                   env=dict(os.environ, PYTHONPATH=parent))
    for mode in ("config", "ao"):
        fb, _ = _c4_pass(cuda_device, mode)
        want = torch.load(tmp_path / f"{mode}.pt")
        for field in fb._fields:
            assert torch.equal(getattr(fb, field).cpu(), want[field]), \
                f"{mode} {field}"


# --- the crowd loops in KF, K1, K2 and ao_fix; the priming kernel -----------

def _crowd_case(name):
    from surfjax_torch import api
    from surfjax_torch.tools.workload import crowd_cases, reframe
    if name.startswith("crowd_demo"):
        scene, cam, st, _ = load_config(os.path.join(ROOT, "configs",
                                                     "crowd_demo.yaml"))
        st = st.with_(backend="pallas", vector_objects=False,
                      soft_shadows=name.endswith("soft"))
        return scene, reframe(cam, 96, 64), st
    return crowd_cases(api, (96, 64))[name]


@pytest.mark.parametrize("name", [
    "crowd hard+ao", "crowd soft", "crowd only", "pairs all ops",
    "pairs soft", "analytic members", "analytic members soft",
    "crowd_demo", "crowd_demo soft"])
def test_crowd_kernel_matches_twin_and_crowd_off(cuda_device, name):
    """KF with the crowd on against its twin, bitwise; and against the
    same frame with the crowd off: geometry bitwise, rgb within 2 ULP."""
    from surfjax_torch.api import render
    scene, cam, st = _crowd_case(name)
    on = st.with_(vector_objects=True)
    static, params = scene.freeze()
    scene_t = SceneTensors(static, params_to_device(params, cuda_device))
    rows = torch.as_tensor(np.concatenate(
        [np.asarray(cam.rotation, np.float32).reshape(1, 9),
         np.asarray(cam.position, np.float32).reshape(1, 3)], axis=1),
        device=cuda_device)
    before = (frame_fused.launches, frame_fused.crowd.launches)
    got = frame_fused(scene_t, on, cam.intrinsics, rows)
    torch.cuda.synchronize()
    assert (frame_fused.launches, frame_fused.crowd.launches) == (
        before[0], before[1] + 1)
    ref = frame_fused_reference(scene_t, on, cam.intrinsics, rows)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    fb_on = render(scene, cam, on, device=cuda_device)
    fb_off = render(scene, cam, st, device=cuda_device)
    for field in ("depth", "normal", "hit", "obj_id"):
        assert torch.equal(getattr(fb_on, field), getattr(fb_off, field))
    ulp = (fb_on.rgb.view(torch.int32) - fb_off.rgb.view(torch.int32)).abs()
    assert int(ulp.max()) <= 2
    assert float(fb_on.hit.mean()) > 0.1


@pytest.mark.parametrize("name", ["edge hard", "edge soft", "spheres 256"])
def test_culled_crowd_kernel_matches_both_twins(cuda_device, name):
    """KF's warp culling on a frame its blocks do not tile (75x37): the
    kernel equals the twin that visits every member and the twin that
    visits each warp's masked members only, bitwise."""
    from surfjax_torch import api
    from surfjax_torch.kernels.render_tile import crowd_warp_masks
    from surfjax_torch.tools.workload import cull_edge_scene, sphere_crowd
    if name.startswith("edge"):
        scene, cam, st = cull_edge_scene(api, (75, 37),
                                         soft=name.endswith("soft"))
    else:
        scene, cam, st = sphere_crowd(api, 256, size=(75, 37))
    st = st.with_(vector_objects=True)
    static, params = scene.freeze()
    scene_t = SceneTensors(static, params_to_device(params, cuda_device))
    rows = torch.as_tensor(np.concatenate(
        [np.asarray(cam.rotation, np.float32).reshape(1, 9),
         np.asarray(cam.position, np.float32).reshape(1, 3)], axis=1),
        device=cuda_device)
    got = frame_fused(scene_t, st, cam.intrinsics, rows)
    masks = crowd_warp_masks(scene_t, st, cam.intrinsics, rows)
    for ref in (frame_fused_reference(scene_t, st, cam.intrinsics, rows),
                frame_fused_reference(scene_t, st, cam.intrinsics, rows,
                                      masks=masks)):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert float(got[8].mean()) > 0.1


def test_crowd_split_kernels_match_plain(cuda_device):
    """A crowd beside a mesh: K1, ao_fix and K2 run with the crowd active
    (and the mesh kernel beside them); every call bitwise equal to its
    plain version."""
    from surfjax_torch.api import render
    from surfjax_torch.tools.kernel_check import capture_calls, compare
    scene, cam, st = _crowd_case("crowd + mesh")
    with capture_calls() as calls:
        fb = render(scene, cam, st.with_(vector_objects=True),
                    device=cuda_device)
    torch.cuda.synchronize()
    assert {"render_tile", "trace_rays", "ao_fix", "mesh_tile"} <= \
        {c[0] for c in calls}
    for k, (kname, args) in enumerate(calls):
        compare(kname, args, f"crowd + mesh call {k}")
    assert int((fb.obj_id == len(scene.objects) - 1).sum()) > 10


def test_crowd_ao_fix_culled_and_profiled(cuda_device):
    """ao_fix with a crowd (ao_fix_crowd.cu) on the crowd + mesh frame, with
    the call's need and with one needing lane per warp: the kernel and its
    profiling instantiation equal the plain version and the masked plain
    version bitwise, and the profile marks as skipped exactly the warps
    without a needing lane."""
    from surfjax_torch.api import render
    from surfjax_torch.kernels import render_tile as rt
    from surfjax_torch.tools.kernel_check import capture_calls, masks_of
    scene, cam, st = _crowd_case("crowd + mesh")
    with capture_calls() as calls:
        render(scene, cam, st.with_(vector_objects=True), device=cuda_device)
    (args,) = [a for k, a in calls if k == "ao_fix"]
    lane = torch.arange(args[4].numel(), device=cuda_device)
    one = torch.where(lane % 32 == (lane // 32 * 7) % 32, 1.0, 0.0)
    for need in (args[4], one.reshape(args[4].shape)):
        a = args[:4] + (need, args[5])
        masks = masks_of("ao_fix", a)
        ref = rt.ao_fix_reference(*a)
        before = rt.ao_fix.crowd.launches
        got = rt.ao_fix(*a)
        assert rt.ao_fix.crowd.launches == before + 1
        launch, (prof_out,), prof = rt.crowd_ao_fix_launcher(
            a[0], a[1], a[2:], profile=True)
        launch()
        torch.cuda.synchronize()
        for b in (ref, rt.ao_fix_reference(*a, masks=masks)):
            assert torch.equal(got, b)
            assert torch.equal(prof_out, b)
        assert torch.equal(prof[:, -1] == 0, masks.hit_warps)


def test_large_crowd_renders_on_the_card(cuda_device):
    """256 members through the crowd's loops."""
    from surfjax_torch import api
    from surfjax_torch.tools.workload import sphere_crowd
    scene, cam, st = sphere_crowd(api, 256, size=(128, 96))
    fb = api.render(scene, cam, st.with_(vector_objects=True),
                    device=cuda_device)
    assert float(fb.hit.mean()) > 0.3
    assert len(torch.unique(fb.obj_id)) > 100


@pytest.mark.parametrize("name", ["c3_sdf", "c3_sdf_portlog"])
def test_prime_kernel_matches_plain_and_feeds_kf(cuda_device, name):
    """The priming kernel against its plain version, bitwise, on the
    coarse rays of a 128x96 frame; then KF with that t0 against its twin
    with the same t0, bitwise; the primed hit mask differs from the
    unprimed one on at most one pixel in a thousand."""
    from surfjax_torch.api import render
    from surfjax_torch.kernels.render_tile import (
        prime_frame, prime_tile, prime_tile_reference,
    )
    from surfjax_torch.tools.kernel_check import capture_calls
    from surfjax_torch.tools.workload import reframe
    scene, cam, st, _ = load_config(os.path.join(ROOT, "configs",
                                                 name + ".yaml"))
    cam = reframe(cam, 128, 96)
    st = st.with_(backend="pallas", prime=True, prime_min=64)
    before = prime_tile.launches
    with capture_calls() as calls:
        primed = render(scene, cam, st, device=cuda_device)
    assert prime_tile.launches == before + 1
    (kname, args), = calls
    assert kname == "prime_tile"
    assert torch.equal(prime_tile(*args), prime_tile_reference(*args))
    static, params = scene.freeze()
    scene_t = SceneTensors(static, params_to_device(params, cuda_device))
    R = torch.as_tensor(np.asarray(cam.rotation, np.float32).reshape(9),
                        device=cuda_device)
    pos = torch.as_tensor(np.asarray(cam.position, np.float32),
                          device=cuda_device)
    t0 = prime_frame(static, cam.intrinsics, st, scene_t.params, R, pos)[None]
    rows = torch.cat([R, pos]).reshape(1, 12)
    got = frame_fused(scene_t, st, cam.intrinsics, rows, t0)
    ref = frame_fused_reference(scene_t, st, cam.intrinsics, rows, t0)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    unprimed = render(scene, cam, st.with_(prime=False), device=cuda_device)
    assert float((primed.hit != unprimed.hit).float().mean()) <= 1e-3


@pytest.mark.parametrize("name", ["c3_sdf", "c3_sdf_portlog"])
def test_prime_profile_matches_plain(cuda_device, name):
    """The priming kernel's profiling instantiation on the coarse rays of
    a 128x96 frame: its t0 equal to the plain version's, bitwise, its SDF
    evaluations to the plain version's count, and every warp's clock slot
    written."""
    from surfjax_torch.api import render
    from surfjax_torch.kernels import render_tile as rt
    from surfjax_torch.tools.kernel_check import capture_calls
    from surfjax_torch.tools.workload import reframe
    scene, cam, st, _ = load_config(os.path.join(ROOT, "configs",
                                                 name + ".yaml"))
    cam = reframe(cam, 128, 96)
    st = st.with_(backend="pallas", prime=True, prime_min=64)
    with capture_calls() as calls:
        render(scene, cam, st, device=cuda_device)
    (_, args), = calls
    with rt.count_ops() as c:
        ref = rt.prime_tile_reference(*args)
    launch, (out,), prof = rt.prime_profile_launcher(*args)
    launch()
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    names = list(rt.PRIME_PHASE_NAMES)
    assert int(prof[:, names.index("evals proxy"), 2].sum()
               + prof[:, names.index("evals sdf"), 2].sum()) == c["evals"]
    assert bool((prof[:, rt.PRIME_CLOCK, 2] == 1).all())


# --- the FP32 roofline probe and the kernel-forward differentiable render ---

@pytest.mark.parametrize("kind", ["bulb_mix", "cheb_mix", "fma_dep"])
def test_probe_kernels_match_plain(cuda_device, kind):
    """Every probe entry at K = 16 and every unroll against its plain
    version: the entries built without contraction bitwise (the explicit
    FMA chains within 1 ULP of their float64 plain versions), the contracted
    ones within 1e-5; each launch is counted. The mixes also, kernel and
    profiling instantiation, on 100,003 lanes (not a whole number of
    blocks) of which some escape the bailout after a few substeps: there
    the -fmad=false entries are held bitwise on every lane, the contracted
    ones within 1e-5 on the lanes of the probe's own seeds (every other
    lane), which never escape; on the others an orbit that the contraction
    tips over the bailout a substep earlier or later leaves another state.
    Printed per contracted launch (pytest -rP): the lanes beyond 1e-5, how
    many of them escape in the plain version, and the largest relative
    difference on the lanes that do not."""
    from surfjax_torch.tools import fp32_peak as fp
    from tests.test_torch_fp32_peak_host import ragged_seeds
    seeds = fp.seeds(64, 2, cuda_device)
    ragged = tuple(a.to(cuda_device) for a in ragged_seeds(100_003))
    inner = torch.arange(100_003, device=cuda_device) % 2 == 0
    escapes = None
    if kind in fp.MIXES:
        form = fp._new_w_cheb if kind == "cheb_mix" else fp._new_w_std
        m = fp._bulb_orbit(*ragged, fp.BAILOUT2, 16, form)[4]
        escapes = m > fp.BAILOUT2

    def check(got, ref, fma, what=""):
        torch.cuda.synchronize()
        if fma:
            rel = (got - ref).abs() / ref.abs()
            if got.shape == inner.shape:
                off = rel > 1e-5
                stay = rel[~escapes]
                print(f"{what}: {int(off.sum())} of {off.numel()} lanes "
                      f"beyond 1e-5 (largest {float(rel.max()):.6g}), "
                      f"{int((off & escapes).sum())} of them escape in the "
                      f"plain version, {int((off & inner).sum())} on the "
                      f"probe's seeds; lanes that do not escape: "
                      f"{int(stay.numel())}, largest {float(stay.max()):.6g}")
                rel = rel[inner]
            assert float(rel.max()) <= 1e-5
        elif kind in fp.CHAINS:
            ulp = (got.view(torch.int32) - ref.view(torch.int32)).abs()
            assert int(ulp.max()) <= 1
        else:
            assert torch.equal(got, ref)

    ref = fp.fp32_peak_reference(kind, *seeds, 16)
    ref_ragged = fp.fp32_peak_reference(kind, *ragged, 16)
    for fma in ((False,) if kind in fp.CHAINS else (False, True)):
        entry = fp.entry_name(kind, fma)
        for unroll in fp.UNROLLS:
            before = fp.fp32_peak.launches.get(entry, 0)
            got = fp.fp32_peak(kind, *seeds, 16, unroll, fma)
            assert fp.fp32_peak.launches[entry] == before + 1
            check(got, ref, fma)
            if kind in fp.CHAINS:
                continue
            launch, got = fp.peak_launcher(kind, *ragged, 16, unroll, fma)
            launch()
            check(got, ref_ragged, fma, f"{entry} u{unroll}")
            launch, got, prof = fp.profile_launcher(kind, *ragged, 16,
                                                    unroll, fma)
            launch()
            check(got, ref_ragged, fma, f"{entry} u{unroll} profile")
            assert bool((prof[:, 0] > 0).all())
    with pytest.raises(ValueError, match="unroll"):
        fp.fp32_peak(kind, *seeds, 16, 3)


def test_probe_sweep_runs_and_is_sane(cuda_device):
    """A shorter sweep over the tool's 2,097,152 lanes (fewer lanes or
    iterations would put the K-to-2K difference of the FMA chains near the
    resolution of CUDA events, and the tool would rightly refuse the
    reading): every row positive or nan, the FMA chains at most 105% of the
    data-sheet peak, no mix above them (run raises otherwise)."""
    from surfjax_torch.tools import fp32_peak as fp
    rows = fp.run(iters=128, repeats=3)
    assert len(rows) == 15
    for name, r in rows.items():
        assert r["tflops"] != r["tflops"] or r["tflops"] > 0.0, (name, r)


def test_hybrid_on_cuda_uses_the_kernels_and_matches_cpu(cuda_device):
    """c5 at 64x64: the hybrid's forward launches K1 once and K2 once per
    light and equals render_rays_pallas to the bit; its pose gradient
    equals the CPU's plain-version run within 1e-3 relative L2."""
    from surfjax_torch.core.camera import flat_camera_rays
    from surfjax_torch.diff.fit import pose_loss_and_grad
    from surfjax_torch.diff.hybrid import render_rays_hybrid
    from surfjax_torch.kernels.render_tile import (
        render_rays_pallas, render_tile, trace_rays,
    )
    from surfjax_torch.tools.workload import reframe
    scene, cam, st, _ = load_config(os.path.join(ROOT, "configs",
                                                 "c5_anim.yaml"))
    cam = reframe(cam, 64, 64)
    st = st.with_(backend="pallas", tile_rows=8)
    static, params = scene.freeze()
    params = params_to_device(params, cuda_device)
    R = torch.as_tensor(np.asarray(cam.rotation, np.float32).reshape(9),
                        device=cuda_device)
    pos = torch.as_tensor(np.asarray(cam.position, np.float32),
                          device=cuda_device)
    o, d, _ = flat_camera_rays(cam.intrinsics, R, pos)
    with torch.no_grad():
        fb_p = render_rays_pallas(static, st, params, o, d)
    before = (render_tile.launches, trace_rays.launches, frame_fused.launches)
    lp = params["leaf_params"].clone().requires_grad_(True)
    fb_h = render_rays_hybrid(static, st, dict(params, leaf_params=lp), o, d)
    torch.cuda.synchronize()
    assert (render_tile.launches, trace_rays.launches,
            frame_fused.launches) == (before[0] + 1,
                                      before[1] + len(scene.lights),
                                      before[2])
    for a, b in zip(fb_h, fb_p):
        assert torch.equal(a.detach(), b)
    g, = torch.autograd.grad((fb_h.rgb * fb_h.rgb).mean(), lp)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 1e-6
    l_c, g_c = pose_loss_and_grad(scene, cam, st, device=cuda_device)
    l_h, g_h = pose_loss_and_grad(scene, cam, st, device="cpu")
    a = np.concatenate([g_c["w"], g_c["dt"]]).astype(np.float64)
    b = np.concatenate([g_h["w"], g_h["dt"]]).astype(np.float64)
    assert abs(l_c - l_h) / abs(l_h) < 1e-3
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-3


@pytest.mark.parametrize("mode", ["pose", "sdf"])
def test_fit_on_cuda_goes_through_k1_and_k2(cuda_device, mode):
    """Ten fit steps on c5 at 64x64 with backend pallas: the loss falls,
    K1 launches once and K2 once per light and step, KF never."""
    from surfjax_torch.api import render
    from surfjax_torch.diff import fit_pose, fit_sdf
    from surfjax_torch.kernels.render_tile import render_tile, trace_rays
    from surfjax_torch.tools.workload import (
        fit_main_path, reframe, sdf_fit_start,
    )
    scene, cam, st, cfg, init = fit_main_path(
        os.path.join(ROOT, "configs", "c5_anim.yaml"))
    cam = reframe(cam, 64, 64)
    st = st.with_(tile_rows=8)
    target = render(scene, cam, st, device=cuda_device).rgb
    before = (render_tile.launches, trace_rays.launches, frame_fused.launches)
    if mode == "pose":
        _, _, losses = fit_pose(scene, cam, target, steps=10, lr=cfg["lr"],
                                settings=st, init=init, device=cuda_device)
    else:
        _, init_lp, mask = sdf_fit_start(scene)
        _, losses = fit_sdf(scene, cam, target, steps=10, lr=cfg["lr"],
                            settings=st, init_leaf_params=init_lp,
                            param_mask=mask, device=cuda_device)
    assert (render_tile.launches - before[0], trace_rays.launches - before[1],
            frame_fused.launches - before[2]) == (10, 10 * len(scene.lights),
                                                  0)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("mode", ["value", "value_exact"])
def test_staged_kernel_and_its_profile_match_twin(cuda_device, mode):
    """The staged kernel, its profiling instantiation and the profile of
    the per-pixel kernel it replaced against the twin at 64x64 on c3,
    bitwise; the staged profile's totals: every (hit receiver, tap) pair
    evaluates AO's unbounded group (the plane) exactly once, no trip counts
    more than 32 lanes, and every phase of the primary trace took cycles;
    the per-pixel profile's: cycles in every phase it has, no loop
    trips."""
    from surfjax_torch.kernels import render_tile as rt
    scene, cam, st, _ = load_config(os.path.join(ROOT, "configs",
                                                 "c3_sdf.yaml"))
    intr = cam.intrinsics
    fov = 2.0 * float(np.degrees(np.arctan(0.5 * intr.height / intr.fy)))
    intr = Intrinsics.from_fov(64, 64, fov)
    st = st.with_(backend="pallas", **(EXACT if mode == "value_exact"
                                       else {}))
    static, params = scene.freeze()
    scene_t = SceneTensors(static, params_to_device(params, cuda_device))
    rows = torch.as_tensor(np.concatenate(
        [np.asarray(cam.rotation, np.float32).reshape(1, 9),
         np.asarray(cam.position, np.float32).reshape(1, 3)], axis=1),
        device=cuda_device)
    ref = frame_fused_reference(scene_t, st, intr, rows)
    hits = int(ref[8].sum())
    for kind, (launch, out, prof) in (
            ("staged", rt.staged_launcher(scene_t, st, intr, rows)),
            ("staged", rt.staged_launcher(scene_t, st, intr, rows,
                                          profile=True)),
            ("per_pixel", rt.frame_profile_launcher(scene_t, st, intr,
                                                    rows))):
        launch()
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        if prof is None:
            continue
        tot = prof.sum(dim=0).cpu()
        if kind == "per_pixel":
            names = rt.KF_PROF_NAMES
            for name in ("ray", "primary", "normal", "ao", "vis l0",
                         "shade", "write"):
                assert int(tot[names.index(name), 0]) > 0, name
            assert int(tot[:, 1:].sum()) == 0
            assert int(tot[len(names):].sum()) == 0
            continue
        names = rt.KP_PHASE_NAMES
        assert int(tot[names.index("ao unbounded"), 2]) == \
            hits * 4 * st.ao_samples
        assert bool((tot[:, 2] <= 32 * tot[:, 1]).all())
        for name in ("ray", "normal", "primary o0", "primary o1"):
            assert int(tot[names.index(name), 0]) > 0, name


# --- scenes past the former fixed bounds (workload.limit_cases) -------------

def _limit_case(name, size=(64, 36)):
    from surfjax_torch import api
    from surfjax_torch.tools.workload import limit_cases
    return limit_cases(api, size)[name]


LIMIT_NAMES = ["64 spheres", "120+8", "120+8 soft", "crowd 120+8+70",
               "mesh + 70", "crowd 120+8+70 + mesh", "smooth 17 left",
               "smooth 17 right", "smooth 65 left", "smooth 65 right",
               "union 17", "union 40"]


@pytest.mark.parametrize("name", LIMIT_NAMES)
def test_limit_case_kernels_match_plain(cuda_device, name):
    """KF (staged, or with the crowd) on a mesh-free case, and every
    split-kernel call of the case (the forward over the camera's rays, or
    the mesh scene's render with the crowd off and on), bitwise equal to
    their plain versions; the crowd with the mesh and 71 objects outside
    it takes the KF_WIDE build of K1, K2 and ao_fix with a crowd."""
    from surfjax_torch import api
    from surfjax_torch.core.camera import flat_camera_rays
    from surfjax_torch.kernels.render_tile import (
        launches_crowd, render_rays_pallas,
    )
    from surfjax_torch.tools.kernel_check import KERNELS, capture_calls, flat
    scene, cam, st = _limit_case(name)
    static, params = scene.freeze()
    scene_t = SceneTensors(static, params_to_device(params, cuda_device))
    rows = torch.as_tensor(np.concatenate(
        [np.asarray(cam.rotation, np.float32).reshape(1, 9),
         np.asarray(cam.position, np.float32).reshape(1, 3)], axis=1),
        device=cuda_device)
    calls = []
    if "mesh" in name:
        for vec in sorted({False, True} if name == "mesh + 70" else
                          {bool(st.vector_objects)}):
            with capture_calls() as got_calls:
                api.render(scene, cam, st.with_(vector_objects=vec),
                           device=cuda_device)
            calls += got_calls
    else:
        kf = frame_fused.crowd if launches_crowd(static, st) \
            else frame_fused
        before = kf.launches
        got = frame_fused(scene_t, st, cam.intrinsics, rows)
        assert kf.launches == before + 1
        ref = frame_fused_reference(scene_t, st, cam.intrinsics, rows)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        o, d, _ = flat_camera_rays(cam.intrinsics, rows[0, :9],
                                   rows[0, 9:])
        with capture_calls() as calls:
            render_rays_pallas(static, st, scene_t.params, o, d)
    assert {"render_tile", "trace_rays"} <= {k for k, _ in calls}
    for k, (kname, args) in enumerate(calls):
        wrapper, reference = KERNELS[kname][:2]
        out = flat(wrapper(*args))
        ref = flat(reference(*args))[:len(out)]
        torch.cuda.synchronize()
        for j, (a, b) in enumerate(zip(out, ref)):
            assert torch.equal(a, b), f"{name} call {k} {kname} output {j}"


@pytest.mark.parametrize("name", ["64 spheres", "smooth 65 right"])
def test_limit_case_primed_matches_plain(cuda_device, name):
    from surfjax_torch import api
    from surfjax_torch.kernels.render_tile import (
        prime_tile, prime_tile_reference,
    )
    from surfjax_torch.tools.kernel_check import capture_calls
    scene, cam, st = _limit_case(name, (128, 72))
    before = prime_tile.launches
    with capture_calls() as calls:
        fb = api.render(scene, cam, st.with_(prime=True, prime_min=64),
                        device=cuda_device)
    assert prime_tile.launches == before + 1
    assert [k for k, _ in calls] == ["prime_tile"]
    args = calls[0][1]
    assert torch.equal(prime_tile(*args), prime_tile_reference(*args))
    assert float(fb.hit.float().mean()) > 0.5


@pytest.mark.parametrize("kind", ["sphere", "csgpair"])
def test_compile_scaling_past_64_objects(cuda_device, kind):
    """compile_scaling's 129 objects per object and as a crowd, at
    256x144: one launch per call, the crowd changing no hit, id or
    depth."""
    from surfjax_torch.tools import compile_scaling
    fbs = []
    for _, vec in compile_scaling.MODES:
        row = compile_scaling.measure(128, vec, kind, 2, 1, size=(256, 144),
                                      device=cuda_device, out=fbs)
        assert row["launches"] == 2 and row["ms_frame"] > 0.0
        assert row["hit_fraction"] > 0.2
    for name in ("hit", "obj_id", "depth", "normal"):
        assert torch.equal(getattr(fbs[0], name), getattr(fbs[1], name))
