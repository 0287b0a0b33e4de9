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


def test_render_on_cuda_uses_the_split_kernels(cuda_device):
    from surfjax_torch.api import render
    from surfjax_torch.kernels.mesh_tile import mesh_tile
    from surfjax_torch.kernels.render_tile import ao_fix, render_tile, \
        trace_rays
    scene, cam, st = _split_scene("c4 ao")
    wrappers = (render_tile, trace_rays, ao_fix, mesh_tile, frame_fused)
    before = [w.launches for w in wrappers]
    fb = render(scene, cam, st, device=cuda_device)
    assert [w.launches - b for w, b in zip(wrappers, before)] == \
        [1, 1, 1, 2, 0]
    assert fb.rgb.device.type == "cuda"
    assert bool(torch.isfinite(fb.rgb).all())
