"""K1 and K2 for scenes without a crowd (surfjax_torch/kernels/csrc/
split_staged.cu) and ao_fix (ao_fix_staged.cu) built for the CPU behind the
host stand-in of the CUDA runtime (tests/cuda_host.py), launched through
the port's own launcher with the library and the stream swapped for the
host's, and held bitwise against their plain versions,
render_tile_reference, trace_rays_reference and ao_fix_reference, on every
K1 and K2 call of:

  * c4 at 64x48 (tile_rows 8) in the `config` and `ao` modes;
  * workload.mesh_soft_ao_scene and workload.two_mesh_scene;
  * the c5 fit scene at 48x48 through the split path (the fit's forward),
    with its hard shadows, and with a soft area light and AO;
  * a primed split frame (K1 with t0);
  * a scene with a directional light beside a point light with a radius,
    an unboundable SDF plane, an SDF sphere and blob and an analytic box;
  * a ragged ray count, not a multiple of a block's 128 rays;

and on every ao_fix call of c4 `ao` at 64x48 and workload.mesh_soft_ao_scene
(also primed), c4's calls cut to a ragged count, and with need 0 and need 1
on every lane (workload.two_mesh_scene has no object outside its meshes, so
the split path makes no ao_fix call there, AO on or off).

The profiling instantiations write the same outputs; their SDF
evaluations equal the plain version's (count_ops) less the FD normals',
and on c4 their AO evaluations are lanes x taps exactly (ao_fix: the
needing lanes').
"""

import contextlib
import ctypes
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import surfjax_torch.api as api  # noqa: E402
from surfjax_torch.config import load_config  # noqa: E402
from surfjax_torch.core.camera import flat_camera_rays  # noqa: E402
from surfjax_torch.core.scene_compile import params_to_device  # noqa: E402
from surfjax_torch.kernels import _build  # noqa: E402
from surfjax_torch.kernels import render_tile as rt  # noqa: E402
from surfjax_torch.tools import workload  # noqa: E402
from surfjax_torch.tools.kernel_check import capture_calls, flat  # noqa

from tests import cuda_host  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = {"render_tile": rt.render_tile_reference,
             "trace_rays": rt.trace_rays_reference,
             "ao_fix": rt.ao_fix_reference}


def _config(name, size):
    scene, cam, st, _ = load_config(os.path.join(ROOT, "configs",
                                                 name + ".yaml"))
    return scene, workload.reframe(cam, *size), st


def _rays_calls(scene, cam, st):
    """The K1 and K2 calls of the split path's forward over the camera's
    flat rays (as the fit renders a scene without a mesh)."""
    static, params = scene.freeze()
    intr = cam.intrinsics
    R = torch.as_tensor(np.asarray(cam.rotation, np.float32).reshape(9))
    pos = torch.as_tensor(np.asarray(cam.position, np.float32))
    o, d, _ = flat_camera_rays(intr, R, pos)
    with capture_calls() as calls:
        rt.render_rays_pallas(static, st, params_to_device(params, "cpu"),
                              o, d)
    return calls


def _render_calls(scene, cam, st):
    with capture_calls() as calls:
        api.render(scene, cam, st, device="cpu")
    return calls


def _c5_soft():
    scene, cam, st = _config("c5_anim", (48, 48))
    scene.lights[0] = api.PointLight(position=(3.0, 4.0, -1.0), radius=0.4)
    return scene, cam, st.with_(backend="pallas", tile_rows=8,
                                soft_shadows=True, ao=True, ao_samples=5)


def _lights_scene():
    """An unboundable SDF plane under an SDF sphere and a smooth blob and
    an analytic box, a point light with a radius and a directional light,
    AO and soft shadows."""
    scene = api.Scene()
    scene.add(api.Plane(normal=(0.0, 1.0, 0.0), offset=-1.0),
              api.Material.lambert((0.5, 0.5, 0.55)), engine="sdf")
    scene.add(api.Sphere(center=(0.4, -0.3, 3.0), radius=0.6),
              api.Material.lambert((0.8, 0.3, 0.3)), engine="sdf")
    scene.add(api.smooth_union(
        api.Sphere(center=(-0.8, -0.5, 3.4), radius=0.45),
        api.Box(center=(-0.6, -0.2, 3.6), half_extents=(0.3, 0.3, 0.3)),
        0.2), api.Material.lambert((0.3, 0.7, 0.4)), engine="sdf")
    scene.add(api.Box(center=(1.3, -0.6, 4.0), half_extents=(0.3, 0.4, 0.3)),
              api.Material.lambert((0.3, 0.3, 0.8)))
    scene.add_light(api.PointLight(position=(2.0, 4.0, 0.0), radius=0.3))
    scene.add_light(api.DirectionalLight(direction=(-0.3, -1.0, 0.4)))
    cam = api.Camera.pinhole(40, 30, fov_y_deg=50.0, position=(0.0, 0.6, -0.5),
                             target=(0.0, -0.3, 3.0))
    st = api.RenderSettings(shadows=True, soft_shadows=True, ao=True,
                            ao_samples=5, backend="pallas", max_steps=64,
                            shadow_steps=48, tile_rows=8)
    return scene, cam, st


def _cases():
    c4, c4_cam, c4_st = _config("c4_mesh", (64, 48))
    out = {f"c4 {mode}": (_render_calls, c4, c4_cam, st.with_(tile_rows=8))
           for mode, st in workload.mesh_modes(c4_st).items()}
    soft, soft_cam, soft_st = workload.mesh_soft_ao_scene(api, 32)
    out["mesh_soft_ao"] = (_render_calls, soft, soft_cam,
                           soft_st.with_(tile_rows=8))
    out["primed"] = (_render_calls, soft, soft_cam,
                     soft_st.with_(tile_rows=8, prime=True, prime_min=32))
    two, two_cam, two_st = workload.two_mesh_scene(api, 32)
    out["two_meshes"] = (_render_calls, two, two_cam,
                         two_st.with_(tile_rows=8))
    c5, c5_cam, c5_st = _config("c5_anim", (48, 48))
    out["c5 hard"] = (_rays_calls, c5, c5_cam,
                      c5_st.with_(backend="pallas", tile_rows=8))
    out["c5 soft"] = (_rays_calls, *_c5_soft())
    out["lights"] = (_rays_calls, *_lights_scene())
    return out


CASES = _cases()


@pytest.fixture(scope="module")
def calls():
    """Every case's K1 and K2 calls, recorded once: label -> [(name,
    args)]; "ragged" holds c5 hard's first 300 rays of each call."""
    out = {}
    for label, (record, scene, cam, st) in CASES.items():
        out[label] = [(k, a) for k, a in record(scene, cam, st)
                      if k in REFERENCE]
    out["ragged"] = [(k, _ragged(a, 300)) for k, a in out["c5 hard"]]
    ao_fix = [(k, a) for k, a in out["c4 ao"] if k == "ao_fix"]
    # 300 rays from the middle of the frame, where the mesh is
    out["ragged ao"] = [(k, _ragged(a, 300, a[4].numel() // 2 - 150))
                        for k, a in ao_fix]
    for label, fill in (("need 0", 0.0), ("need 1", 1.0)):
        out[label] = [(k, a[:4] + (torch.full_like(a[4], fill),) + a[5:])
                      for k, a in ao_fix]
    return out


def _ragged(args, n, start=0):
    """A call's arguments with every ray array cut to n rays from
    `start`."""
    def cut(a):
        if isinstance(a, tuple):
            return tuple(cut(c) for c in a)
        return a.reshape(-1)[start:start + n].contiguous()
    return args[:2] + tuple(cut(a) for a in args[2:])


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if cuda_host.gxx() is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    lib = cuda_host.build("split_staged.cu",
                          str(tmp_path_factory.mktemp("split_host")))
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    lib.sp_staged_render_tile.argtypes = [rt.KFTables, rt.KFSettings,
                                          rt.SplitRays, ptr, i32, ptr]
    lib.sp_staged_trace_rays.argtypes = [rt.KFTables, rt.KFSettings,
                                         rt.KSLayout, rt.SplitRays, ptr, ptr,
                                         i32, ptr]
    ao_lib = cuda_host.build("ao_fix_staged.cu",
                             str(tmp_path_factory.mktemp("ao_fix_host")))
    ao_lib.sp_staged_ao_fix.argtypes = [rt.KFTables, rt.KFSettings,
                                        rt.SplitRays, ptr, i32, ptr]
    k1, k2 = lib.sp_staged_render_tile, lib.sp_staged_trace_rays
    af = ao_lib.sp_staged_ao_fix
    # the launcher passes its tensors' device index: None on the CPU
    return types.SimpleNamespace(
        sp_staged_render_tile=lambda T, S, R, prof, dev, st: k1(
            T, S, R, prof, 0, st),
        sp_staged_trace_rays=lambda T, S, L, R, prof, work, dev, st: k2(
            T, S, L, R, prof, work, 0, st),
        sp_staged_ao_fix=lambda T, S, R, prof, dev, st: af(
            T, S, R, prof, 0, st))


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """The launchers load the host library and launch on a stand-in
    stream."""
    monkeypatch.setattr(_build, "load", lambda: host_lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))


def _equal(got, ref):
    return all(torch.equal(a, b) for a, b in zip(flat(got), flat(ref)))


LABELS = list(CASES) + ["ragged"]
AO_FIX_LABELS = ["c4 ao", "mesh_soft_ao", "primed", "ragged ao", "need 0",
                 "need 1"]
PAIRS = ([(entry, label) for entry in ("render_tile", "trace_rays")
          for label in LABELS]
         + [("ao_fix", label) for label in AO_FIX_LABELS])


@pytest.mark.parametrize("entry,label", PAIRS)
def test_host_kernel_equals_plain(calls, on_host, label, entry):
    """Every call of the case through the kernel, twice (K2's counters
    reset themselves between launches), and through the wrapper's
    launcher: bitwise the plain version's."""
    mine = [args for name, args in calls[label] if name == entry]
    if entry != "trace_rays" or label != "two_meshes":
        assert mine, label
    for k, args in enumerate(mine):
        ref = REFERENCE[entry](*args)
        launch, out, _ = rt.staged_split_launcher(entry, *args[:2],
                                                  args[2:])
        launch()
        assert _equal(out, ref), f"{label} call {k}"
        launch()
        assert _equal(out, ref), f"{label} call {k}, second launch"
        split_entry = {v: k for k, v in rt.STAGED.items()}[entry]
        launch, out = rt.split_launcher(split_entry, *args[:2], args[2:],
                                        len(flat(ref)))
        launch()
        assert _equal(out, ref), f"{label} call {k} through split_launcher"


@pytest.mark.parametrize("label", ["c4 ao", "c5 hard", "c5 soft", "lights",
                                   "ragged", "mesh_soft_ao", "ragged ao"])
def test_host_profile_equals_plain_and_counts(calls, on_host, label):
    """The profiling instantiations' outputs and SDF evaluations against
    the plain version's; on c4, AO evaluates the floor at every tap of
    every lane that takes AO (K1's every lane, ao_fix's needing lanes)."""
    aos = rt.KP_PHASE_NAMES.index("ao unbounded")
    for name, args in calls[label]:
        with rt.count_ops() as c:
            ref = REFERENCE[name](*args)
        launch, out, prof = rt.staged_split_launcher(name, *args[:2],
                                                     args[2:], profile=True)
        launch()
        assert _equal(out, ref)
        evals = int(prof[:, :, 2].sum())
        scene_t, st = args[:2]
        if name == "render_tile":
            # the FD normals carry no probe
            evals += rt.fd_normal_evals(scene_t.static, st, ref[1])
            if label == "c4 ao":
                n = flat(args[2:])[0].numel()
                assert int(prof[:, aos, 2].sum()) == n * 4 * st.ao_samples
        if name == "ao_fix" and label in ("c4 ao", "ragged ao"):
            n = int((args[4] > 0.5).sum())
            assert n > 0
            assert int(prof[:, aos, 2].sum()) == n * 4 * st.ao_samples
        assert evals == c["evals"], f"{label} {name}"


def test_layout_counts_mesh_objects():
    """The staged scene reserves a row and a bound slot for every object,
    meshes included, and K2's block asks for no pixel records."""
    scene, cam, st = CASES["c4 config"][1:]
    static, params = scene.freeze()
    tables, _ = rt._scene_tables(
        rt.SceneTensors(static, params_to_device(params, "cpu")), st,
        torch.device("cpu"))
    lay = rt._scene_layout(tables, records=False)
    n_objects = len(static.ir.objects)
    assert tables[0].shape[0] == n_objects == 2
    assert lay.bounds - lay.objects >= 4 * n_objects * rt.OBJ_W
    assert lay.rec - lay.bounds >= 4 * n_objects * 8
    assert lay.bytes == lay.rec
    assert rt._scene_layout(tables).bytes == \
        lay.bytes + 4 * rt.KS_REC * rt.KS_THREADS
