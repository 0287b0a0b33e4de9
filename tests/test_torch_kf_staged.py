"""The staged fused-frame kernel's schedule (csrc/kf_staged.cuh) on the
CPU, where no CUDA kernel runs.

The kernel keeps KF's per-pixel arithmetic and changes only where it
runs: persistent blocks take 16x8-pixel tiles (frame, tile row, tile
column) from a counter, one thread per pixel, with the scene staged in
shared memory. `staged_frame` below is that schedule in plain PyTorch:
tile by tile in the counter's order, each tile's pixels through the twin's
own per-pixel work (`fused_pixels`) on those pixels alone; it must equal
`frame_fused_reference` to the bit on every scene the kernel renders. The
layout tests hold the shared-memory budget the launch asks for against the
scene's size, and the constants of the Python side against the kernels'
sources.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import surfjax_torch.api as pt_api  # noqa: E402
from surfjax_torch.config import load_config  # noqa: E402
from surfjax_torch.kernels import render_tile as rt  # noqa: E402
from surfjax_torch.tools import workload  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "surfjax_torch", "kernels", "csrc")
EXACT = dict(secondary_lod_iters=0, ao_lod_iters=0, over_relax=1.0)
SMEM_MAX = 232448          # bytes of shared memory one H100 block may use


def unboundable_scene(api, size=(40, 30), soft=True):
    """An SDF plane (marched, no bounding sphere) under an SDF sphere and a
    smooth blob, an analytic box, AO and soft or hard shadows of a point
    light with a radius and a directional light."""
    scene = api.Scene()
    scene.add(api.Plane(normal=(0.0, 1.0, 0.0), offset=-1.0),
              api.Material.lambert((0.5, 0.5, 0.55)), engine="sdf")
    scene.add(api.Sphere(center=(0.4, -0.3, 3.0), radius=0.6),
              api.Material.blinn_phong(albedo=(0.8, 0.3, 0.3), shininess=16),
              engine="sdf")
    scene.add(api.smooth_union(
        api.Sphere(center=(-0.8, -0.5, 3.4), radius=0.45),
        api.Box(center=(-0.6, -0.2, 3.6), half_extents=(0.3, 0.3, 0.3)),
        0.2), api.Material.lambert((0.3, 0.7, 0.4)), engine="sdf")
    scene.add(api.Box(center=(1.3, -0.6, 4.0), half_extents=(0.3, 0.4, 0.3)),
              api.Material.lambert((0.3, 0.3, 0.8)))
    scene.add_light(api.PointLight(position=(2.0, 4.0, 0.0), radius=0.3))
    scene.add_light(api.DirectionalLight(direction=(-0.3, -1.0, 0.4)))
    cam = api.Camera.pinhole(size[0], size[1], fov_y_deg=50.0,
                             position=(0.0, 0.6, -0.5), target=(0.0, -0.3, 3.0))
    st = api.RenderSettings(shadows=True, soft_shadows=soft, ao=True,
                            ao_samples=5, backend="pallas", max_steps=64,
                            shadow_steps=48)
    return scene, cam, st


def many_objects_scene(api, size=(40, 30)):
    """63 SDF spheres over an analytic floor: 64 objects outside any
    crowd, the most the kernels take; AO and soft shadows."""
    return workload.sphere_crowd(api, 63, size=size, ao=True, ao_samples=3,
                                 soft_shadows=True)


def _config(name, size, **over):
    scene, cam, st, _ = load_config(os.path.join(ROOT, "configs",
                                                 name + ".yaml"))
    return scene, workload.reframe(cam, *size), st.with_(backend="pallas",
                                                         **over)


CASES = {
    "c1": lambda: _config("c1_sphere", (32, 24)),
    "c2": lambda: _config("c2_csg", (32, 24)),
    "c5": lambda: _config("c5_anim", (32, 24)),
    "c3 value": lambda: _config("c3_sdf", (32, 24)),
    "c3 value_exact": lambda: _config("c3_sdf", (32, 24), **EXACT),
    "c3 ragged 37x23": lambda: _config("c3_sdf", (37, 23)),
    "unboundable soft": lambda: unboundable_scene(pt_api),
    "unboundable hard": lambda: unboundable_scene(pt_api, soft=False),
    "64 objects": lambda: many_objects_scene(pt_api),
}


def _frame(case):
    scene, cam, st = CASES[case]()
    static, params = scene.freeze()
    params = {k: torch.as_tensor(v) for k, v in params.items()}
    R = np.asarray(cam.rotation, np.float32).reshape(1, 9)
    pos = np.asarray(cam.position, np.float32).reshape(1, 3)
    rows = torch.as_tensor(np.concatenate([R, pos], axis=1))
    return rt.SceneTensors(static, params), st, cam.intrinsics, rows


# ---------------------------------------------------------------------------
# The tile schedule in plain PyTorch
# ---------------------------------------------------------------------------

def tile_items(F: int, H: int, W: int):
    """The tiles in the counter's order, as kf_staged_kernel decodes an
    item -> (frame, tile row, tile column) each."""
    gx, gy = -(-W // 16), -(-H // 8)
    return [(item // (gx * gy), (item // gx) % gy, item % gx)
            for item in range(gx * gy * F)]


def tile_pixels(ty: int, tx: int, H: int, W: int):
    """Thread tid's pixel (i, j) of tile (ty, tx), tid 0..127, and which
    of them lie in the frame."""
    tid = torch.arange(rt.KS_THREADS)
    i, j = ty * 8 + tid // 16, tx * 16 + tid % 16
    return i, j, (i < H) & (j < W)


def staged_frame(scene_t, settings, intr, cam_rows, t0=None):
    """F frames in the staged kernel's order: tile by tile, each tile's
    pixels in the frame through fused_pixels alone, written into the nine
    (F, H, W) buffers; every pixel is written exactly once."""
    F, H, W = cam_rows.shape[0], intr.height, intr.width
    o3, d3 = rt.frame_rays(intr, cam_rows)
    out = [torch.full((F * H * W,), float("nan")) for _ in range(9)]
    written = torch.zeros(F * H * W, dtype=torch.int64)
    for f, ty, tx in tile_items(F, H, W):
        i, j, keep = tile_pixels(ty, tx, H, W)
        idx = (f * H + i[keep]) * W + j[keep]
        o = tuple(c.reshape(-1)[idx] for c in o3)
        d = tuple(c.reshape(-1)[idx] for c in d3)
        got = rt.fused_pixels(scene_t, settings, o, d,
                              None if t0 is None else t0.reshape(-1)[idx])
        for buf, x in zip(out, got):
            buf[idx] = x
        written[idx] += 1
    assert bool((written == 1).all())
    return tuple(buf.reshape(F, H, W) for buf in out)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_staged_schedule_equals_twin(case):
    """The tile schedule equals the twin bitwise on every buffer."""
    scene_t, st, intr, rows = _frame(case)
    ref = rt.frame_fused_reference(scene_t, st, intr, rows)
    got = staged_frame(scene_t, st, intr, rows)
    for name, a, b in zip(("r", "g", "b", "depth", "obj", "nx", "ny", "nz",
                           "hit"), got, ref):
        assert torch.equal(a, b), name
    assert 0.05 < float(ref[8].mean()) < 1.0


def test_staged_schedule_equals_twin_primed():
    """c3 primed (t0 from the port's prime_frame) at 48x48, two frames:
    the tiles of the second frame follow all of the first's."""
    scene, cam, st = _config("c3_sdf", (48, 48), prime=True, prime_min=32)
    static, params = scene.freeze()
    params = {k: torch.as_tensor(v) for k, v in params.items()}
    R = torch.as_tensor(np.asarray(cam.rotation, np.float32).reshape(9))
    pos = torch.as_tensor(np.asarray(cam.position, np.float32))
    pos2 = pos + torch.tensor([0.02, 0.0, -0.01])
    t0 = torch.stack([rt.prime_frame(static, cam.intrinsics, st, params, R,
                                     p) for p in (pos, pos2)])
    rows = torch.stack([torch.cat([R, p]) for p in (pos, pos2)])
    scene_t = rt.SceneTensors(static, params)
    ref = rt.frame_fused_reference(scene_t, st, cam.intrinsics, rows, t0)
    got = staged_frame(scene_t, st, cam.intrinsics, rows, t0)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert bool((t0 < st.t_max).any())
    assert not torch.equal(ref[3][0], ref[3][1])


@pytest.mark.parametrize("F, H, W", [(1, 1080, 1920), (3, 23, 37),
                                     (2, 8, 16), (1, 1, 1)])
def test_tiles_cover_each_pixel_once(F, H, W):
    """The counter's items cover every pixel of every frame exactly once,
    ragged edges included; items run frame by frame, then row-major over
    the tiles, and a thread's pixel is row-major inside its tile."""
    items = tile_items(F, H, W)
    assert len(items) == F * -(-H // 8) * -(-W // 16)
    assert items == sorted(items)
    seen = torch.zeros(F * H * W, dtype=torch.int64)
    for f, ty, tx in items:
        i, j, keep = tile_pixels(ty, tx, H, W)
        assert bool(keep[0]) and int(i[16]) == ty * 8 + 1
        seen[(f * H + i[keep]) * W + j[keep]] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("case", ["c3 value", "64 objects"])
def test_shared_memory_budget(case):
    """The launch's shared memory is the tile slot, the staged scene (its
    tables and two bounding spheres per object) and the pixels' records:
    c3 stays under the 48 KB a block gets without opting in, the
    64-object scene within the H100's 227 KB; the AO taps take none."""
    scene_t, st, _, _ = _frame(case)
    tables, counts = rt._scene_tables(scene_t, st, torch.device("cpu"))
    lay = rt._scene_layout(tables)
    assert lay.bytes <= SMEM_MAX
    if case == "c3 value":
        assert lay.bytes <= 48 * 1024
    objects, nodes, leaves, order = tables[:4]
    scene_words = (objects.numel() + nodes.numel() + leaves.numel()
                   + order.numel() + tables[6].numel() + tables[7].numel()
                   + 8 * objects.shape[0])
    fixed = 16 + 4 * rt.KS_REC * rt.KS_THREADS
    assert 0 <= lay.bytes - fixed - 4 * scene_words < 16 * 7
    assert rt._scene_layout(rt._scene_tables(
        scene_t, st.with_(ao_samples=9), torch.device("cpu"))[0]).bytes == \
        lay.bytes


def test_layout_sections_are_aligned_and_disjoint():
    lay = rt.staged_layout(3, 7, 5, 6, 5, 2)
    names = [f for f, _ in rt.KSLayout._fields_[6:]]
    offs = [getattr(lay, f) for f in names] + [lay.bytes]
    assert all(x % 16 == 0 for x in offs)
    assert all(a <= b for a, b in zip(offs, offs[1:]))
    assert lay.objects - lay.ctr >= 4 * rt.KS_CTR
    assert lay.rec - lay.bounds >= 4 * 8 * 3
    assert lay.bytes - lay.rec == 4 * rt.KS_REC * rt.KS_THREADS


def test_header_constants_match():
    """The Python side's record width, block, layout and profile phases
    are the kernels' sources'."""
    with open(os.path.join(CSRC, "kf_staged.cuh")) as fh:
        src = fh.read()
    with open(os.path.join(CSRC, "kf_frame_prof.cu")) as fh:
        prof_src = fh.read()

    def enum_len(text, last):
        body = re.search(r"enum \{([^}]*\b%s\b[^}]*)\}" % last,
                         text).group(1)
        names = [x.split("=")[0].strip() for x in body.split(",")]
        return names.index(last)

    assert enum_len(src, "KS_REC") == rt.KS_REC
    assert int(re.search(r"#define KP_OBJ (\d+)", src).group(1)) == rt.KP_OBJ
    assert int(re.search(r"#define KP_LIGHTS (\d+)", src).group(1)) == \
        rt.KP_LIGHTS
    assert int(re.search(r"#define KS_THREADS (\d+)", src).group(1)) == \
        rt.KS_THREADS
    # KP_PHASES and KF_PROF_PHASES as their enums count them
    assert len(rt.KP_PHASE_NAMES) == \
        1 + rt.KP_OBJ + 3 + rt.KP_OBJ + 1 + rt.KP_LIGHTS * rt.KP_OBJ + 2
    assert len(rt.KF_PROF_NAMES) == 4 + rt.KP_LIGHTS + 2
    assert "PF_SHADE = PF_VIS + KP_LIGHTS, PF_WRITE, KF_PROF_PHASES" in \
        prof_src
    struct = re.search(r"struct KSLayout \{([^}]*)\}", src).group(1)
    fields = re.findall(r"\w+", struct.replace("int", ""))
    assert fields == [f for f, _ in rt.KSLayout._fields_]
