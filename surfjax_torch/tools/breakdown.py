"""Where the main paths' time goes on a CUDA GPU.

    python -m surfjax_torch.tools.breakdown [SECTION ...]

SECTION is any of c3, crowd_demo, spheres, c3_primed, c4, fit (default:
all of them, in that order).

For each fidelity mode of the fused path's main path (see `workload`) it
times, with CUDA events and five calls each:
  * the kernel alone (`frame_fused` on device tensors) with every feature
    on, with AO off, with shadows off and with both off;
  * the whole `render_sequence` call;
and traces one call with `torch.profiler` for the device time, the device's
idle share of the call's wall time and the six dearest operations. For
each mode of the mesh main path (c4, split path) it times the whole
`render_sequence` call the same way and traces one call. For each mode of
the crowd main path (configs/crowd_demo.yaml) it times the kernel with the
same features switched off, and with every feature on but the crowd off
(one table-driven object per member), then the whole call, and traces one.
For the sphere crowds of 16, 64 and 256 members (`workload.sphere_crowd`,
1920x1080 x 8 frames, hard shadows, one point light, no AO) it times the
kernel alone, which visits the members through the crowd's loops.
For primed c3 it times `render` of one 1080p frame with and without
priming and traces one primed call. For the fit step (the pose fit on
configs/c5_anim.yaml, see `fit_bench`) at 256x256 and at 1920x1080 it
times runs of 10 steps on both backends and traces one run of 5 steps on
`pallas`: wall and device time per step, the device's idle share, and the
device time of K1 (`render_tile`) and K2 (`trace_rays`) inside a step; what
is left of the device time is the tensor kernels of the glue and of the
backward pass.

Prints the card's name, power limit, SM clock, power draw and temperature
before and after, one JSON line per mode, and a last JSON line with all of
it (times in ms per frame). Run it from the repo's root; it needs one
CUDA card. It imports whichever `surfjax_torch` comes first on the path,
so the same sections time another checkout when run as a file with that
checkout on PYTHONPATH:

    PYTHONPATH=build/parent python surfjax_torch/tools/breakdown.py crowd_demo
"""

from __future__ import annotations

import json
import sys
import time

import torch

from surfjax_torch.api import render, render_sequence
from surfjax_torch.config import load_config
from surfjax_torch.core.scene_compile import params_to_device
from surfjax_torch.kernels.render_tile import SceneTensors, frame_fused
from surfjax_torch.tools.workload import cam_rows_of, crowd_main_path, \
    cuda_ms, gpu_line, main_path, mesh_main_path, reframe

_CARD = "name,power.limit,clocks.sm,power.draw,temperature.gpu"
REPS = 5
TOP = 10


def profile_call(call, pick=()) -> dict:
    """One traced call -> wall ms, device ms (every kernel, copy and set
    the card ran), idle share, the dearest device operations and, for each
    substring in `pick`, the device ms of the operations whose name holds
    it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per_op = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_op[e.name] = per_op.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    device = sum(per_op.values())
    top = sorted(((ms, name[:60]) for name, ms in per_op.items()),
                 reverse=True)[:TOP]
    out = {"wall_ms": wall, "device_ms": device,
           "idle_share": 1.0 - device / wall, "top": top}
    for sub in pick:
        out[sub] = sum(ms for name, ms in per_op.items() if sub in name)
    return out


def fused_path(label: str, workload, dev, variants, res) -> None:
    """One fused main path: per mode the kernel alone in every variant of
    `variants(base)` (name, settings), the whole call, and a traced call;
    results into res[f"{label} {mode}"], ms per frame."""
    scene, camera, Rs, ps, modes = workload
    static, params = scene.freeze()
    scene_t = SceneTensors(static, params_to_device(params, dev))
    rows = cam_rows_of(Rs, ps, dev)
    F = len(ps)
    for mode, base in modes.items():
        out = {}
        for name, st in variants(base):
            frame_fused(scene_t, st, camera.intrinsics, rows)
            torch.cuda.synchronize()
            ms, _ = cuda_ms(lambda st=st: frame_fused(
                scene_t, st, camera.intrinsics, rows), REPS)
            out[f"kernel_{name}"] = [t / F for t in ms]
        call = lambda base=base: render_sequence(scene, camera, (Rs, ps),
                                                 base, device=dev)
        call()
        torch.cuda.synchronize()
        ms, _ = cuda_ms(call, REPS)
        out["render_sequence"] = [t / F for t in ms]
        out["profile"] = profile_call(call)
        res[f"{label} {mode}"] = out
        print(f"{label} {mode}", json.dumps(out), flush=True)


def features_off(base):
    return (("full", base), ("no_ao", base.with_(ao=False)),
            ("no_shadows", base.with_(shadows=False)),
            ("no_ao_no_shadows", base.with_(ao=False, shadows=False)))


def crowd_variants(base):
    """features_off, and every feature on with the crowd off."""
    return features_off(base) + (
        ("full_crowd_off", base.with_(vector_objects=False)),)


def sphere_crowds(dev, res) -> None:
    """The kernel alone on the sphere crowds at 1920x1080 x 8 frames, ms
    per frame of REPS launches; results into res[f"spheres {n}"]."""
    import numpy as np
    import surfjax_torch.api as api
    from surfjax_torch.tools.workload import poses, sphere_crowd
    rng = np.random.default_rng(0)
    for n in (16, 64, 256):
        scene, camera, st = sphere_crowd(api, n, size=(1920, 1080))
        Rs, ps = poses(camera, 8, rng.normal(0.0, 1e-3, (8, 3)))
        static, params = scene.freeze()
        scene_t = SceneTensors(static, params_to_device(params, dev))
        rows = cam_rows_of(Rs, ps, dev)
        st = st.with_(vector_objects=True)
        call = lambda: frame_fused(scene_t, st, camera.intrinsics, rows)  # noqa
        call()
        torch.cuda.synchronize()
        res[f"spheres {n}"] = {"kernel_full": [t / 8 for t in
                                               cuda_ms(call, REPS)[0]]}
        print(f"spheres {n}", json.dumps(res[f"spheres {n}"]), flush=True)


def fit_steps(dev, res) -> None:
    """The pose-fit step on c5 at two sizes: ms per step on both backends
    (fastest of REPS runs of 10 steps, one synchronisation each) and one
    traced run of 5 pallas steps; results into res[f"fit step {size}"]."""
    from surfjax_torch.tools.fit_bench import bench_backend, pose_step_fn
    kernels = ("sp_render_tile_kernel", "sp_trace_rays_kernel")
    for size in ((256, 256), (1920, 1080)):
        out = {be: bench_backend(be, 10, REPS if be == "pallas" else 1,
                                 size=size, device=dev)["step_ms"]
               for be in ("pallas", "jnp")}
        n = 5
        step, x0, state0, _ = pose_step_fn("pallas", n, size, dev)

        def run():
            x, state = x0, state0
            for _ in range(n):
                x, state, _ = step(x, state)
        run()
        prof = profile_call(run, pick=kernels)
        out["profile_per_step"] = {
            k: (v / n if isinstance(v, float) and k != "idle_share" else v)
            for k, v in prof.items() if k != "top"}
        out["top_of_5_steps"] = prof["top"]
        res[f"fit step {size[0]}x{size[1]}"] = out
        print(f"fit step {size[0]}x{size[1]}", json.dumps(out), flush=True)


def c3_primed(dev, res) -> None:
    """primed c3: render() of one 1080p frame with and without priming,
    and one traced primed call."""
    scene, camera, st, _ = load_config("configs/c3_sdf.yaml")
    camera = reframe(camera, 1920, 1080)
    st = st.with_(backend="pallas")
    out = {}
    for name, st_p in (("primed", st.with_(prime=True)), ("unprimed", st)):
        call = lambda st_p=st_p: render(scene, camera, st_p, device=dev)
        call()
        torch.cuda.synchronize()
        out[f"render_{name}"] = cuda_ms(call, REPS)[0]
    out["profile"] = profile_call(lambda: render(
        scene, camera, st.with_(prime=True), device=dev))
    res["c3 primed"] = out
    print("c3 primed", json.dumps(out), flush=True)


def c4(dev, res) -> None:
    """The mesh main path: the whole call per mode, and a traced one."""
    scene, camera, Rs, ps, modes = mesh_main_path("configs/c4_mesh.yaml")
    F = len(ps)
    for mode, st in modes.items():
        call = lambda st=st: render_sequence(scene, camera, (Rs, ps), st,
                                             device=dev)
        call()
        torch.cuda.synchronize()
        ms, _ = cuda_ms(call, REPS)
        out = {"render_sequence": [t / F for t in ms],
               "profile": profile_call(call)}
        res[f"c4 {mode}"] = out
        print(f"c4 {mode}", json.dumps(out), flush=True)


SECTIONS = {
    "c3": lambda dev, res: fused_path(
        "c3", main_path("configs/c3_sdf.yaml"), dev, features_off, res),
    "crowd_demo": lambda dev, res: fused_path(
        "crowd_demo", crowd_main_path("configs/crowd_demo.yaml"), dev,
        crowd_variants, res),
    "spheres": sphere_crowds,
    "c3_primed": c3_primed,
    "c4": c4,
    "fit": fit_steps,
}


def main(argv=None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or list(SECTIONS)
    unknown = [n for n in names if n not in SECTIONS]
    if unknown:
        raise SystemExit(f"breakdown: unknown sections {unknown}; "
                         f"choose from {list(SECTIONS)}")
    if not torch.cuda.is_available():
        raise SystemExit("breakdown: torch.cuda.is_available() is false")
    print(gpu_line(_CARD), flush=True)
    dev = torch.device("cuda", 0)
    res = {}
    for name in names:
        SECTIONS[name](dev, res)
    print(gpu_line(_CARD), flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
