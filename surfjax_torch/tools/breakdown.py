"""Where the main paths' time goes on a CUDA GPU.

    python -m surfjax_torch.tools.breakdown [SECTION ...]

SECTION is any key of SECTIONS below (default: all of them, in that
order).

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
priming and traces one primed call. `sequence` runs the sequence main
paths (c4, crowd-mesh, primed c3 at 1080p x 16 frames) through
render_sequence: launches, peak memory, ms/frame and the device's busy
share of a traced call. `kf` times the fused kernel through its
wrapper on c3 (48 frames, both modes) and on primed c3 (frame 0 with its
t0). `kf_phases` profiles the staged kernel on frame 0 of c3 in both
modes (its profiling instantiation): per phase the share of the warps'
cycles, the SIMT efficiency of its loops (lanes that evaluate an SDF per
trip, over 32) and the SDF evaluations per hit pixel, beside the share of
each call of kf_frame_kernel<false>, the per-pixel kernel it replaced, and
the kernels' ptxas lines. `split` times each split kernel of one 1080p c4
frame in `ao` mode, launched back to back (as chip_smoke.py's phase 7),
`split_fit` K1 and K2 in a 1080p fit step, `split_crowd` K1, K2 and
ao_fix with a crowd on frame 0 of the crowd-mesh path (both modes; also
K1 with AO off, K2 on empty segments, ao_fix with need 0, ao_fix's vote
counted from its need and its profiling instantiation's phases and
skipped warps, the whole 16-frame call, and the crowd ao_fix's ptxas
line) and `prime` the priming kernel on c3 the same way; `split_phases`
profiles K1, K2 and ao_fix (chip_smoke.py's phase 17) and
`prime_phases` the priming kernel on the primed 1080p frame of c3 (phase
18: per phase shares, the SM clock, the cycles per warp and the slowest
warp's rays alone); `probe_phases` goes inside the FP32 probe's mixes
(fp32_peak.py) at its defaults, each build and unroll: the kernel's time,
its profiling instantiation's SM clock (clock64 over %globaltimer), cycles
per substep per warp, the warps' finish times and the SMs' busy share, the
trip loop's SASS per substep by pipe (its fast path: the slow paths' CALL
blocks left out), ptxas' line, blocks per SM, the issue bound at the
measured clock and the operations bound; then fma_dep against the peak at
that clock, and nvidia-smi's SM clock under each; `wide` times the
kernels' KF_WIDE build at 1080p
with AO off and on: KF on compile_scaling's 129 spheres and, with a
crowd, on workload.limit_cases' `crowd 120+8+70` (71 objects outside the
crowd), and K1 on the camera's rays of `120+8` (129 objects) and of
`crowd 120+8+70`; `sass` hashes every
entry's SASS, to compare two builds. `caps` runs frame 0 of c3 at 1920x1080
(`value`) on the split path under the cap variants of surfjax's
tools/cap_sweep.py (CAP_VARIANTS): per variant the frame
(render_rays_pallas on its flat rays), K1 and K2 and their residual
re-runs launched back to back, and the share of 128-ray rows each re-run
takes; beside them KF on the same frame and the uncapped split path,
timed first and last; for the uncapped frame and the two variants with
both caps, each launch's operations (the plain version's count_ops) and
bytes.
For the fit step (the pose fit on configs/c5_anim.yaml, see `fit_bench`)
at 256x256 and at 1920x1080 it times runs of 10 steps on both backends and
traces one run of 5 steps on `pallas`: wall and device time per step, the
device's idle share, and the device time of K1 (`render_tile`) and K2
(`trace_rays`) inside a step; what is left of the device time is the
tensor kernels of the glue and of the backward pass.

Prints the card's name, power limit, SM clock, power draw and temperature
before and after, one JSON line per mode, and a last JSON line with all of
it (times in ms per frame). Run it from the repo's root; it needs one
CUDA card. It imports whichever `surfjax_torch` comes first on the path,
so the same sections time another checkout when run as a file with that
checkout on PYTHONPATH:

    PYTHONPATH=build/parent python surfjax_torch/tools/breakdown.py crowd_demo
"""

from __future__ import annotations

import dataclasses
import functools
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
LAUNCHES = 10   # back-to-back launches per timed sample of a split kernel
TOP = 10


def profile_call(call, pick=(), cpu_pick=()) -> dict:
    """One traced call -> wall ms, device ms (every kernel, copy and set
    the card ran), idle share, the dearest device operations, for each
    substring in `pick` the device ms of the operations whose name holds
    it and, under "cpu " + substring for each in `cpu_pick`, the host ms
    of the host events (operators and runtime calls) whose name holds
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
    per_op, per_cpu = {}, {}
    for e in prof.events():
        acc = per_op if e.device_type == DeviceType.CUDA else per_cpu
        acc[e.name] = acc.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    device = sum(per_op.values())
    top = sorted(((ms, name[:60]) for name, ms in per_op.items()),
                 reverse=True)[:TOP]
    out = {"wall_ms": wall, "device_ms": device,
           "idle_share": 1.0 - device / wall, "top": top}
    for sub in pick:
        out[sub] = sum(ms for name, ms in per_op.items() if sub in name)
    for sub in cpu_pick:
        out[f"cpu {sub}"] = sum(ms for name, ms in per_cpu.items()
                                if sub in name)
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
    kernels = ("sp_staged_render_tile_kernel", "sp_staged_trace_rays_kernel")
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


C3 = "configs/c3_sdf.yaml"
SEQ_FRAMES = 16


def sequence(dev, res) -> None:
    """The sequence main paths at 1920x1080 x SEQ_FRAMES frames through
    render_sequence: c4 (`config`, `ao`), crowd-mesh (`config`, `soft`)
    and primed c3 (`value`, prime=True). Per path the first call's
    launches per kernel and the card's peak memory above what was
    allocated before it, REPS calls timed with CUDA events (ms/frame) and
    one traced call (device ms per frame and the device's busy share).
    It reads only the entry point and the wrappers' counters, so it times
    a checkout that renders frame by frame the same way."""
    from surfjax_torch.kernels import mesh_tile as mt, render_tile as rt
    from surfjax_torch.tools.workload import crowd_mesh_main_path
    wrappers = {"frame_fused": rt.frame_fused, "prime_tile": rt.prime_tile,
                "render_tile": rt.render_tile, "trace_rays": rt.trace_rays,
                "ao_fix": rt.ao_fix, "mesh_tile": mt.mesh_tile,
                "render_tile_crowd": rt.render_tile.crowd,
                "trace_rays_crowd": rt.trace_rays.crowd,
                "ao_fix_crowd": rt.ao_fix.crowd}
    F = SEQ_FRAMES
    paths = [("c4", mesh_main_path("configs/c4_mesh.yaml", F)),
             ("crowd_mesh", crowd_mesh_main_path(F))]
    cases = [(f"{name} {mode}", scene, camera, Rs, ps, st)
             for name, (scene, camera, Rs, ps, modes) in paths
             for mode, st in modes.items()]
    scene, camera, Rs, ps, modes = main_path(C3, F)
    cases.append(("c3 primed", scene, camera, Rs, ps,
                  modes["value"].with_(prime=True)))
    for label, scene, camera, Rs, ps, st in cases:
        call = functools.partial(render_sequence, scene, camera, (Rs, ps),
                                 st, device=dev)
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        launches = {k: w.launches for k, w in wrappers.items() if w.launches}
        ms, _ = cuda_ms(call, REPS)
        prof = profile_call(call)
        out = {"ms_per_frame": [t / F for t in ms], "launches": launches,
               "peak_bytes": peak,
               "device_ms_per_frame": prof["device_ms"] / F,
               "wall_ms_per_frame": prof["wall_ms"] / F,
               "busy_share": 1.0 - prof["idle_share"], "top": prof["top"]}
        res[f"sequence {label}"] = out
        print(f"sequence {label}", json.dumps(out), flush=True)


def _c3_frame0(dev):
    """c3 at 1920x1080 as the main path has it -> (scene_t, camera, modes,
    the 48 frames' rows, frame 0's row)."""
    scene, camera, Rs, ps, modes = main_path(C3)
    static, params = scene.freeze()
    scene_t = SceneTensors(static, params_to_device(params, dev))
    rows = cam_rows_of(Rs, ps, dev)
    return scene_t, camera, modes, rows, rows[:1].contiguous()


def _primed_t0(scene_t, camera, st, row):
    from surfjax_torch.kernels.render_tile import prime_frame
    return prime_frame(scene_t.static, camera.intrinsics,
                       st.with_(prime=True), scene_t.params, row[0, :9],
                       row[0, 9:])[None]


def kf(dev, res) -> None:
    """The fused kernel through its wrapper (whichever package is
    imported) on c3 (48 frames, both modes) and primed c3 (frame 0 with its
    t0); ms per frame of REPS launches."""
    scene_t, camera, modes, rows, row0 = _c3_frame0(dev)
    intr = camera.intrinsics
    cases = [(mode, st, rows, None) for mode, st in modes.items()]
    st_p = modes["value"]
    cases.append(("primed", st_p, row0, _primed_t0(scene_t, camera, st_p,
                                                   row0)))
    for mode, st, r, t0 in cases:
        n = r.shape[0]
        call = lambda: frame_fused(scene_t, st, intr, r, t0)  # noqa: E731
        call()
        torch.cuda.synchronize()
        out = {"wrapper": [t / n for t in cuda_ms(call, REPS)[0]]}
        res[f"kf {mode}"] = out
        print(f"kf {mode}", json.dumps(out), flush=True)


def phase_table(prof, hits: float, static, names) -> dict:
    """A profile (warps, phases, 3) whose first phases are `names` ->
    {phase: {cycles_share, trips, simt, evals_per_hit}} for the phases that
    took cycles or ran a loop, objects named by index, engine and tape, and
    the groups' totals (a group: the phases whose names share the first
    word)."""
    from surfjax_torch.kernels.render_tile import KP_OBJ
    tot = prof[:, :len(names)].sum(dim=0).double().cpu()
    cycles = float(tot[:, 0].sum())
    objs = static.ir.objects
    label = {f"o{k}": f"o{k} ({'sdf' if o.engine else 'analytic'}, "
             f"{len(o.nodes)} nodes)" for k, o in enumerate(objs[:KP_OBJ])}
    rows, groups = {}, {}
    for k, name in enumerate(names):
        cyc, trips, lanes = (float(x) for x in tot[k])
        if cyc == 0.0 and trips == 0.0:
            continue
        words = name.split()
        nice = " ".join(label.get(w, w) for w in words)
        rows[nice] = {"cycles_share": cyc / cycles, "trips": trips,
                      "simt": lanes / (32.0 * trips) if trips else None,
                      "evals_per_hit": lanes / hits if hits else None}
        g = groups.setdefault(words[0], [0.0, 0.0, 0.0])
        for i, x in enumerate((cyc, trips, lanes)):
            g[i] += x
    rows["groups"] = {
        g: {"cycles_share": c / cycles,
            "simt": ln / (32.0 * t) if t else None,
            "evals_per_hit": ln / hits if hits else None}
        for g, (c, t, ln) in groups.items()}
    return rows


def kf_phases(dev, res) -> None:
    """Frame 0 of c3 at 1080p, both modes: the profiles of the staged
    kernel (its profiling instantiation; per phase cycles, loop trips and
    lanes) and of kf_frame_kernel<false>, the per-pixel kernel it replaced
    (its body with a probe after each call; cycles per call) -> the phase
    tables, the profiled kernels' ms beside the staged kernel's plain ms,
    and the ptxas lines. Both profiled kernels must write the production
    kernel's buffers. The staged kernel's blocks are persistent: their
    staging, once per block for many tiles, is outside its table."""
    from surfjax_torch.kernels import _build
    from surfjax_torch.kernels.render_tile import (
        KF_PROF_NAMES, KP_PHASE_NAMES, frame_profile_launcher,
        staged_launcher,
    )
    info = _build.build()
    ptxas = {k: v for k, v in _build.entries(info["log"]).items()
             if "kf_staged_kernel" in k or "kf_frame_prof" in k}
    print("kf phases ptxas", json.dumps(ptxas), flush=True)
    scene_t, camera, modes, _, row0 = _c3_frame0(dev)
    intr = camera.intrinsics
    for mode, st in modes.items():
        plain, ref, _ = staged_launcher(scene_t, st, intr, row0)
        plain()
        ms = cuda_ms(plain, REPS)[0]
        hits = float(ref[8].sum())
        for kernel, (launch, out, prof), names in (
                ("staged", staged_launcher(scene_t, st, intr, row0,
                                           profile=True), KP_PHASE_NAMES),
                ("per_pixel", frame_profile_launcher(scene_t, st, intr,
                                                     row0), KF_PROF_NAMES)):
            launch()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                raise AssertionError(f"the {kernel} profile's buffers differ "
                                     "from the staged kernel's")
            entry = {"ms_profiled": cuda_ms(launch, REPS)[0],
                     "ms_staged": ms, "hit_pixels": hits,
                     "phases": phase_table(prof, hits, scene_t.static,
                                           names)}
            res[f"kf phases {mode} {kernel}"] = entry
            print(f"kf phases {mode} {kernel}", json.dumps(entry),
                  flush=True)


C4 = "configs/c4_mesh.yaml"


def _c4_frame0_calls(dev):
    """Every split kernel call of frame 0 of c4 at 1080p -> ({mode: [(the
    wrapper's name, args), ...]}, the scene's static part, the modes'
    settings)."""
    from surfjax_torch.tools.kernel_check import capture_calls
    scene, camera, Rs, ps, modes = mesh_main_path(C4)
    cam0 = dataclasses.replace(camera,
                               position=tuple(float(x) for x in ps[0]))
    out = {}
    for mode, st in modes.items():
        with capture_calls() as calls:
            render(scene, cam0, st, device=dev)
        out[mode] = list(calls)
    static, _ = scene.freeze()
    return out, static, modes


def _c4_mesh_calls(dev):
    """The mesh kernel's calls of frame 0 of c4 at 1080p -> {mode: [(label,
    args), ...]} (label "primary" or "shadow") and the scene's mesh and
    settings per mode."""
    calls, static, modes = _c4_frame0_calls(dev)
    out = {mode: [("shadow" if args[8] else "primary", args)
                  for kname, args in mcalls if kname == "mesh_tile"]
           for mode, mcalls in calls.items()}
    return out, static.mesh_static[0], modes


def tile_stats(counts, K: int) -> dict:
    """Candidates per tile: mean, p50, p90, max, tiles without any, and
    the overflow tiles (count > K, which scan the whole table)."""
    c = counts.double()
    return {"tiles": int(c.numel()), "mean": float(c.mean()),
            "p50": float(c.quantile(0.5)), "p90": float(c.quantile(0.9)),
            "max": int(c.max()), "empty": int((c == 0).sum()),
            "overflow": int((counts > K).sum())}


def mesh_profile_table(rec, tests, counts, K: int, tile_rays: int) -> dict:
    """The profiling instantiation's outputs of one call -> per phase the
    share of the warps' cycles, the test loop's SIMT efficiency
    (lane-tests over 32 x the candidates the warps visit), the lane-tests,
    and the share of the cycles spent by warps of overflow tiles."""
    from surfjax_torch.kernels.mesh_tile import MT_PHASE_NAMES
    cyc = rec[:, :, 0].double()
    total = float(cyc.sum())
    test = MT_PHASE_NAMES.index("test")
    trips, lanes = (float(rec[:, test, k].sum()) for k in (1, 2))
    chunks = int(rec[:, MT_PHASE_NAMES.index("vote"), 1].sum())
    warp_tile = torch.arange(rec.shape[0], device=rec.device) * 32 \
        // tile_rays
    over = (counts > K)[warp_tile]
    return {"cycles_share": {name: float(cyc[:, k].sum()) / total
                             for k, name in enumerate(MT_PHASE_NAMES)},
            "cycles_overflow_share": float(cyc[over].sum()) / total,
            "vote_chunks": chunks, "trips": trips, "lane_tests": lanes,
            "simt": lanes / (32.0 * trips) if trips else None,
            "tests_sum": int(tests.sum())}


def mesh_phases(dev, res) -> None:
    """Frame 0 of c4 at 1080p, both modes: for each mesh kernel call
    (primary, shadow) the production kernel's time (LAUNCHES back to
    back), the profiling instantiation's phase table and time, its
    outputs against the production kernel's (bitwise), its votes against
    mesh_warp_masks and its test count per lane against the culled
    mesh_tile_reference(count_tests=True, masks=) (both exactly), the
    candidates per tile, the culled algorithm's work (mesh_cull_count)
    beside the unculled lane-tests; then the instructions of the
    production kernel's loops in its SASS."""
    from surfjax_torch.kernels import _build
    from surfjax_torch.kernels.mesh_tile import (
        mesh_cull_count, mesh_tile_launcher, mesh_tile_reference,
        mesh_warp_masks,
    )
    from surfjax_torch.tools.kernel_check import flat
    calls, _, _ = _c4_mesh_calls(dev)
    for mode, mcalls in calls.items():
        for label, args in mcalls:
            cand, counts, o2 = args[1], args[2], args[3]
            K = cand.shape[1]
            tile_rays = o2[0].numel() // cand.shape[0]
            launch, out = mesh_tile_launcher(*args)
            launch()
            ms = cuda_ms(lambda: [launch() for _ in range(LAUNCHES)],
                         REPS)[0]
            plaunch, pout, (rec, tests, masks) = mesh_tile_launcher(
                *args, profile=True)
            plaunch()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(flat(pout),
                                                         flat(out))):
                raise AssertionError(f"{mode} {label}: the profile's outputs "
                                     "differ from the kernel's")
            votes = mesh_warp_masks(*args[:7], args[9])
            if not torch.equal(masks, votes.masks):
                raise AssertionError(f"{mode} {label}: the kernel's votes "
                                     "differ from mesh_warp_masks")
            ref_tests = mesh_tile_reference(*args, count_tests=True,
                                            masks=votes.masks)[-1]
            if not torch.equal(tests, ref_tests.to(torch.int32)):
                raise AssertionError(f"{mode} {label}: the profile counts "
                                     "other tests than count_tests")
            unculled = mesh_tile_reference(*args, count_tests=True)[-1]
            pms = cuda_ms(plaunch, REPS)[0]
            entry = {"ms": min(ms) / LAUNCHES, "ms_profiled": min(pms),
                     "candidates": tile_stats(counts, K),
                     "unculled_lane_tests": int(unculled.sum()),
                     "culled": mesh_cull_count(args, votes),
                     **mesh_profile_table(rec, tests, counts, K, tile_rays)}
            if entry["vote_chunks"] != entry["culled"]["vote_chunks"]:
                raise AssertionError(f"{mode} {label}: the kernel votes on "
                                     f"{entry['vote_chunks']} chunks, the "
                                     "count on "
                                     f"{entry['culled']['vote_chunks']}")
            res[f"mesh phases {mode} {label}"] = entry
            print(f"mesh phases {mode} {label}", json.dumps(entry),
                  flush=True)
    info = _build.build()
    for name in _build.entries(info["log"]):
        if "mt_mesh_tile_kernelILb0E" in name:
            loops = _build.sass_loops(info["path"], name)
            res[f"mesh sass {name}"] = loops
            print(f"mesh sass {name}", json.dumps(loops), flush=True)


def mesh_glue(dev, res) -> None:
    """The host glue around the mesh kernel on frame 0 of c4 at 1080p, per
    mesh call: mesh_candidates' device time (its tensor ops, from a traced
    call), its host time (wall time of the call, the queue empty before
    it), and the host's time inside its `nonzero` (which waits for the
    device: the sync), alone and in a traced render() of the frame."""
    from surfjax_torch.kernels.mesh_tile import mesh_candidates
    calls, ms_, modes = _c4_mesh_calls(dev)
    scene, camera, Rs, ps, _ = mesh_main_path(C4)
    cam0 = dataclasses.replace(camera,
                               position=tuple(float(x) for x in ps[0]))
    sync = ("nonzero", "Synchronize", "Memcpy")
    for mode, mcalls in calls.items():
        tile_rows = modes[mode].tile_rows
        for label, args in mcalls:
            tri, cand, counts, o2, d2, t_maxv, t_min = args[:7]
            fn = lambda: mesh_candidates(ms_, tri, o2, d2, t_min,  # noqa
                                         t_maxv, tile_rows)
            got = fn()
            if not (torch.equal(got[0], cand) and torch.equal(got[1],
                                                              counts)):
                raise AssertionError(f"{mode} {label}: mesh_candidates "
                                     "does not repeat the call's table")
            host = []
            for _ in range(REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                host.append((time.perf_counter() - t0) * 1e3)
            prof = profile_call(fn, cpu_pick=sync)
            entry = {"host_ms": host, "device_ms": prof["device_ms"],
                     "wall_ms_traced": prof["wall_ms"],
                     **{f"cpu_ms_{k}": prof[f"cpu {k}"] for k in sync}}
            res[f"mesh glue {mode} {label}"] = entry
            print(f"mesh glue {mode} {label}", json.dumps(entry), flush=True)
        call = lambda st=modes[mode]: render(scene, cam0, st,  # noqa: E731
                                             device=dev)
        call()
        prof = profile_call(call, pick=("mt_mesh_tile",), cpu_pick=sync)
        entry = {k: v for k, v in prof.items() if k != "top"}
        res[f"mesh glue {mode} render"] = entry
        print(f"mesh glue {mode} render", json.dumps(entry), flush=True)


def split(dev, res) -> None:
    """Each split kernel of one 1080p c4 frame in `ao` mode: ms per frame,
    every call of the frame launched back to back (LAUNCHES)."""
    from surfjax_torch.tools.kernel_check import KERNELS
    out = {}
    for kname, args in _c4_frame0_calls(dev)[0]["ao"]:
        out[kname] = out.get(kname, 0.0) + _launch_ms(
            KERNELS[kname][3](*args)[0])
    res["split c4 ao"] = out
    print("split c4 ao", json.dumps(out), flush=True)


def split_crowd(dev, res) -> None:
    """The split path's crowd kernels on frame 0 of the crowd-mesh path
    (`workload.crowd_mesh_main_path`) at 1080p, both modes: per kernel the
    frame's calls launched back to back (LAUNCHES), K1's with AO off, K2's
    on empty shadow segments, ao_fix's with need 0, its vote
    (ao_fix_votes) and its profile (ao_fix_profile); then the whole
    `render_sequence` call of its 16 frames, ms per frame; last, ptxas'
    line of ao_fix with a crowd."""
    from surfjax_torch.tools.kernel_check import KERNELS, capture_calls
    from surfjax_torch.tools.workload import crowd_mesh_main_path
    scene, camera, Rs, ps, modes = crowd_mesh_main_path()
    cam0 = dataclasses.replace(camera,
                               position=tuple(float(x) for x in ps[0]))
    for mode, st in modes.items():
        with capture_calls() as calls:
            render(scene, cam0, st, device=dev)
        out = {}
        for kname, args in calls:
            launcher = KERNELS[kname][3]
            out[kname] = out.get(kname, 0.0) + _launch_ms(
                launcher(*args)[0])
            if kname == "render_tile":
                key, alt = "render_tile ao off", launcher(
                    args[0], args[1].with_(ao=False), *args[2:])
            elif kname == "trace_rays":
                key, alt = "trace_rays empty segments", launcher(
                    *_empty_segments(args))
            elif kname == "ao_fix":
                key, alt = "ao_fix need 0", launcher(*_need_zero(args))
                out["ao_fix votes"] = ao_fix_votes(args)
                out["ao_fix profile"] = ao_fix_profile(args)
            else:
                continue
            out[key] = out.get(key, 0.0) + _launch_ms(alt[0])
        times, _ = cuda_ms(lambda st=st: render_sequence(
            scene, camera, (Rs, ps), st, device=dev), REPS)
        out["render_sequence ms/frame"] = [t / len(ps) for t in times]
        res[f"split crowd {mode}"] = out
        print(f"split crowd {mode}", json.dumps(out), flush=True)
    from surfjax_torch.kernels import _build
    for name, lines in _build.entries(_build.build()["log"]).items():
        if "ao_fix_kernel" in name:
            res[f"split crowd entry {name}"] = lines
            print(f"split crowd entry {name}", json.dumps(lines), flush=True)


def ao_fix_votes(args) -> dict:
    """An ao_fix call on a crowd scene, counted on the host from its need:
    the needing lanes' share of the lanes, the share of 32-lane warps that
    hold one (the others skip AO), and the members each of those warps
    keeps of the crowd's by its vote (split_warp_masks' ao_fix: mean,
    largest)."""
    from surfjax_torch.tools.kernel_check import masks_of
    need = args[4].reshape(-1) > 0.5
    masks = masks_of("ao_fix", args)
    mean, top = masks.counts()["ao"]
    return {"lanes": need.numel(), "need_share": float(need.float().mean()),
            "warps": masks.hit_warps.numel(),
            "warp_share": float(masks.hit_warps.float().mean()),
            "members": masks.masks["ao"].shape[1],
            "masked_per_warp": [mean, top]}


def ao_fix_profile(args) -> dict:
    """ao_fix with a crowd's profiling instantiation (csrc/ao_fix_crowd.cu)
    on one call: its time launched back to back, its output against the
    production kernel's (bitwise), per phase (AF_PHASE_NAMES) the share of
    the cycles of all warps and of the warps that ran AO, those warps'
    mean cycles, and the warps that skipped AO (held to the vote's count of
    warps without a needing lane)."""
    from surfjax_torch.kernels import render_tile as rt
    from surfjax_torch.tools.kernel_check import KERNELS, masks_of
    launch, out, prof = rt.crowd_ao_fix_launcher(args[0], args[1], args[2:],
                                                 profile=True)
    launch()
    ref_launch, ref = KERNELS["ao_fix"][3](*args)
    ref_launch()
    torch.cuda.synchronize()
    if not torch.equal(out[0], ref[0]):
        raise AssertionError("ao_fix's profile differs from the kernel")
    skipped = prof[:, -1] > 0
    ran = int(masks_of("ao_fix", args).hit_warps.sum())
    if int((~skipped).sum()) != ran:
        raise AssertionError(f"{int((~skipped).sum())} warps ran AO, the "
                             f"vote has {ran} with a needing lane")
    cyc = prof[:, :-1].double()

    def shares(c):
        return {k: float(v) for k, v in zip(rt.AF_PHASE_NAMES,
                                            c / max(float(c.sum()), 1.0))}

    return {"ms_profiled": _launch_ms(launch), "warps": prof.shape[0],
            "skipped": int(skipped.sum()),
            "skipped_share": float(skipped.double().mean()),
            "share": shares(cyc.sum(0)),
            "share_ran": shares(cyc[~skipped].sum(0)),
            "cycles_per_warp_ran": float(cyc[~skipped].sum(1).mean())
            if ran else 0.0,
            "cycles_per_warp_skipped": float(cyc[skipped].sum(1).mean())
            if bool(skipped.any()) else 0.0}


def _fit_calls(dev, size=(1920, 1080)):
    """The K1 and K2 calls of one pose-fit step on c5 at `size`."""
    from surfjax_torch.tools.fit_bench import pose_step_fn
    from surfjax_torch.tools.kernel_check import capture_calls
    step, x0, state0, _ = pose_step_fn("pallas", 60, size, dev)
    with capture_calls() as calls:
        step(x0, state0)
    return calls


def _split_cases(dev) -> dict:
    """The K1, K2 and ao_fix calls PERF.md measures: frame 0 of c4 at
    1080p in both modes and one 1080p pose-fit step on c5."""
    calls, _, _ = _c4_frame0_calls(dev)
    cases = {f"c4 {mode}": [(k, a) for k, a in mcalls
                            if k in ("render_tile", "trace_rays", "ao_fix")]
             for mode, mcalls in calls.items()}
    cases["fit 1080p"] = _fit_calls(dev)
    return cases


def _launch_ms(launch) -> float:
    """ms of one launch of a prepared kernel, LAUNCHES back to back, the
    fastest of REPS samples."""
    launch()
    ms, _ = cuda_ms(lambda: [launch() for _ in range(LAUNCHES)], REPS)
    return min(ms) / LAUNCHES


def _empty_segments(args):
    """K2's arguments with every shadow segment empty (dist 0): the kernel
    then only loads dist and writes 1 on every lane."""
    return args[:4] + (torch.zeros_like(args[4]),) + args[5:]


def _need_zero(args):
    """ao_fix's arguments with need 0 on every lane: the kernel then only
    loads need and ao_in and writes ao_in."""
    return args[:4] + (torch.zeros_like(args[4]),) + args[5:]


def split_fit(dev, res) -> None:
    """Each K1 and K2 call of one 1080p pose-fit step on c5, ms per call
    launched back to back (as `split` for c4)."""
    from surfjax_torch.tools.kernel_check import KERNELS
    out = {}
    for k, (kname, args) in enumerate(_fit_calls(dev)):
        out[f"{kname} {k}"] = _launch_ms(KERNELS[kname][3](*args)[0])
    res["split fit 1080p"] = out
    print("split fit 1080p", json.dumps(out), flush=True)


def prime(dev, res) -> None:
    """The priming kernel on c3's coarse rays at 1920x1080, launched back
    to back."""
    from surfjax_torch.tools.kernel_check import KERNELS, capture_calls
    scene, camera, st, _ = load_config(C3)
    camera = reframe(camera, 1920, 1080)
    st = st.with_(backend="pallas", prime=True)
    with capture_calls() as calls:
        render(scene, camera, st, device=dev)
    args = calls[0][1]
    out = {"prime_tile": _launch_ms(KERNELS["prime_tile"][3](*args)[0])}
    res["prime c3 1080p"] = out
    print("prime c3 1080p", json.dumps(out), flush=True)


# surfjax's tools/cap_sweep.py variants: (name, march_cap, shadow_march_cap)
CAP_VARIANTS = (("mc=24", 24, 0), ("mc=32", 32, 0), ("mc=48", 48, 0),
                ("sc=12", 0, 12), ("sc=16", 0, 16), ("sc=24", 0, 24),
                ("mc=32 sc=16", 32, 16), ("mc=24 sc=12", 24, 12))


def wide(dev, res) -> None:
    """The KF_WIDE build at 1920x1080, AO off and on: KF (frame 0, the
    fastest of REPS calls) and K1 (every call of the split path's forward
    over the camera's rays, launched back to back), ms per frame."""
    import numpy as np

    from surfjax_torch import api
    from surfjax_torch.core.camera import flat_camera_rays
    from surfjax_torch.kernels.render_tile import render_rays_pallas
    from surfjax_torch.tools import compile_scaling
    from surfjax_torch.tools.kernel_check import KERNELS, capture_calls
    from surfjax_torch.tools.workload import limit_cases
    scene, cam, seq = compile_scaling.case(128, "sphere", 1)
    # name -> (scene, camera, settings, camera rows, kernels timed)
    cases = {"129 spheres": (scene, cam, compile_scaling.settings_of(False),
                             cam_rows_of(*seq, dev), ("KF",))}
    big = limit_cases(api, (1920, 1080))
    for name, kernels in (("120+8", ("K1",)),
                          ("crowd 120+8+70", ("KF", "K1"))):
        scene, cam, st = big[name]
        cases[name] = (scene, cam, st, cam_rows_of(
            np.asarray(cam.rotation, np.float32).reshape(1, 9),
            np.asarray(cam.position, np.float32).reshape(1, 3), dev),
            kernels)
    out = {}
    for name, (scene, cam, st, rows, kernels) in cases.items():
        static, params = scene.freeze()
        scene_t = SceneTensors(static, params_to_device(params, dev))
        intr = cam.intrinsics
        for ao in (False, True):
            st_a = st.with_(ao=ao)
            key = f"{name} ao {'on' if ao else 'off'}"
            if "KF" in kernels:
                frame_fused(scene_t, st_a, intr, rows)
                ms, _ = cuda_ms(lambda st_a=st_a: frame_fused(
                    scene_t, st_a, intr, rows), REPS)
                out["KF " + key] = min(ms)
            if "K1" in kernels:
                o, d, _ = flat_camera_rays(intr, rows[0, :9], rows[0, 9:])
                with capture_calls() as calls:
                    render_rays_pallas(static, st_a, scene_t.params, o, d)
                out["K1 " + key] = sum(
                    _launch_ms(KERNELS[k][3](*a)[0]) for k, a in calls
                    if k == "render_tile")
    res["wide"] = out
    print("wide", json.dumps(out), flush=True)


def _spread(times) -> dict:
    t = sorted(times)
    return {"min": t[0], "median": t[len(t) // 2], "max": t[-1]}


def caps(dev, res) -> None:
    """The capped-march residual on frame 0 of c3 at 1920x1080 (module
    docstring): ms per frame, ms per launch, rows re-run and, where
    counted, each launch's operations and bytes (inputs read once on the
    lanes that run, outputs written once, a re-run's row flags)."""
    from surfjax_torch.core.camera import flat_camera_rays
    from surfjax_torch.kernels import render_tile as rt
    from surfjax_torch.tools.kernel_check import (
        KERNELS, capture_calls, flat, fresh,
    )
    scene_t, camera, modes, _, row0 = _c3_frame0(dev)
    intr = camera.intrinsics
    st = modes["value"]
    static, params = scene_t
    o, d, _ = flat_camera_rays(intr, row0[0, :9], row0[0, 9:])
    lanes = o[0].numel()

    def frame(s):
        return lambda: rt.render_rays_pallas(static, s, params, o, d)

    def timed(call):
        call()
        torch.cuda.synchronize()
        return _spread(cuda_ms(call, REPS)[0])

    def counted(kname, args):
        """-> (operations, bytes) of one launch, by the plain version: the
        lanes that run (a re-run's flagged rows) read their inputs once
        (K2 only dist where the shadow segment is empty) and write every
        output once; a re-run also reads its row flags."""
        with rt.count_ops() as c:
            KERNELS[kname][1](*fresh(kname, args))
        redo = kname.endswith("_redo")
        rays = args[4:] if redo else args[2:]
        ins = flat(rays)
        n = ins[0].numel()     # the padded rays of the split path
        run = torch.ones(n, dtype=torch.bool, device=dev)
        if redo:
            run = args[3].repeat_interleave(rt.LANES)[:n] > 0.5
        n_run = int(run.sum())
        if kname.startswith("trace_rays"):
            live = int((run & ~(rays[2].reshape(-1) <= 0.0)).sum())
            n_in = n_run + (len(ins) - 1) * live
        else:
            n_in = n_run * len(ins)
        # without a cap K1 and K2 write no unres
        written = len(KERNELS[kname][2]) - (
            0 if redo or rt._cap_of(kname, args[1], None) else 1)
        n_out = n_run * written
        return c["ops"], 4 * (n_in + n_out) + (args[3].numel() * 4
                                               if redo else 0)

    out = {"lanes": lanes, "split uncapped first": timed(frame(st))}
    out["KF frame_fused"] = timed(
        lambda: rt.frame_fused(scene_t, st, intr, row0))
    out["KF render"] = timed(lambda: rt.render_frame_pallas(
        static, intr, st, params, row0[0, :9], row0[0, 9:]))
    for name, mc, sc in (("baseline", 0, 0),) + CAP_VARIANTS:
        s = st.with_(march_cap=mc, shadow_march_cap=sc)
        entry = {"frame": timed(frame(s)) if mc or sc else None}
        with capture_calls() as calls:
            frame(s)()
        k2 = 0
        for kname, args in calls:
            key = {"render_tile": "K1", "render_tile_redo": "K1 redo",
                   "trace_rays": "K2", "trace_rays_redo": "K2 redo"}[kname]
            if kname.startswith("trace_rays"):
                key += f" light {k2}"
                k2 += kname.endswith("_redo")
            e = {"ms": _launch_ms(KERNELS[kname][3](*fresh(kname, args))[0])}
            if kname.endswith("_redo"):
                e["rows_share"] = float(args[3].mean())
            if name in ("baseline", "mc=32 sc=16", "mc=24 sc=12"):
                e["ops"], e["bytes"] = counted(kname, args)
            entry[key] = e
        out[name] = entry
        print(f"caps {name}", json.dumps(entry), flush=True)
    out["split uncapped last"] = timed(frame(st))
    res["caps c3 1080p"] = out
    print("caps c3 1080p", json.dumps(out), flush=True)


def sass(dev, res) -> None:
    """The hash of every entry's SASS (_build.sass_hashes), to compare the
    code of two builds."""
    from surfjax_torch.kernels import _build
    info = _build.build()
    out = _build.sass_hashes(info["path"], list(_build.entries(info["log"])))
    res["sass"] = out
    print("sass", json.dumps(out), flush=True)


def split_phases(dev, res) -> None:
    """Inside K1, K2 and ao_fix on frame 0 of c4 at 1080p (both modes) and
    K1 and K2 in one 1080p pose-fit step on c5: per call the kernel's time
    (launched back to back), K1's with AO off, K2's on the same rays with
    every shadow segment empty and ao_fix's with need 0 on every lane (what
    a lane costs without its work); then the profiling
    instantiation: its time, its outputs against the plain version's
    (bitwise), its SDF evaluations against the plain version's
    (count_ops, less the FD normals', which carry no probe), on c4 AO's
    evaluations against lanes x taps, and its phase table (per phase the
    share of the warps' cycles, the SIMT efficiency of its loops and the
    SDF evaluations per lane); last, ptxas' line and the local loads and
    stores (LDL, STL) of every K1, K2 and ao_fix entry."""
    from surfjax_torch.kernels import _build
    from surfjax_torch.kernels import render_tile as rt
    from surfjax_torch.tools.kernel_check import KERNELS, flat
    aos = rt.KP_PHASE_NAMES.index("ao unbounded")
    for case, calls in _split_cases(dev).items():
        for k, (kname, args) in enumerate(calls):
            scene_t, st = args[:2]
            rays = args[2:]
            n = flat(rays)[0].numel()
            entry = {"lanes": n,
                     "ms": _launch_ms(KERNELS[kname][3](*args)[0])}
            if kname == "render_tile":
                entry["ms_ao_off"] = _launch_ms(KERNELS[kname][3](
                    scene_t, st.with_(ao=False), *rays)[0])
            elif kname == "ao_fix":
                entry["need_lanes"] = int((args[4] > 0.5).sum())
                entry["ms_need_zero"] = _launch_ms(
                    KERNELS[kname][3](*_need_zero(args))[0])
            else:
                entry["ms_empty_segments"] = _launch_ms(
                    KERNELS[kname][3](*_empty_segments(args))[0])
            with rt.count_ops() as c:
                ref = KERNELS[kname][1](*args)
            fd = rt.fd_normal_evals(scene_t.static, st, ref[1]) \
                if kname == "render_tile" else 0
            launch, out, prof = rt.staged_split_launcher(kname, scene_t, st,
                                                         rays, profile=True)
            launch()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(flat(out),
                                                         flat(ref))):
                raise AssertionError(f"{case} call {k}: the profile's "
                                     "outputs differ from the plain "
                                     "version's")
            evals = int(prof[:, :, 2].sum())
            if evals + fd != c["evals"]:
                raise AssertionError(
                    f"{case} call {k}: {evals} SDF evaluations profiled + "
                    f"{fd} FD, the plain version {c['evals']}")
            # on c4 AO evaluates the floor at every tap of every lane that
            # takes AO: all of K1's, ao_fix's needing lanes
            ao_lanes = entry.get("need_lanes", n)
            if case.startswith("c4") and kname != "trace_rays" and \
                    st.ao and int(prof[:, aos, 2].sum()) != \
                    ao_lanes * 4 * st.ao_samples:
                raise AssertionError(f"{case} call {k}: AO evaluated "
                                     f"{int(prof[:, aos, 2].sum())} times, "
                                     "not lanes x taps")
            entry.update(plain_evals=c["evals"], evals=evals,
                         ms_profiled=_launch_ms(launch),
                         phases=phase_table(prof, n, scene_t.static,
                                            rt.KP_PHASE_NAMES))
            res[f"split phases {case} {k} {kname}"] = entry
            print(f"split phases {case} {k} {kname}", json.dumps(entry),
                  flush=True)
    info = _build.build()
    for name, lines in _build.entries(info["log"]).items():
        if "render_tile" in name or "trace_rays" in name or \
                "ao_fix" in name:
            entry = {"ptxas": lines,
                     "sass": _build.sass_counts(info["path"], name)}
            res[f"split entry {name}"] = entry
            print(f"split entry {name}", json.dumps(entry), flush=True)


def _prime_args(dev):
    """The priming kernel's call of a primed 1080p frame of c3 (`value`)."""
    from surfjax_torch.tools.kernel_check import capture_calls
    scene, camera, st, _ = load_config(C3)
    camera = reframe(camera, 1920, 1080)
    with capture_calls() as calls:
        render(scene, camera, st.with_(backend="pallas", prime=True),
               device=dev)
    return calls[0][1]


def prime_table(prof, n: int, static) -> dict:
    """The priming kernel's profile (PRIME_PHASE_NAMES, then each warp's
    clock64 and %globaltimer deltas) -> the phase table, the SM clock
    (clock64 cycles over globaltimer ns, summed over the warps), the
    distribution of cycles per warp (median, p99, max), the slowest warp's
    cycles in ms at that clock and its own globaltimer ms, and the most
    steps a warp took in each phase."""
    from surfjax_torch.kernels.render_tile import (
        PRIME_CLOCK, PRIME_PHASE_NAMES,
    )
    names = list(PRIME_PHASE_NAMES)
    warp_cyc = prof[:, :PRIME_CLOCK, 0].sum(dim=1).double().cpu()
    clk = prof[:, PRIME_CLOCK].double().cpu()
    ghz = float(clk[:, 0].sum()) / float(clk[:, 1].sum())
    q = torch.quantile(warp_cyc, torch.tensor([0.5, 0.99],
                                              dtype=torch.float64))
    slow = float(warp_cyc.max())
    return {"phases": phase_table(prof, n, static, names),
            "sm_clock_ghz": ghz,
            "warp_cycles": {"median": float(q[0]), "p99": float(q[1]),
                            "max": slow, "mean": float(warp_cyc.mean())},
            "slowest_warp_ms": slow / ghz / 1e6,
            "slowest_warp_globaltimer_ms": float(clk[:, 1].max()) / 1e6,
            "max_warp_steps": {
                ph: int(prof[:, names.index(ph), 1].max())
                for ph in ("proxy steps", "sdf steps")},
            "lane_steps_per_ray": {
                ph: float(prof[:, names.index(ph), 2].sum()) / n
                for ph in ("proxy steps", "sdf steps")}}


def _warp_rays(args, w: int):
    """The priming call's arguments cut to the coarse rays of the kernel's
    warp w, kept as the tile of PRIME_WARP_W x 32/PRIME_WARP_W rays that the
    warp takes (the grid's edge cuts it to what lies inside)."""
    from surfjax_torch.kernels.render_tile import PRIME_WARP_W as ww
    o = args[3][0]
    n, wc = o.numel(), o.shape[-1]
    item, q = divmod(w, 4)
    gx = -(-wc // (4 * ww))
    col0 = (item % gx) * 4 * ww + q * ww
    row0 = (item // gx) * (32 // ww)
    cols = torch.arange(col0, max(col0, min(col0 + ww, wc)), device=o.device)
    rows = torch.arange(row0, max(row0, min(row0 + 32 // ww, n // wc)),
                        device=o.device)
    idx = (rows[:, None] * wc + cols[None, :]).reshape(-1)
    return args[:3] + tuple(
        tuple(c.reshape(-1)[idx].reshape(rows.numel(), cols.numel())
              .contiguous() for c in a) for a in args[3:5])


def prime_phases(dev, res) -> None:
    """Inside the priming kernel on a primed 1080p frame of c3 (`value`):
    the kernel's time (launched back to back); the profiling
    instantiation's outputs against the plain version's (bitwise), its SDF
    evaluations against the plain version's count (count_ops), its phase
    table, the SM clock it ran at and the cycles per warp (prime_table),
    and the kernel on the slowest warp's rays alone; ptxas' line, the
    resident blocks per SM and the waves of the launch."""
    from surfjax_torch.kernels import _build
    from surfjax_torch.kernels import render_tile as rt
    args = _prime_args(dev)
    n = args[3][0].numel()
    with rt.count_ops() as c:
        ref = rt.prime_tile_reference(*args)
    launch, (out,), prof = rt.prime_profile_launcher(*args)
    launch()
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("prime: the profile's t0 differs from the plain "
                             "version's")
    names = list(rt.PRIME_PHASE_NAMES)
    evals = int(prof[:, names.index("evals proxy"), 2].sum()
                + prof[:, names.index("evals sdf"), 2].sum())
    if evals != c["evals"]:
        raise AssertionError(f"prime: {evals} SDF evaluations profiled, the "
                             f"plain version {c['evals']}")
    # the slowest warp's rays alone, on an otherwise idle card
    w = int(prof[:, :rt.PRIME_CLOCK, 0].sum(dim=1).argmax())
    occ = rt.prime_occupancy(args[0], args[1], dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = prof.shape[0] // (rt.KS_THREADS // 32)
    info = _build.build()
    entry = {"coarse_rays": n, "plain_evals": c["evals"],
             "plain_ops": c["ops"], "evals": evals,
             "ms": _launch_ms(rt.prime_launcher(*args)[0]),
             "ms_profiled": _launch_ms(launch),
             **prime_table(prof, n, args[0].static),
             "slowest_warp_alone_ms": _launch_ms(
                 rt.prime_launcher(*_warp_rays(args, w))[0]),
             "blocks": blocks, **occ,
             "waves": blocks / (sms * occ["blocks_per_sm"]),
             "ptxas": {name: lines for name, lines in
                       _build.entries(info["log"]).items()
                       if "prime" in name}}
    res["prime phases"] = entry
    print("prime phases", json.dumps(entry), flush=True)


def busy_clock(launch, count: int) -> str:
    """nvidia-smi's SM clock and power draw while `count` launches of a
    prepared kernel run back to back (read after the first has had time to
    start)."""
    for _ in range(count):
        launch()
    time.sleep(0.2)
    line = gpu_line("clocks.sm,power.draw")
    torch.cuda.synchronize()
    return line


def probe_label(kind: str, fma: bool, unroll: int) -> str:
    """The key of a probe_phases row: entry and unroll."""
    from surfjax_torch.tools import fp32_peak as fp
    return f"probe {fp.entry_name(kind, fma)} u{unroll}"


def probe_row(kind: str, fma: bool, unroll: int, seeds, names: dict,
              code: dict, iters: int) -> dict:
    """One mix instantiation at the probe's size: the kernel's time per
    launch (ms, and ps per iteration-lane), its profiling instantiation's
    output against the kernel's (bitwise) and its table (fp32_peak.
    profile_table), the SASS of its trip loop per substep by pipe
    (substep_sass), its ptxas lines, blocks per SM, grid and waves, the
    issue bound at the measured clock and the operations bound, and the
    time's share of each."""
    from surfjax_torch.tools import fp32_peak as fp
    dev = seeds[0].device
    n = seeds[0].numel()
    launch, out = fp.peak_launcher(kind, *seeds, iters, unroll, fma)
    plaunch, pout, prof = fp.profile_launcher(kind, *seeds, iters, unroll,
                                              fma)
    plaunch()
    launch()
    # a launch takes milliseconds: three samples of three back to back
    ms = min(cuda_ms(lambda: [launch() for _ in range(3)], 3)[0]) / 3
    if not torch.equal(out, pout):
        raise AssertionError(f"{kind} fma={fma} u{unroll}: the profile's "
                             "output differs from the kernel's")
    grid, per_sm = fp.mix_grid(kind, fma, n, unroll, False, dev)
    _, prof_per_sm = fp.mix_grid(kind, fma, n, unroll, True, dev)
    table = fp.profile_table(prof, iters)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    name, ptxas = names[(kind, fma, unroll, False)]
    sass = fp.substep_sass(code[name], unroll)
    lane_iters = float(n) * iters
    issue = fp.issue_bound(sass["per_substep"], lane_iters,
                           table["sm_clock_ghz"], sms)
    ops_ms = fp.ops_per_iter(kind) * lane_iters / (
        fp.FP32_PEAK_TFLOPS * 1e12) * 1e3
    return {"ms": ms, "ps_per_iter_lane": ms * 1e9 / lane_iters,
            "grid": grid, "blocks_per_sm": per_sm,
            "waves": grid / (sms * per_sm), "ptxas": ptxas,
            "profile_ptxas": names[(kind, fma, unroll, True)][1],
            "profile_blocks_per_sm": prof_per_sm,
            **table, "sass": sass, "issue_bound": issue,
            "issue_share": issue["ms"] / ms, "ops_bound_ms": ops_ms,
            "ops_share": ops_ms / ms}


def probe_phases(dev, res, kinds=None, iters=None) -> None:
    """Inside the FP32 probe (fp32_peak.py) at its defaults (2,097,152
    lanes, K = 512), for each kind in `kinds` (all three by default). A
    mix: for each build (-fmad=false and contracted) and unroll the row of
    probe_row, and the SM clock nvidia-smi reads under the kernel at
    unroll 4. fma_dep (8 chains, K x 32): its Tflop/s against 132 x 128 x
    2 x the SM clock measured in the mixes' rows of `res`, and
    nvidia-smi's clock under it."""
    from surfjax_torch.kernels import _build
    from surfjax_torch.tools import fp32_peak as fp
    kinds = fp.KINDS if kinds is None else kinds
    iters = fp.DEFAULT_ITERS if iters is None else iters
    seeds = fp.seeds(fp.DEFAULT_ROWS, fp.DEFAULT_GRID, dev)
    info = _build.build()
    names = fp.mix_names(info["log"])
    mixes = [kind for kind in kinds if kind in fp.MIXES]
    code = _build.sass_of_many(info["path"], [
        names[(kind, fma, u, False)][0] for kind in mixes
        for fma in (False, True) for u in fp.UNROLLS])
    warm, _ = fp.peak_launcher("fma_dep", *seeds, iters * fp.FMA_K_SCALE, 8)
    for _ in range(20):
        warm()
    torch.cuda.synchronize()
    for kind in mixes:
        for fma in (False, True):
            for u in fp.UNROLLS:
                row = probe_row(kind, fma, u, seeds, names, code, iters)
                label = probe_label(kind, fma, u)
                res[label] = row
                print(label, json.dumps(row), flush=True)
        mix, _ = fp.peak_launcher(kind, *seeds, iters, 4)
        res[f"probe {kind} smi"] = busy_clock(mix, 250)
        print(f"probe {kind} smi", res[f"probe {kind} smi"], flush=True)
    if "fma_dep" not in kinds:
        return
    clocks = [row["sm_clock_ghz"] for label, row in res.items()
              if label.startswith("probe fp_") and "sm_clock_ghz" in row]
    if not clocks:
        raise RuntimeError("probe_phases: fma_dep is read against the SM "
                           "clock of the mixes' rows: run a mix first")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k = iters * fp.FMA_K_SCALE
    chain, _ = fp.peak_launcher("fma_dep", *seeds, k, 8)
    ms = _launch_ms(chain)
    tflops = 2.0 * seeds[0].numel() * k / (ms * 1e-3) / 1e12
    ghz = sum(clocks) / len(clocks)
    peak = sms * 128 * 2 * ghz / 1e3
    entry = {"ms": ms, "tflops": tflops, "sm_clock_ghz_of_mixes": ghz,
             "peak_at_that_clock_tflops": peak,
             "share_at_that_clock": tflops / peak,
             "share_of_data_sheet": tflops / fp.FP32_PEAK_TFLOPS,
             "smi": busy_clock(chain, 500)}
    res["probe fma_dep u8"] = entry
    print("probe fma_dep u8", json.dumps(entry), flush=True)


SECTIONS = {
    "c3": lambda dev, res: fused_path(
        "c3", main_path("configs/c3_sdf.yaml"), dev, features_off, res),
    "crowd_demo": lambda dev, res: fused_path(
        "crowd_demo", crowd_main_path("configs/crowd_demo.yaml"), dev,
        crowd_variants, res),
    "spheres": sphere_crowds,
    "c3_primed": c3_primed,
    "c4": c4,
    "sequence": sequence,
    "fit": fit_steps,
    "kf": kf,
    "kf_phases": kf_phases,
    "split": split,
    "mesh_phases": mesh_phases,
    "mesh_glue": mesh_glue,
    "split_fit": split_fit,
    "prime": prime,
    "split_phases": split_phases,
    "split_crowd": split_crowd,
    "prime_phases": prime_phases,
    "probe_phases": probe_phases,
    "sass": sass,
    "caps": caps,
    "wide": wide,
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
