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
priming and traces one primed call. `kf` times the fused kernel through its
wrapper on c3 (48 frames, both modes) and on primed c3 (frame 0 with its
t0). `kf_phases` profiles the staged kernel on frame 0 of c3 in both
modes (its profiling instantiation): per phase the share of the warps'
cycles, the SIMT efficiency of its loops (lanes that evaluate an SDF per
trip, over 32) and the SDF evaluations per hit pixel, beside the share of
each call of kf_frame_kernel<false>, the per-pixel kernel it replaced, and
the kernels' ptxas lines. `split` times each split kernel of one 1080p c4
frame in `ao` mode, launched back to back (as chip_smoke.py's phase 7),
`split_fit` K1 and K2 in a 1080p fit step and `prime` the priming kernel
on c3 the same way; `split_phases` profiles K1 and K2 (chip_smoke.py's
phase 17); `sass` hashes every entry's SASS, to compare two builds.
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


def _fit_calls(dev, size=(1920, 1080)):
    """The K1 and K2 calls of one pose-fit step on c5 at `size`."""
    from surfjax_torch.tools.fit_bench import pose_step_fn
    from surfjax_torch.tools.kernel_check import capture_calls
    step, x0, state0, _ = pose_step_fn("pallas", 60, size, dev)
    with capture_calls() as calls:
        step(x0, state0)
    return calls


def _split_cases(dev) -> dict:
    """The K1 and K2 calls PERF.md measures: frame 0 of c4 at 1080p in
    both modes and one 1080p pose-fit step on c5."""
    calls, _, _ = _c4_frame0_calls(dev)
    cases = {f"c4 {mode}": [(k, a) for k, a in mcalls
                            if k in ("render_tile", "trace_rays")]
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


def sass(dev, res) -> None:
    """The hash of every entry's SASS (_build.sass_hashes), to compare the
    code of two builds."""
    from surfjax_torch.kernels import _build
    info = _build.build()
    out = _build.sass_hashes(info["path"], list(_build.entries(info["log"])))
    res["sass"] = out
    print("sass", json.dumps(out), flush=True)


def split_phases(dev, res) -> None:
    """Inside K1 and K2 on frame 0 of c4 at 1080p (both modes) and in one
    1080p pose-fit step on c5: per call the kernel's time (launched back to
    back), K1's with AO off and K2's on the same rays with every shadow
    segment empty (what a lane costs without its work); then the profiling
    instantiation: its time, its outputs against the plain version's
    (bitwise), its SDF evaluations against the plain version's
    (count_ops, less the FD normals', which carry no probe), on c4 AO's
    evaluations against lanes x taps, and its phase table (per phase the
    share of the warps' cycles, the SIMT efficiency of its loops and the
    SDF evaluations per lane); last, ptxas' line and the local loads and
    stores (LDL, STL) of every K1 and K2 entry."""
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
            if case.startswith("c4") and kname == "render_tile" and \
                    st.ao and int(prof[:, aos, 2].sum()) != \
                    n * 4 * st.ao_samples:
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
        if "render_tile" in name or "trace_rays" in name:
            entry = {"ptxas": lines,
                     "sass": _build.sass_counts(info["path"], name)}
            res[f"split entry {name}"] = entry
            print(f"split entry {name}", json.dumps(entry), flush=True)


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
    "kf": kf,
    "kf_phases": kf_phases,
    "split": split,
    "mesh_phases": mesh_phases,
    "mesh_glue": mesh_glue,
    "split_fit": split_fit,
    "prime": prime,
    "split_phases": split_phases,
    "sass": sass,
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
