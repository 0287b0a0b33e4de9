#!/usr/bin/env python3
"""Drive surfjax_torch's fused-frame, split (mesh), crowd, primed and fit
paths and its FP32 roofline probe on one CUDA GPU and check them.

    python3 chip_smoke.py

Phases (each prints its own line with its seconds; any failure raises, so
the script exits non-zero and never prints its last line):
  0. versions, the card's name and power limit; refuses to run without CUDA;
  1. builds the CUDA kernels from surfjax_torch/kernels/csrc (one nvcc per
     source, in parallel), prints ptxas' registers and spills of every
     entry and holds those of the crowd instantiation kf_frame_kernel<true>,
     of K1, K2 and ao_fix with a crowd and ao_fix without, and of the
     staged fused kernel to what they were before the staged K1 and K2;
     prints the staged kernel's shared memory per block and resident blocks
     per SM on c3;
  2. the fused kernel (for scenes without a crowd: the staged kernel,
     kf_staged.cu) against its plain PyTorch twin on the card, bitwise, at
     256x256 x 2 frames: c1, c2, c5 and c3 (LoD and exact modes), c3 with
     the portable log in exact mode, and c3 at 250x131, which its blocks do
     not tile;
  3. the main path: configs/c3_sdf.yaml reframed to 1920x1080, 48 camera
     positions in one render_sequence call, backend="pallas", in the
     `value` (config settings) and `value_exact` (LoDs 0, over_relax 1.0)
     modes: one warm-up call, three calls timed with CUDA events, launch
     counts, output checks;
  4. the kernel at the main path's shape (48 frames of 1920x1080) against
     the twin, bitwise, on the first, middle and last frame, in both
     modes, both timed per frame;
  5. the split path's kernels (render_tile = K1, trace_rays = K2, ao_fix,
     mesh_tile) against their plain versions on the card, bitwise, on
     every kernel call of a 256x256 frame of: c4 in the `config` and `ao`
     modes, a mesh + SDF sphere + plane scene (AO, soft shadows) and a
     two-mesh scene; and the mesh kernel on rays aimed at a mesh's
     vertices and edges, through three nested shells (several occluders
     per shadow ray) and with K = 8 (every tile overflows);
  6. the mesh main path: configs/c4_mesh.yaml at 1920x1080, 16 camera
     positions in one render_sequence call per mode (`config`: the yaml's
     settings; `ao`: AO and soft shadows on), one warm-up call and three
     timed with CUDA events; launch counts (every split kernel > 0, the
     fused kernel 0), output checks, frame 0 against render();
  7. every split kernel call of one 1080p c4 frame against its plain
     version, bitwise, both timed, in both modes; the mesh kernel's bound
     counts the culled algorithm it runs (its warps' votes, then each
     lane's voted candidates up to its first occluder), the unculled
     count beside it;
  8. the crowd loops (settings.vector_objects) in KF, K1, K2 and ao_fix
     against their plain versions, bitwise, at 256x256 x 2 frames: nine
     and four small objects with hard shadows + AO and with soft shadows,
     a crowd with no floor, pairs of all six CSG ops, analytic members,
     configs/crowd_demo.yaml in both modes (also at 250x131, which the
     kernel's blocks do not tile), the culling's edge scene in both modes
     (250x131) and a crowd beside a mesh through the split path; KF also
     against the culled twin (each warp visiting only the members in its
     masks); each also with the crowd off: geometry bitwise equal, rgb
     within 2 ULP;
  9. the crowd main path: configs/crowd_demo.yaml (49 objects) at
     1920x1080, 48 camera positions in one render_sequence call, modes
     `config` (hard shadows + AO) and `soft` (soft shadows on): launch
     counts, outputs checked, frames 0, 24 and 47 of `config` against the
     twin, bitwise; once per mode with the crowd off, for the record; the
     masked members per warp of frame 0; the kernel alone with AO off,
     shadows off, both off and the crowd off;
 10. the priming kernel against its plain version, bitwise, at 256x256 and
     at 1920x1080; the primed main path: render(prime=True) on c3 at
     1920x1080 launches prime_tile then KF with its t0; hit mask against
     the unprimed frame's, times with and without priming;
 11. member-count scaling: crowds of 16, 64 and 256 spheres at 1920x1080,
     frame 0 of each against the twin, bitwise;
 12. the FP32 roofline probe (tools/fp32_peak.py): every entry built with
     -fmad=false against its plain version, bitwise (the explicit-FMA chains
     within 1 ULP of their float64 plain versions), the contracted entries
     within 1e-5, at K = 16 on 64 x 256 x 128 lanes and every unroll; then
     the timed sweep at the tool's defaults: ps per iteration-lane and
     Tflop/s per row, contracted over uncontracted, and what c3's Mandelbulb
     iteration-lanes per 1080p frame cost at the probe's rate;
 13. the kernel-forward differentiable render (diff/hybrid.py) on c5 at
     256x256: forward bitwise equal to render_rays_pallas; the pose loss
     and gradient on `pallas` against `jnp` and against the same run on the
     CPU's plain versions; a central finite-difference check;
 14. the fit main path: configs/c5_anim.yaml as it is (256x256, its `fit:`
     block, backend pallas): fit_pose from the command line's start, then
     fit_sdf from its perturbed leaf parameters, launch counts (K1 once and
     K2 once per light and step, the fused kernel never), both timed per
     step; then the pose-fit step at 1920x1080 on both backends; every K1
     and K2 call of one fit step at 256x256 and at 1920x1080 against its
     plain version, bitwise, and at 1920x1080 timed with its bound;
 15. where the fused kernel's time goes (tools/breakdown.py, `kf_phases`):
     the profiling instantiation of the staged kernel and the profile of
     kf_frame_kernel<false>, the per-pixel kernel it replaced (its body
     with a probe after each call, kf_frame_prof.cu), on frame 0 of c3 at
     1920x1080 in both modes, both writing the staged kernel's buffers:
     per phase group the share of the warps' cycles and, for the staged
     kernel, the SIMT efficiency of its loops and the SDF evaluations per
     hit pixel;
 16. where the mesh kernel's time goes (tools/breakdown.py, `mesh_phases`):
     its profiling instantiation on every mesh call of frame 0 of c4 at
     1920x1080 in both modes, writing the production kernel's outputs;
     its warps' votes equal to mesh_warp_masks and its test count per lane
     equal to the culled count_tests; per call the share of the warps'
     cycles per phase, the test loop's SIMT efficiency, candidates per
     tile, overflow tiles, lane-tests culled and unculled, and the
     instructions of the production kernel's loops in its SASS;
 17. where K1's and K2's time goes (tools/breakdown.py, `split_phases`):
     on every K1 and K2 call of frame 0 of c4 at 1920x1080 in both modes
     and of one 1080p pose-fit step, the kernel's time, K1's with AO off
     and K2's on empty shadow segments, and the profiling instantiation of
     the staged kernels: its outputs equal to the plain version's, its SDF
     evaluations equal to the plain version's count (and on c4 AO's to
     lanes x taps), per phase group the share of the warps' cycles, the
     SIMT efficiency and the SDF evaluations per lane; each K1 and K2
     entry's local loads and stores (SASS).

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches on the main paths, largest errors, times
per 1080p frame (value_exact mode for the fused kernel, `ao` mode for the
split kernels, crowd_demo `config` for the fused kernel's crowd
instantiation; the probe's entries per launch at its defaults, unroll 4)
and bounds; K1 and K2 also with their time and bound in a 1080p fit step
(fit_ms, fit_bound_ms, fit_bound_by).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SEED = 0   # numpy seed of the camera jitter of phase 2
NINE = ("r", "g", "b", "depth", "obj", "nx", "ny", "nz", "hit")
# NVIDIA H100 SXM data-sheet peaks at the full 700 W limit
FP32_OPS_PER_S = 67e12
BYTES_PER_S = 3.35e12
LAUNCH_REPS = 10   # back-to-back launches per timed sample (phase 7)
# hit-fraction bounds of the mesh main path (phase 6): on the H100 the
# hit fraction moved by at most 2.07e-5 from one frame to the next and by
# 2.45e-4 from frame 0 to frame 15 in both modes; each bound is about
# twice that
MESH_STEP_MAX = 5e-5
RAGGED = (250, 131)   # a frame that the kernel's 16x8-pixel blocks do not tile
MESH_DRIFT_MAX = 5e-4
# the crowd main path (phase 9): on the H100 the hit fraction did not move
# at all over 48 frames (the floor fills the frame below the horizon and
# every object stands in front of it), so the bounds only catch a frame
# that loses its floor; that the frames differ is checked on their depth
CROWD_STEP_MAX = 1e-5
CROWD_DRIFT_MAX = 1e-4
# the fused kernel on c3 before the crowd and t0 existed (value_exact,
# 48 frames per launch, NVIDIA H100 80GB HBM3 at 700 W), for comparison
KF_BEFORE = "3.338 ms/frame, 72 registers, 264/416 bytes of spills"
# ptxas' report of the kernels that the staged kernels must leave as they
# were: entry -> (stack and spills, registers), built with CUDA 12.8 for
# sm_90a; the crowd instantiations and ao_fix as the parent of the staged
# fused kernel (d7d452f) built them, the staged fused kernel as c31b803,
# the parent of the staged K1 and K2 (split_staged.cu), built it
PTXAS_KEPT = {
    "_Z15kf_frame_kernelILb1EEv8KFTables10KFSettings": (
        "768 bytes stack frame, 176 bytes spill stores, 292 bytes spill loads",
        "Used 96 registers, used 0 barriers, 768 bytes cumulative stack size"),
    "_Z21sp_render_tile_kernelILb1EEv8KFTables10KFSettings9SplitRays": (
        "640 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "Used 96 registers, used 0 barriers, 640 bytes cumulative stack size"),
    "_Z20sp_trace_rays_kernelILb1EEv8KFTables10KFSettings9SplitRays": (
        "560 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "Used 72 registers, used 0 barriers, 560 bytes cumulative stack size"),
    "_Z16sp_ao_fix_kernelILb1EEv8KFTables10KFSettings9SplitRays": (
        "592 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "Used 96 registers, used 0 barriers, 592 bytes cumulative stack size"),
    "_Z16sp_ao_fix_kernelILb0EEv8KFTables10KFSettings9SplitRays": (
        "464 bytes stack frame, 12 bytes spill stores, 0 bytes spill loads",
        "Used 80 registers, used 0 barriers, 464 bytes cumulative stack size"),
    "_Z16kf_staged_kernelILb0EEv8KFTables10KFSettings8KSLayoutPyPi": (
        "528 bytes stack frame, 280 bytes spill stores, 532 bytes spill loads",
        "Used 64 registers, used 1 barriers, 528 bytes cumulative stack size"),
}
PRIME_HIT_MAX = 1e-4   # share of pixels whose hit flag priming may change
PROBE_K = 16           # substeps of the probe's comparison with plain
PROBE_UNROLL = 4       # the sweep row whose launch time the kernels line gives
# the hybrid's pose gradient against the eager pipeline's (the marches stop
# at different points inside the hit band): the bounds surfjax holds its
# own two backends to
FIT_LOSS_REL, FIT_GRAD_REL, FIT_GRAD_COS = 2e-3, 0.1, 0.995
FIT_CPU_REL = 1e-3     # the card's hybrid gradient against the CPU's


def bound(n_ops: float, n_bytes: float):
    """-> (least ms, "operations" or "bytes"): the larger of the two."""
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    t_bytes = n_bytes / BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(tensors) -> int:
    from surfjax_torch.tools.kernel_check import flat
    return sum(t.numel() * t.element_size() for t in flat(tensors))


def bytes_read(kname: str, args) -> int:
    """-> the bytes one recorded split-kernel call must read, each array
    once, only on the lanes whose thread reads it: K2 reads o, l and
    soft_k only where the shadow segment is not empty (not dist <= 0),
    ao_fix reads p_off and n only where need > 0.5; the other ray arrays
    on every lane. The mesh kernel counts its whole triangle and candidate
    tables and every ray."""
    if kname == "mesh_tile":
        return nbytes(args[:6])   # table, candidates, counts, rays
    if kname == "trace_rays":
        dist = args[4]
        lanes = int((~(dist <= 0.0)).sum())
        return nbytes(dist) + 7 * dist.element_size() * lanes
    if kname == "ao_fix":
        need, ao_in = args[4], args[5]
        lanes = int((need > 0.5).sum())
        return nbytes((need, ao_in)) + 6 * need.element_size() * lanes
    return nbytes(args[2:])


def log(msg: str) -> None:
    print(msg, flush=True)


def bitwise(out, ref, names, label: str) -> float:
    """Kernel buffers against the twin's: each pair must be equal to the
    bit (both round every float op on its own, -fmad=false on the card).
    Raises on the first buffer that differs -> the largest abs difference
    over all of them (0.0)."""
    import torch
    errs = [float((a.double() - b.double()).abs().max())
            for a, b in zip(out, ref)]
    for name, a, b, err in zip(names, out, ref, errs):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: kernel differs from the twin in "
                                 f"{name} (max abs diff {err})")
    log(f"  {label}: {len(errs)} buffers bitwise equal")
    return max(errs)


def check_sequence(mode: str, fb, n_objects: int, step_max: float,
                   drift_max: float):
    """Finite buffers, object ids in range, and a hit fraction that moves
    between frames no more than the camera's 1e-4 per axis can explain.
    -> (largest step, drift from frame 0)."""
    import torch
    for field in ("rgb", "depth", "normal", "hit"):
        if not bool(torch.isfinite(getattr(fb, field)).all()):
            raise AssertionError(f"{mode}: non-finite {field}")
    if not (int(fb.obj_id.min()) >= -1 and int(fb.obj_id.max()) < n_objects):
        raise AssertionError(f"{mode}: obj_id out of [-1, {n_objects})")
    hit_frac = fb.hit.mean(dim=(1, 2))
    step = float((hit_frac[1:] - hit_frac[:-1]).abs().max())
    drift = float((hit_frac - hit_frac[0]).abs().max())
    if step > step_max or drift > drift_max:
        raise AssertionError(
            f"{mode}: hit fraction moves by {step} between frames and by "
            f"{drift} from frame 0 (bounds {step_max} and {drift_max})")
    return step, drift


def on_equals_off(label: str, on, off) -> int:
    """Crowd on against crowd off: depth, normal, hit and obj_id bitwise
    equal, rgb within 2 ULP -> the largest rgb ULP distance."""
    import torch
    for field in ("depth", "normal", "hit", "obj_id"):
        if not torch.equal(getattr(on, field), getattr(off, field)):
            raise AssertionError(f"{label}: crowd on differs from crowd off "
                                 f"in {field}")
    ulp = int((on.rgb.view(torch.int32) - off.rgb.view(torch.int32))
              .abs().max())
    if ulp > 2:
        raise AssertionError(f"{label}: rgb differs by {ulp} ULP between "
                             "crowd on and off (bound 2)")
    return ulp


def main() -> int:
    # -- phase 0 ------------------------------------------------------------
    t0 = time.perf_counter()
    import numpy as np
    import torch
    log(f"phase 0: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA GPU")
    from surfjax_torch.api import render, render_sequence
    from surfjax_torch.config import load_config
    from surfjax_torch.core.scene_compile import params_to_device
    from surfjax_torch.core.types import FrameBuffers
    from surfjax_torch.kernels import _build
    from surfjax_torch.kernels.mesh_tile import (
        mesh_tile, mesh_tile_reference,
    )
    from surfjax_torch.kernels.render_tile import (
        SceneTensors, ao_fix, count_ops, frame_buffers, frame_fused,
        frame_fused_reference, render_tile, trace_rays,
    )
    from surfjax_torch.tools.kernel_check import (
        KERNELS, capture_calls, compare,
    )
    from surfjax_torch.tools.workload import (
        EXACT, cam_rows_of, cuda_ms, gpu_line, main_path, mesh_main_path,
        crowd_cases, crowd_main_path, mesh_modes, mesh_soft_ao_scene, poses,
        reframe, sphere_crowd, two_mesh_scene,
    )
    from surfjax_torch.kernels.render_tile import (
        crowd_warp_masks, prime_frame, prime_tile, split_crowd,
    )
    from surfjax_torch.tools.breakdown import (
        crowd_variants, fused_path, kf_phases, mesh_phases, split_phases,
    )
    from surfjax_torch.kernels.mesh_tile import (
        MT_TEST_OPS, mesh_cull_count, mesh_warp_masks,
    )
    from surfjax_torch.tools.workload import mesh_probe_calls
    from surfjax_torch.kernels.render_tile import staged_occupancy
    from surfjax_torch.tools.workload import cull_edge_scene
    smi = gpu_line()
    log(f"phase 0: gpu {smi} ({time.perf_counter() - t0:.2f} s)")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # -- phase 1 ------------------------------------------------------------
    t1 = time.perf_counter()
    info = _build.build()
    _build.load()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "Compiling entry" in ln or "registers" in ln or "spill" in ln
             or "stack frame" in ln]
    for ln in ptxas:
        log(f"  ptxas: {ln}")
    log(f"  the fused kernel on c3 before the crowd loops and t0: "
        f"{KF_BEFORE}; now: see kf_staged_kernel<false> (staging, "
        "persistent blocks) above and phase 4")
    built = _build.entries(info["log"])
    for name, lines in PTXAS_KEPT.items():
        if built.get(name) != lines:
            raise AssertionError(f"ptxas' report of {name} changed: "
                                 f"{built.get(name)}, was {lines}")
    log(f"  ptxas' report of {len(PTXAS_KEPT)} entries (kf_frame_kernel"
        "<true>, K1, K2 and ao_fix with a crowd, ao_fix without, the staged "
        "fused kernel) unchanged")
    c3_scene, _, c3_set, _ = load_config(os.path.join(ROOT,
                                                      "configs/c3_sdf.yaml"))
    static, params = c3_scene.freeze()
    occ = staged_occupancy(SceneTensors(static, params_to_device(params, dev)),
                           c3_set, dev)
    log(f"  staged kernel on c3: {occ['bytes']} bytes of shared memory per "
        f"block, {occ['blocks_per_sm']} blocks of 128 threads resident per "
        "SM")
    log(f"phase 1: built {os.path.relpath(info['path'], ROOT)} "
        f"(nvcc {info['seconds']:.1f} s, built={info['built']}) "
        f"({time.perf_counter() - t1:.1f} s)")

    # -- phase 2 ------------------------------------------------------------
    t2 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    cases = [("c1", "configs/c1_sphere.yaml", {}),
             ("c2", "configs/c2_csg.yaml", {}),
             ("c5", "configs/c5_anim.yaml", {}),
             ("c3 value", "configs/c3_sdf.yaml", {}),
             ("c3 value_exact", "configs/c3_sdf.yaml", EXACT),
             ("c3_portlog value_exact", "configs/c3_sdf_portlog.yaml", EXACT),
             ("c3 value ragged", "configs/c3_sdf.yaml", {})]
    max_err = 0.0
    for name, cfg, over in cases:
        scene, camera, settings, _ = load_config(os.path.join(ROOT, cfg))
        camera = reframe(camera, *(RAGGED if "ragged" in name
                                   else (256, 256)))
        settings = settings.with_(backend="pallas", **over)
        Rs, ps = poses(camera, 2, rng.normal(0.0, 1e-3, (2, 3)))
        before = frame_fused.launches
        k_ms, fb = cuda_ms(lambda: render_sequence(
            scene, camera, (Rs, ps), settings, device=dev), 1)
        if frame_fused.launches != before + 1:
            raise AssertionError(f"{name}: expected one kernel launch, "
                                 f"counted {frame_fused.launches - before}")
        static, params = scene.freeze()
        scene_t = SceneTensors(static, params_to_device(params, dev))
        p_ms, ref = cuda_ms(lambda: frame_fused_reference(
            scene_t, settings, camera.intrinsics, cam_rows_of(Rs, ps, dev)), 1)
        max_err = max(max_err, bitwise(fb, frame_buffers(ref),
                                       FrameBuffers._fields, name))
        log(f"  {name}: kernel {k_ms[0]:.3f} ms, plain twin {p_ms[0]:.1f} ms "
            f"({camera.intrinsics.width}x{camera.intrinsics.height} x 2 "
            "frames)")
    log(f"phase 2: kernel vs plain on the card passed for {len(cases)} "
        f"cases ({time.perf_counter() - t2:.1f} s)")

    # -- phase 3 ------------------------------------------------------------
    t3 = time.perf_counter()
    scene, camera, Rs, ps, modes = main_path(
        os.path.join(ROOT, "configs/c3_sdf.yaml"))
    n_frames = len(ps)
    n_objects = len(scene.objects)
    H, W = camera.intrinsics.height, camera.intrinsics.width
    results = {}
    frame_fused.launches = 0
    for mode, st in modes.items():
        call = lambda st=st: render_sequence(scene, camera, (Rs, ps), st,
                                             device=dev)
        call()
        torch.cuda.synchronize()
        times, fb = cuda_ms(call, 3)
        results[mode] = (times, st, fb)
    main_launches = frame_fused.launches
    if main_launches < 1:
        raise AssertionError("the main path launched no kernel")
    for mode, (times, st, fb) in results.items():
        # the camera moves 1e-4 per frame on each axis; on the H100 the hit
        # fraction moved by at most 3.7e-5 from one frame to the next and
        # by 1.26e-3 from frame 0 to frame 47 (the twin agrees), so each
        # bound below leaves about twice that, or five times for a step
        step, drift = check_sequence(mode, fb, n_objects, 2e-4, 2.5e-3)
        single = render(scene, dataclasses.replace(
            camera, position=tuple(float(x) for x in ps[0])), st, device=dev)
        for field in FrameBuffers._fields:
            if not torch.equal(getattr(single, field), getattr(fb, field)[0]):
                raise AssertionError(f"{mode}: frame 0 of the sequence "
                                     f"differs from render() in {field}")
        n_hits = float(fb.hit.sum()) / n_frames
        rays = float(W * H) + n_hits * len(scene.lights) * st.shadows \
            + n_hits * st.ao_samples * st.ao
        s_frame = min(times) / 1e3 / n_frames
        results[mode] = dict(
            ms_per_frame=min(times) / n_frames,
            ms_per_call=[round(t, 3) for t in times],
            frames_per_s=1.0 / s_frame, rays_per_frame=rays,
            mrays_per_s=rays / s_frame / 1e6, hit_fraction=n_hits / (W * H),
            hit_fraction_drift=drift, hit_fraction_max_step=step)
        log(f"  {mode}: " + json.dumps(results[mode]))
    log(f"phase 3: main path 1920x1080 x {n_frames} frames, kernel launches "
        f"{main_launches}, outputs checked ({time.perf_counter() - t3:.1f} s)"
        f" on {smi}")

    # -- phase 4 ------------------------------------------------------------
    # the wrapper at the main path's shape (48 frames of 1920x1080), held
    # bitwise against the twin on its first, middle and last frame
    t4 = time.perf_counter()
    static, params = scene.freeze()
    scene_t = SceneTensors(static, params_to_device(params, dev))
    rows = cam_rows_of(Rs, ps, dev)
    per_frame = {}
    for mode, st in modes.items():
        frame_fused(scene_t, st, camera.intrinsics, rows)
        k_ms, k_out = cuda_ms(
            lambda: frame_fused(scene_t, st, camera.intrinsics, rows), 3)
        p_ms = []
        for f in (0, n_frames // 2, n_frames - 1):
            ms, ref = cuda_ms(lambda: frame_fused_reference(
                scene_t, st, camera.intrinsics, rows[f:f + 1]), 1)
            p_ms += ms
            max_err = max(max_err, bitwise(
                tuple(a[f:f + 1] for a in k_out), ref, NINE,
                f"c3 {mode} 1080p frame {f}"))
        per_frame[mode] = (min(k_ms) / n_frames, sum(p_ms) / len(p_ms))
        log(f"  {mode}: kernel {per_frame[mode][0]:.4f} ms/frame "
            f"({n_frames} frames per launch), plain twin "
            f"{per_frame[mode][1]:.1f} ms/frame")
    log(f"phase 4: kernel vs plain at 1920x1080 x {n_frames} frames "
        f"({time.perf_counter() - t4:.1f} s) on {smi}")

    # KF's bound: the twin's operations on frame 0 in value_exact mode
    with count_ops() as kf_ops:
        frame_fused_reference(scene_t, modes["value_exact"],
                              camera.intrinsics, rows[:1])
    kf_bound = bound(kf_ops["ops"], 9 * 4 * W * H)
    log(f"  fused kernel bound per 1080p frame: {kf_ops['ops']:.4g} ops, "
        f"{kf_bound[0]:.4f} ms ({kf_bound[1]})")
    # Mandelbulb iteration-lanes of frame 0 in both modes, for phase 12
    with count_ops() as kf_ops_value:
        frame_fused_reference(scene_t, modes["value"], camera.intrinsics,
                              rows[:1])
    c3_bulb = {"value": kf_ops_value["bulb_iters"],
               "value_exact": kf_ops["bulb_iters"]}
    c3_bulb_form = modes["value"].bulb_iter
    log(f"  Mandelbulb iteration-lanes per 1080p frame ({c3_bulb_form}): "
        + json.dumps(c3_bulb))

    # -- phase 5 ------------------------------------------------------------
    t5 = time.perf_counter()
    import surfjax_torch.api as api
    split = ("render_tile", "trace_rays", "ao_fix", "mesh_tile")
    c4_path = os.path.join(ROOT, "configs/c4_mesh.yaml")
    c4_scene, c4_cam, c4_st, _ = load_config(c4_path)
    cases = [(f"c4 {mode}", c4_scene, reframe(c4_cam, 256, 256), st)
             for mode, st in mesh_modes(c4_st).items()]
    cases += [(name, *build(api, 256)) for name, build in
              (("mesh_soft_ao", mesh_soft_ao_scene),
               ("two_meshes", two_mesh_scene))]
    split_err = dict.fromkeys(split, 0.0)
    for name, scene5, cam5, st5 in cases:
        with capture_calls() as calls:
            render(scene5, cam5, st5, device=dev)
        for k, (kname, args) in enumerate(calls):
            err, _, _ = compare(kname, args, f"{name} call {k}")
            split_err[kname] = max(split_err[kname], err)
        log(f"  {name}: {len(calls)} kernel calls bitwise equal "
            f"({', '.join(sorted({c[0] for c in calls}))})")
    probes = mesh_probe_calls(api, dev)
    for name, args in probes:
        err, _, _ = compare("mesh_tile", args, name)
        split_err["mesh_tile"] = max(split_err["mesh_tile"], err)
    log(f"  mesh_tile bitwise equal on {', '.join(n for n, _ in probes)}")
    log(f"phase 5: split kernels vs plain on the card passed for "
        f"{len(cases)} scenes at 256x256 and {len(probes)} mesh probes "
        f"({time.perf_counter() - t5:.1f} s)")

    # -- phase 6 ------------------------------------------------------------
    t6 = time.perf_counter()
    scene, camera, Rs, ps, modes = mesh_main_path(c4_path)
    n_frames = len(ps)
    n_objects = len(scene.objects)
    H, W = camera.intrinsics.height, camera.intrinsics.width
    wrappers = dict(zip(split, (render_tile, trace_rays, ao_fix, mesh_tile)))
    mesh_results, mesh_launches = {}, {}
    for mode, st in modes.items():
        call = lambda st=st: render_sequence(scene, camera, (Rs, ps), st,
                                             device=dev)
        for w in list(wrappers.values()) + [frame_fused]:
            w.launches = 0
        call()
        torch.cuda.synchronize()
        times, fb = cuda_ms(call, 3)
        mesh_launches[mode] = {name: w.launches
                               for name, w in wrappers.items()}
        mesh_launches[mode]["frame_fused"] = frame_fused.launches
        mesh_results[mode] = (times, st, fb)
    for mode, (times, st, fb) in mesh_results.items():
        counts = mesh_launches[mode]
        needed = [k for k in split if k != "ao_fix" or st.ao]
        if any(counts[k] < 1 for k in needed) or counts["frame_fused"]:
            raise AssertionError(f"{mode}: launch counts {counts}")
        step, drift = check_sequence(mode, fb, n_objects, MESH_STEP_MAX,
                                     MESH_DRIFT_MAX)
        single = render(scene, dataclasses.replace(
            camera, position=tuple(float(x) for x in ps[0])), st, device=dev)
        for field in FrameBuffers._fields:
            if not torch.equal(getattr(single, field), getattr(fb, field)[0]):
                raise AssertionError(f"{mode}: frame 0 of the sequence "
                                     f"differs from render() in {field}")
        n_hits = float(fb.hit.sum()) / n_frames
        rays = float(W * H) + n_hits * len(scene.lights) * st.shadows \
            + n_hits * st.ao_samples * st.ao
        s_frame = min(times) / 1e3 / n_frames
        mesh_results[mode] = dict(
            ms_per_frame=min(times) / n_frames,
            ms_per_call=[round(t, 3) for t in times],
            frames_per_s=1.0 / s_frame, rays_per_frame=rays,
            mrays_per_s=rays / s_frame / 1e6, hit_fraction=n_hits / (W * H),
            hit_fraction_drift=drift, hit_fraction_max_step=step,
            launches=counts)
        log(f"  {mode}: " + json.dumps(mesh_results[mode]))
    log(f"phase 6: mesh main path 1920x1080 x {n_frames} frames "
        f"({time.perf_counter() - t6:.1f} s) on {smi}")

    # -- phase 7 ------------------------------------------------------------
    # every split kernel call of one 1080p frame, kernel against plain
    t7 = time.perf_counter()
    cam0 = dataclasses.replace(camera,
                               position=tuple(float(x) for x in ps[0]))
    per_kernel = {}
    for mode, st in modes.items():
        with capture_calls() as calls:
            render(scene, cam0, st, device=dev)
        stats = {k: dict(ms=0.0, call_ms=0.0, plain_ms=0.0, ops=0, bytes=0,
                         calls=0) for k in split}
        for k, (kname, args) in enumerate(calls):
            wrapper = KERNELS[kname][0]
            c_ms, _ = cuda_ms(lambda: wrapper(*args), 3)
            # the kernel alone: prepared once, launched back to back
            launch, _ = KERNELS[kname][3](*args)
            launch()
            k_ms, _ = cuda_ms(lambda: [launch() for _ in range(LAUNCH_REPS)],
                              3)
            p_ms, _ = cuda_ms(lambda: KERNELS[kname][1](*args), 1)
            err, got, _ = compare(kname, args, f"c4 {mode} 1080p call {k}")
            split_err[kname] = max(split_err[kname], err)
            if kname == "mesh_tile":
                culled = mesh_cull_count(args, mesh_warp_masks(
                    *args[:7], args[9]))
                ops = culled["ops"]
                unculled = int(mesh_tile_reference(
                    *args, count_tests=True)[-1].sum())
                log(f"  {mode} call {k} mesh_tile: culled "
                    f"{json.dumps(culled)}; unculled lane-tests {unculled}"
                    f" ({MT_TEST_OPS * unculled:.4g} ops)")
            else:
                with count_ops() as c:
                    KERNELS[kname][1](*args)
                ops = c["ops"]
            s_ = stats[kname]
            s_["ms"] += min(k_ms) / LAUNCH_REPS
            s_["call_ms"] += min(c_ms)
            s_["plain_ms"] += p_ms[0]
            s_["ops"] += ops
            s_["bytes"] += bytes_read(kname, args) + nbytes(got)
            s_["calls"] += 1
        per_kernel[mode] = stats
        log(f"  {mode}: " + json.dumps(stats))
    log(f"phase 7: split kernels vs plain at one 1920x1080 frame "
        f"({time.perf_counter() - t7:.1f} s) on {smi}")

    # -- phase 8 ------------------------------------------------------------
    # the crowd loops: kernel against plain and crowd on against crowd off
    t8 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    demo_path = os.path.join(ROOT, "configs/crowd_demo.yaml")
    demo_scene, demo_cam, demo_st, _ = load_config(demo_path)
    if not demo_st.vector_objects:
        raise AssertionError("crowd_demo.yaml no longer sets vector_objects")
    cases = {name: (sc, reframe(cam, 256, 256), st)
             for name, (sc, cam, st) in crowd_cases(api).items()}
    for mode, over in (("config", {}), ("soft", dict(soft_shadows=True))):
        for size in ((256, 256), RAGGED):
            cases[f"crowd_demo {mode} {size[0]}x{size[1]}"] = (
                demo_scene, reframe(demo_cam, *size),
                demo_st.with_(backend="pallas", vector_objects=False,
                              **over))
        cases[f"cull edges {mode}"] = cull_edge_scene(
            api, RAGGED, soft=mode == "soft")
    crowd_err, crowd_ulp = 0.0, 0
    for name, (scene8, cam8, st8) in cases.items():
        on = st8.with_(vector_objects=True)
        static, params = scene8.freeze()
        if split_crowd(static, on)[0] is None:
            raise AssertionError(f"{name}: no crowd formed")
        Rs, ps = poses(cam8, 2, rng.normal(0.0, 1e-3, (2, 3)))
        if name == "crowd + mesh":
            with capture_calls() as calls:
                fb_on = render_sequence(scene8, cam8, (Rs, ps), on,
                                        device=dev)
            if not {"render_tile", "trace_rays", "ao_fix", "mesh_tile"} <= \
                    {c[0] for c in calls}:
                raise AssertionError(f"{name}: calls {[c[0] for c in calls]}")
            for k, (kname, args) in enumerate(calls):
                err, _, _ = compare(kname, args, f"{name} call {k}")
                split_err[kname] = max(split_err[kname], err)
            log(f"  {name}: {len(calls)} split kernel calls bitwise equal")
        else:
            scene_t = SceneTensors(static, params_to_device(params, dev))
            before = frame_fused.launches
            fb_on = render_sequence(scene8, cam8, (Rs, ps), on, device=dev)
            if frame_fused.launches != before + 1:
                raise AssertionError(f"{name}: expected one kernel launch")
            rows8 = cam_rows_of(Rs, ps, dev)
            ref = frame_fused_reference(scene_t, on, cam8.intrinsics, rows8)
            crowd_err = max(crowd_err, bitwise(
                fb_on, frame_buffers(ref), FrameBuffers._fields, name))
            # the culled twin: each warp visits only its masked members
            masks8 = crowd_warp_masks(scene_t, on, cam8.intrinsics, rows8)
            ref = frame_fused_reference(scene_t, on, cam8.intrinsics, rows8,
                                        masks=masks8)
            crowd_err = max(crowd_err, bitwise(
                fb_on, frame_buffers(ref), FrameBuffers._fields,
                f"{name}, masked twin"))
        fb_off = render_sequence(scene8, cam8, (Rs, ps), st8, device=dev)
        ulp = on_equals_off(name, fb_on, fb_off)
        crowd_ulp = max(crowd_ulp, ulp)
        log(f"  {name}: crowd on == crowd off (geometry bitwise, rgb "
            f"{ulp} ULP)")
    log(f"phase 8: crowd kernels vs plain and crowd on vs off passed for "
        f"{len(cases)} scenes at 256x256 x 2 frames, rgb max ULP "
        f"{crowd_ulp} ({time.perf_counter() - t8:.1f} s)")

    # -- phase 9 ------------------------------------------------------------
    # the crowd main path: crowd_demo at 1920x1080 x 48 frames
    t9 = time.perf_counter()
    workload9 = crowd_main_path(demo_path)
    scene, camera, Rs, ps, modes = workload9
    n_frames = len(ps)
    H, W = camera.intrinsics.height, camera.intrinsics.width
    static, params = scene.freeze()
    scene_t = SceneTensors(static, params_to_device(params, dev))
    rows = cam_rows_of(Rs, ps, dev)
    crowd_results = {}
    frame_fused.launches = 0
    for mode, st in modes.items():
        call = lambda st=st: render_sequence(scene, camera, (Rs, ps), st,
                                             device=dev)
        call()
        torch.cuda.synchronize()
        times, fb = cuda_ms(call, 3)
        crowd_results[mode] = (times, st, fb)
    crowd_launches = frame_fused.launches
    if crowd_launches < 1:
        raise AssertionError("the crowd main path launched no kernel")
    for mode, (times, st, fb) in crowd_results.items():
        step, drift = check_sequence(mode, fb, len(scene.objects),
                                     CROWD_STEP_MAX, CROWD_DRIFT_MAX)
        if len(torch.unique(fb.obj_id[0])) < 40:
            raise AssertionError(f"{mode}: fewer than 40 objects in view")
        if torch.equal(fb.depth[0], fb.depth[-1]):
            raise AssertionError(f"{mode}: the camera path did not move")
        # the same call with the crowd off (49 objects fit the per-object
        # path), once, for the record
        off_ms, fb_off = cuda_ms(lambda st=st: render_sequence(
            scene, camera, (Rs, ps), st.with_(vector_objects=False),
            device=dev), 1)
        ulp = on_equals_off(f"crowd_demo {mode} 1080p", fb, fb_off)
        n_hits = float(fb.hit.sum()) / n_frames
        rays = float(W * H) + n_hits * len(scene.lights) * st.shadows \
            + n_hits * st.ao_samples * st.ao
        s_frame = min(times) / 1e3 / n_frames
        crowd_results[mode] = dict(
            ms_per_frame=min(times) / n_frames,
            ms_per_call=[round(t, 3) for t in times],
            ms_per_frame_crowd_off=off_ms[0] / n_frames, rgb_ulp_vs_off=ulp,
            frames_per_s=1.0 / s_frame, rays_per_frame=rays,
            mrays_per_s=rays / s_frame / 1e6, hit_fraction=n_hits / (W * H),
            hit_fraction_drift=drift, hit_fraction_max_step=step)
        log(f"  {mode}: " + json.dumps(crowd_results[mode]))
    # the kernel alone at the main path's shape against the twin, which
    # visits every member: frames 0, 24 and 47 of `config`, 0 and 47 of
    # `soft` (the penumbra capsules, the widest culling regions)
    p_ms = []
    for mode, frames in (("config", (0, n_frames // 2, n_frames - 1)),
                         ("soft", (0, n_frames - 1))):
        st = modes[mode]
        k_out = frame_fused(scene_t, st, camera.intrinsics, rows)
        for f in frames:
            ms, ref = cuda_ms(lambda: frame_fused_reference(
                scene_t, st, camera.intrinsics, rows[f:f + 1]), 1)
            if mode == "config":
                p_ms += ms
            crowd_err = max(crowd_err, bitwise(
                tuple(a[f:f + 1] for a in k_out), ref, NINE,
                f"crowd_demo {mode} 1080p frame {f}"))
    # the warps' member masks at frame 0, and the bound: the operations of
    # the culled algorithm (the twin visiting the masked members only)
    for mode, st9 in modes.items():
        masks9 = crowd_warp_masks(scene_t, st9, camera.intrinsics, rows[:1])
        log(f"  {mode}: masked members per warp (mean, largest) of "
            f"{len(split_crowd(static, st9)[0].members)}, frame 0: "
            + json.dumps(masks9.counts()))
        if mode == "config":
            with count_ops() as crowd_ops:
                frame_fused_reference(scene_t, st9, camera.intrinsics,
                                      rows[:1], masks=masks9)
    crowd_bound = bound(crowd_ops["ops"], 9 * 4 * W * H)
    # the kernel alone by feature, the whole call and a traced call
    # (tools/breakdown.py): PERF.md's breakdown and the kernels line's time
    by_feature = {}
    fused_path("crowd_demo", workload9, dev, crowd_variants, by_feature)
    crowd_frame = (min(by_feature["crowd_demo config"]["kernel_full"]),
                   sum(p_ms) / len(p_ms))
    log(f"  config: kernel {crowd_frame[0]:.4f} ms/frame ({n_frames} frames "
        f"per launch), plain twin {crowd_frame[1]:.1f} ms/frame; bound "
        f"{crowd_ops['ops']:.4g} ops, {crowd_bound[0]:.4f} ms "
        f"({crowd_bound[1]})")
    log(f"phase 9: crowd main path 1920x1080 x {n_frames} frames, kernel "
        f"launches {crowd_launches} ({time.perf_counter() - t9:.1f} s) on "
        f"{smi}")

    # -- phase 10 -----------------------------------------------------------
    # cone priming: the kernel against plain, then primed c3 at 1080p
    t10 = time.perf_counter()
    c3_scene, c3_cam, c3_st, _ = load_config(
        os.path.join(ROOT, "configs/c3_sdf.yaml"))
    c3_st = c3_st.with_(backend="pallas", prime=True)
    prime_err = 0.0
    for size in ((256, 256), (1920, 1080)):
        cam10 = reframe(c3_cam, *size)
        st10 = c3_st.with_(prime_min=min(c3_st.prime_min, 256))
        prime_tile.launches = frame_fused.launches = 0
        with capture_calls() as calls:
            primed = render(c3_scene, cam10, st10, device=dev)
        counts = (prime_tile.launches, frame_fused.launches)
        if counts != (1, 1) or [c[0] for c in calls] != ["prime_tile"]:
            raise AssertionError(f"primed frame {size}: launches {counts}, "
                                 f"calls {[c[0] for c in calls]}")
        args = calls[0][1]
        err, got, _ = compare("prime_tile", args, f"prime_tile {size}")
        prime_err = max(prime_err, err)
        unprimed = render(c3_scene, cam10, st10.with_(prime=False),
                          device=dev)
        differ = int((primed.hit != unprimed.hit).sum())
        rgb_gap = float((primed.rgb - unprimed.rgb).abs().mean())
        log(f"  prime_tile {size[0]}x{size[1]}: {got[0].numel()} coarse rays "
            f"bitwise equal; primed hit mask differs from the unprimed on "
            f"{differ} pixels, mean |rgb| difference {rgb_gap:.3e}")
        if differ > PRIME_HIT_MAX * size[0] * size[1]:
            raise AssertionError(
                f"priming changed the hit flag of {differ} pixels (bound "
                f"{PRIME_HIT_MAX} of the frame)")
        if not bool(torch.isfinite(primed.rgb).all()):
            raise AssertionError("primed frame: non-finite rgb")
    prime_launches = counts[0]
    # times at 1080p: the priming kernel launched back to back, KF on one
    # frame with and without its t0, and the two render() calls
    launch, _ = KERNELS["prime_tile"][3](*args)
    launch()
    pk_ms, _ = cuda_ms(lambda: [launch() for _ in range(LAUNCH_REPS)], 3)
    pp_ms, _ = cuda_ms(lambda: KERNELS["prime_tile"][1](*args), 1)
    with count_ops() as prime_ops:
        KERNELS["prime_tile"][1](*args)
    n_coarse = got[0].numel()
    prime_bound = bound(prime_ops["ops"], 7 * 4 * n_coarse)
    static, params = c3_scene.freeze()
    scene_t = SceneTensors(static, params_to_device(params, dev))
    R10, pos10 = (torch.as_tensor(np.asarray(a, np.float32).reshape(-1),
                                  device=dev)
                  for a in (cam10.rotation, cam10.position))
    t0 = prime_frame(static, cam10.intrinsics, st10, scene_t.params, R10,
                     pos10)[None]
    row = torch.cat([R10, pos10]).reshape(1, 12)
    kf_t0, out_t0 = cuda_ms(lambda: frame_fused(
        scene_t, st10, cam10.intrinsics, row, t0), 5)
    kf_no, _ = cuda_ms(lambda: frame_fused(
        scene_t, st10, cam10.intrinsics, row), 5)
    ref = frame_fused_reference(scene_t, st10, cam10.intrinsics, row, t0)
    prime_err = max(prime_err, bitwise(out_t0, ref, NINE,
                                       "c3 value 1080p primed"))
    call_p, _ = cuda_ms(lambda: render(c3_scene, cam10, st10, device=dev), 5)
    call_u, _ = cuda_ms(lambda: render(
        c3_scene, cam10, st10.with_(prime=False), device=dev), 5)
    prime_stats = dict(
        prime_tile_ms=min(pk_ms) / LAUNCH_REPS, plain_ms=pp_ms[0],
        ops=prime_ops["ops"], coarse_rays=n_coarse,
        kf_ms_with_t0=min(kf_t0), kf_ms_without_t0=min(kf_no),
        render_ms_primed=min(call_p), render_ms_unprimed=min(call_u),
        mean_t0=float(t0[t0 < st10.t_max].mean()))
    log("  primed c3 1080p: " + json.dumps(prime_stats))
    log(f"phase 10: priming kernel vs plain and the primed main path "
        f"({time.perf_counter() - t10:.1f} s) on {smi}")

    # -- phase 11 -----------------------------------------------------------
    # member-count scaling: sphere crowds at 1080p, 8 frames per call
    t11 = time.perf_counter()
    for n_members in (16, 64, 256):
        sc, cam11, st11 = sphere_crowd(api, n_members, size=(1920, 1080))
        Rs11, ps11 = poses(cam11, 8, rng.normal(0.0, 1e-3, (8, 3)))
        row = {}
        for label, vo in (("on", True), ("off", False)):
            if not vo and n_members + 1 > 64:
                row[label] = None      # the per-object path takes 64
                continue
            call = lambda vo=vo: render_sequence(
                sc, cam11, (Rs11, ps11), st11.with_(vector_objects=vo),
                device=dev)
            call()
            torch.cuda.synchronize()
            ms, fb = cuda_ms(call, 3)
            row[label] = min(ms) / 8
            row["hit_fraction"] = float(fb.hit.mean())
            row["objects_in_view"] = len(torch.unique(fb.obj_id[0])) - 1
            if vo:      # frame 0 against the twin, which visits every member
                static, params = sc.freeze()
                ref = frame_fused_reference(
                    SceneTensors(static, params_to_device(params, dev)),
                    st11.with_(vector_objects=True), cam11.intrinsics,
                    cam_rows_of(Rs11[:1], ps11[:1], dev))
                crowd_err = max(crowd_err, bitwise(
                    tuple(a[:1] for a in fb), frame_buffers(ref),
                    FrameBuffers._fields, f"{n_members} members frame 0"))
        if row["objects_in_view"] < min(n_members, 40) // 2:
            raise AssertionError(f"{n_members} members: {row}")
        log(f"  {n_members} members: " + json.dumps(row))
    log(f"phase 11: member-count scaling at 1920x1080, ms/frame "
        f"({time.perf_counter() - t11:.1f} s) on {smi}")


    # -- phase 12 -----------------------------------------------------------
    # the FP32 roofline probe: entries against plain, then the timed sweep
    t12 = time.perf_counter()
    from surfjax_torch.tools import fp32_peak as fp
    seeds = fp.seeds(fp.DEFAULT_ROWS, fp.DEFAULT_GRID, dev)
    n_lanes = seeds[0].numel()
    probe = {}     # entry -> dict(err, plain_ms, kind, fma)
    for pk in fp.KINDS:
        ref = fp.fp32_peak_reference(pk, *seeds, PROBE_K)
        for fma in ((False,) if pk in fp.CHAINS else (False, True)):
            entry = fp.entry_name(pk, fma)
            err = 0.0
            for unroll in fp.UNROLLS:
                got = fp.fp32_peak(pk, *seeds, PROBE_K, unroll, fma)
                torch.cuda.synchronize()
                err = max(err, float((got.double() - ref.double())
                                     .abs().max()))
                if fma:
                    rel = float(((got - ref).abs() / ref.abs()).max())
                    ok, how = rel <= 1e-5, f"relative gap {rel:.3e}"
                elif pk in fp.CHAINS:
                    ulp = int((got.view(torch.int32) - ref.view(torch.int32))
                              .abs().max())
                    ok, how = ulp <= 1, f"{ulp} ULP"
                else:
                    ok, how = torch.equal(got, ref), "not bitwise equal"
                if not ok:
                    raise AssertionError(f"{entry} unroll {unroll}: differs "
                                         f"from its plain version ({how})")
            probe[entry] = dict(err=err, kind=pk, fma=fma)
            log(f"  {entry}: K = {PROBE_K}, {n_lanes} lanes, unrolls "
                f"{fp.UNROLLS}: "
                + ("within 1e-5 of" if fma else
                   "within 1 ULP of" if pk in fp.CHAINS else
                   "bitwise equal to") + " the plain version")
    fp.fp32_peak.launches.clear()
    sweep = fp.run()
    probe_launches = dict(fp.fp32_peak.launches)
    for name, row in sweep.items():
        log("  " + fp.format_row(name, row))
    for mix in ("bulb_mix", "cheb_mix"):
        log(f"  {mix}: time with contraction over time without: "
            + json.dumps({f"u{u}": sweep[f"{mix}_fma@u{u}"]["ps_per_iter_lane"]
                          / sweep[f"{mix}@u{u}"]["ps_per_iter_lane"]
                          for u in fp.UNROLLS}))
    # what c3's Mandelbulb iterations cost at the probe's rate, beside
    # what the fused kernel achieves per iteration-lane with all its other
    # work (divergence, the march around the DE, AO, shadows) on top
    mix = "cheb_mix" if c3_bulb_form == "cheb" else "bulb_mix"
    best_ps = min(sweep[f"{mix}@u{u}"]["ps_per_iter_lane"]
                  for u in fp.UNROLLS)
    for mode, iters in c3_bulb.items():
        floor_ms = iters * best_ps * 1e-9
        log(f"  c3 {mode}: {iters} Mandelbulb iteration-lanes per 1080p "
            f"frame x {best_ps:.3f} ps ({mix}, best unroll) = "
            f"{floor_ms:.4f} ms of the fused kernel's "
            f"{per_frame[mode][0]:.4f} ms/frame "
            f"({floor_ms / per_frame[mode][0]:.1%}); the kernel achieves "
            f"{per_frame[mode][0] * 1e9 / iters:.3f} ps per iteration-lane "
            "all told")
    for entry, info in probe.items():
        pk, fma = info["kind"], info["fma"]
        k = fp.DEFAULT_ITERS * (fp.FMA_K_SCALE if pk in fp.CHAINS else 1)
        info["ms"] = sweep[f"{pk}{'_fma' if fma else ''}@u{PROBE_UNROLL}"][
            "ms_launch_K"]
        info["plain_ms"] = cuda_ms(
            lambda: fp.fp32_peak_reference(pk, *seeds, k), 1)[0][0]
        n_in = 1 if pk in fp.CHAINS else 3
        info["bound"] = bound(fp.ops_per_iter(pk) * float(n_lanes) * k,
                              4 * (n_in + 1) * n_lanes)
        if probe_launches.get(entry, 0) < 1:
            raise AssertionError(f"the sweep launched {entry} no time")
    log(f"phase 12: FP32 roofline probe, launches {probe_launches} "
        f"({time.perf_counter() - t12:.1f} s) on {smi}")

    # -- phase 13 -----------------------------------------------------------
    # the kernel-forward differentiable render on the card
    t13 = time.perf_counter()
    from surfjax_torch.core.camera import flat_camera_rays
    from surfjax_torch.diff import fit as fit_mod
    from surfjax_torch.diff.hybrid import render_rays_hybrid
    from surfjax_torch.kernels.render_tile import render_rays_pallas
    from surfjax_torch.tools.workload import fit_main_path, sdf_fit_start
    c5_path = os.path.join(ROOT, "configs/c5_anim.yaml")
    scene, camera, st, fit_cfg, pose_init = fit_main_path(c5_path)
    if (camera.intrinsics.width, camera.intrinsics.height) != (256, 256):
        raise AssertionError("c5_anim.yaml is no longer 256x256")
    static, params = scene.freeze()
    params_d = params_to_device(params, dev)
    R5, pos5 = (torch.as_tensor(np.asarray(a, np.float32).reshape(-1),
                                device=dev)
                for a in (camera.rotation, camera.position))
    o5, d5, _ = flat_camera_rays(camera.intrinsics, R5, pos5)
    with torch.no_grad():
        fb_p = render_rays_pallas(static, st, params_d, o5, d5)
    lp5 = params_d["leaf_params"].clone().requires_grad_(True)
    render_tile.launches = trace_rays.launches = 0
    fb_h = render_rays_hybrid(static, st, dict(params_d, leaf_params=lp5),
                              o5, d5)
    if (render_tile.launches, trace_rays.launches) != (1, len(scene.lights)):
        raise AssertionError(
            f"hybrid forward: launches K1 {render_tile.launches}, K2 "
            f"{trace_rays.launches}")
    hybrid_err = bitwise(tuple(a.detach() for a in fb_h), fb_p,
                         FrameBuffers._fields, "c5 hybrid forward vs "
                         "render_rays_pallas")
    if not fb_h.rgb.requires_grad:
        raise AssertionError("the hybrid's rgb carries no gradient")

    def flat_grad(g):
        return np.concatenate([g["w"], g["dt"]]).astype(np.float64)

    def gaps(l_a, g_a, l_b, g_b):
        a, b = flat_grad(g_a), flat_grad(g_b)
        return (abs(l_a - l_b) / max(abs(l_b), 1e-12),
                float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)),
                float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b),
                                  1e-30)))

    l_h, g_h = fit_mod.pose_loss_and_grad(scene, camera, st, device=dev)
    l_j, g_j = fit_mod.pose_loss_and_grad(
        scene, camera, st.with_(backend="jnp"), device=dev)
    l_c, g_c = fit_mod.pose_loss_and_grad(scene, camera, st, device="cpu")
    vs_jnp = gaps(l_h, g_h, l_j, g_j)
    vs_cpu = gaps(l_h, g_h, l_c, g_c)
    log(f"  pose probe: loss {l_h:.6g}; pallas vs jnp on the card: loss "
        f"{vs_jnp[0]:.3e} relative, gradient relative L2 {vs_jnp[1]:.3e}, "
        f"cosine {vs_jnp[2]:.6f}; card vs CPU plain versions: loss "
        f"{vs_cpu[0]:.3e}, gradient relative L2 {vs_cpu[1]:.3e}")
    if vs_jnp[0] > FIT_LOSS_REL or vs_jnp[1] > FIT_GRAD_REL or \
            vs_jnp[2] < FIT_GRAD_COS:
        raise AssertionError(f"hybrid vs eager pose gradient: {vs_jnp}")
    if vs_cpu[1] > FIT_CPU_REL or vs_cpu[0] > FIT_CPU_REL:
        raise AssertionError(f"hybrid gradient, card vs CPU: {vs_cpu}")
    if not np.isfinite(flat_grad(g_h)).all():
        raise AssertionError("non-finite pose gradient")
    # central finite differences of a smooth observable: the mean hit depth
    # over the central 8x8 pixels of one SDF sphere, to its leaf parameters
    fd_scene = api.Scene()
    fd_scene.add(api.Sphere(center=(0.0, 0.0, 3.0), radius=0.8),
                 api.Material.lambert((0.6, 0.4, 0.3)), engine="sdf")
    fd_scene.add_light(api.PointLight(position=(2.0, 3.0, -1.0)))
    fd_cam = api.Camera.pinhole(24, 24, 45.0, position=(0.0, 0.0, 0.0),
                                target=(0.0, 0.0, 3.0))
    fd_st = api.RenderSettings(backend="pallas", tile_rows=8, shadows=False)
    fd_static, fd_params = fd_scene.freeze()
    fd_params = params_to_device(fd_params, dev)
    o_fd, d_fd, _ = flat_camera_rays(
        fd_cam.intrinsics,
        torch.as_tensor(np.asarray(fd_cam.rotation, np.float32).reshape(9),
                        device=dev),
        torch.as_tensor(np.asarray(fd_cam.position, np.float32), device=dev))
    w_fd = torch.zeros((24, 24), device=dev)
    w_fd[8:16, 8:16] = 1.0 / 64.0
    w_fd = w_fd.reshape(-1)

    def depth_loss(lp):
        return (render_rays_hybrid(
            fd_static, fd_st, dict(fd_params, leaf_params=lp), o_fd,
            d_fd).depth * w_fd).sum()

    lp_fd = fd_params["leaf_params"]
    lp_g = lp_fd.clone().requires_grad_(True)
    g_fd, = torch.autograd.grad(depth_loss(lp_g), lp_g)
    v_fd = np.zeros(tuple(lp_fd.shape), np.float32)
    v_fd[0, :4] = np.random.default_rng(3).standard_normal(4)
    v_fd = torch.as_tensor(v_fd / np.linalg.norm(v_fd), device=dev)
    with torch.no_grad():
        fd = (float(depth_loss(lp_fd + 1e-3 * v_fd))
              - float(depth_loss(lp_fd - 1e-3 * v_fd))) / 2e-3
    an = float((g_fd * v_fd).sum())
    if abs(fd - an) > 2e-3 * max(abs(fd), abs(an), 1e-6):
        raise AssertionError(f"hybrid IFT gradient {an} against central "
                             f"finite differences {fd}")
    log(f"  IFT gradient {an:.6f} against central finite differences "
        f"{fd:.6f}")
    log(f"phase 13: hybrid render on the card passed "
        f"({time.perf_counter() - t13:.1f} s)")

    # -- phase 14 -----------------------------------------------------------
    # the fit main path: c5 as it is, pose then sdf, then the 1080p step
    t14 = time.perf_counter()
    from surfjax_torch.tools.fit_bench import bench_backend
    steps, lr, n_lights = fit_cfg["steps"], fit_cfg["lr"], len(scene.lights)
    frame_fused.launches = 0
    target = render(scene, camera, st, device=dev).rgb
    if frame_fused.launches != 1:
        raise AssertionError("the fit's target did not come from the fused "
                             "kernel")
    fit_counters = (render_tile, trace_rays, ao_fix, mesh_tile, frame_fused)
    fit_launches = {"render_tile": 0, "trace_rays": 0}

    def counted_fit(label, call):
        """Run one fit with every count at 0 -> (result, ms per step);
        holds the launch counts to one K1 and one K2 per light and step."""
        for w in fit_counters:
            w.launches = 0
        ms, out = cuda_ms(call, 1)
        got = [w.launches for w in fit_counters]
        if got != [steps, steps * n_lights, 0, 0, 0]:
            raise AssertionError(f"{label}: launches (K1, K2, ao_fix, mesh, "
                                 f"fused) {got} over {steps} steps")
        fit_launches["render_tile"] += got[0]
        fit_launches["trace_rays"] += got[1]
        return out, ms[0] / steps

    (R_fit, pos_fit, losses), pose_ms = counted_fit(
        "fit_pose", lambda: fit_mod.fit_pose(
            scene, camera, target, steps=steps, lr=lr, settings=st,
            init=pose_init, device=dev))
    if len(losses) != steps or not np.isfinite(losses).all() or \
            not losses[-1] < 0.05 * losses[0]:
        raise AssertionError(f"fit_pose did not converge: loss {losses[0]} "
                             f"-> {losses[-1]}")
    log(f"  fit_pose: {steps} steps, loss {losses[0]:.4e} -> "
        f"{losses[-1]:.4e}, {pose_ms:.3f} ms/step; position error "
        f"{float(np.abs(pos_fit - np.asarray(camera.position)).max()):.4f}")
    true_lp, init_lp, mask = sdf_fit_start(scene)
    (lp_fit, sdf_losses), sdf_ms = counted_fit(
        "fit_sdf", lambda: fit_mod.fit_sdf(
            scene, camera, target, steps=steps, lr=lr, settings=st,
            init_leaf_params=init_lp, param_mask=mask, device=dev))
    err0 = float(np.abs(init_lp - true_lp).max())
    err1 = float(np.abs(lp_fit - true_lp).max())
    if not (np.isfinite(sdf_losses).all() and sdf_losses[-1] < sdf_losses[0]
            and err1 < err0):
        raise AssertionError(f"fit_sdf did not improve: loss "
                             f"{sdf_losses[0]} -> {sdf_losses[-1]}, "
                             f"parameter error {err0} -> {err1}")
    log(f"  fit_sdf: {steps} steps, loss {sdf_losses[0]:.4e} -> "
        f"{sdf_losses[-1]:.4e}, parameter error {err0:.4f} -> {err1:.4f}, "
        f"{sdf_ms:.3f} ms/step")
    # the pose-fit step where the card has real work: 1920x1080
    render_tile.launches = trace_rays.launches = 0
    big = {be: bench_backend(be, n, 1, size=(1920, 1080), device=dev)
           for be, n in (("pallas", 20), ("jnp", 5))}
    if (render_tile.launches, trace_rays.launches) != (21, 21 * n_lights):
        raise AssertionError(
            f"1080p fit steps: launches K1 {render_tile.launches}, K2 "
            f"{trace_rays.launches}")
    fit_launches["render_tile"] += render_tile.launches
    fit_launches["trace_rays"] += trace_rays.launches
    for be, r in big.items():
        if not np.isfinite(r["final_loss"]):
            raise AssertionError(f"1080p fit step on {be}: {r}")
        log(f"  pose-fit step at 1920x1080, {be}: " + json.dumps(r))
    # every K1 and K2 call of one fit step, kernel against plain, at the
    # shapes the fit gives them (a scene without a mesh, at both sizes)
    from surfjax_torch.tools.fit_bench import pose_step_fn
    fit_stats = {}
    for size in (None, (1920, 1080)):
        step_fn, x0, state0, intr = pose_step_fn("pallas", steps, size, dev)
        with capture_calls() as calls:
            step_fn(x0, state0)
        names = [c[0] for c in calls]
        if names != ["render_tile"] + ["trace_rays"] * n_lights:
            raise AssertionError(f"fit step at {intr.width}x{intr.height}: "
                                 f"kernel calls {names}")
        with torch.no_grad():
            for k, (kname, args) in enumerate(calls):
                err, got, _ = compare(kname, args, f"c5 fit step "
                                      f"{intr.width}x{intr.height} call {k}")
                split_err[kname] = max(split_err[kname], err)
                if size is None:
                    continue
                # K1 and K2 of the 1080p step: time (launched back to
                # back) and bound, by the plain version's operations and
                # the bytes each call must move
                launch, _ = KERNELS[kname][3](*args)
                launch()
                k_ms, _ = cuda_ms(
                    lambda: [launch() for _ in range(LAUNCH_REPS)], 3)
                with count_ops() as c:
                    KERNELS[kname][1](*args)
                f_ = fit_stats.setdefault(kname, dict(ms=0.0, ops=0,
                                                      bytes=0))
                f_["ms"] += min(k_ms) / LAUNCH_REPS
                f_["ops"] += c["ops"]
                f_["bytes"] += bytes_read(kname, args) + nbytes(got)
        log(f"  fit step at {intr.width}x{intr.height}: {len(calls)} kernel "
            f"calls bitwise equal ({', '.join(names)})")
    log("  K1, K2 in one 1080p fit step: " + json.dumps(fit_stats))
    log(f"phase 14: fit main path, launches {fit_launches} "
        f"({time.perf_counter() - t14:.1f} s) on {smi}")

    # -- phase 15 -----------------------------------------------------------
    # where the fused kernel's time goes: the profiles of the staged kernel
    # and of the per-pixel kernel it replaced on frame 0 of c3
    t15 = time.perf_counter()
    phases = {}
    kf_phases(dev, phases)
    for key, entry in phases.items():
        groups = {g: [round(v["cycles_share"], 4),
                      None if v["simt"] is None else round(v["simt"], 3),
                      None if v["evals_per_hit"] is None
                      else round(v["evals_per_hit"], 2)]
                  for g, v in entry["phases"]["groups"].items()}
        log(f"  {key}: profiled {min(entry['ms_profiled']):.4f} ms (staged "
            f"kernel {min(entry['ms_staged']):.4f}); per phase group [cycle "
            f"share, SIMT efficiency, SDF evaluations per hit pixel]: "
            + json.dumps(groups))
    log(f"phase 15: the fused kernel's phase profile on c3 frame 0 "
        f"({time.perf_counter() - t15:.1f} s) on {smi}")

    # -- phase 16 -----------------------------------------------------------
    # where the mesh kernel's time goes: its profile on c4 frame 0 at 1080p
    t16 = time.perf_counter()
    mesh_prof = {}
    mesh_phases(dev, mesh_prof)
    for key, entry in mesh_prof.items():
        if key.startswith("mesh sass"):
            log(f"  {key}: loops (instructions, fp32, shared, global, "
                "shuffle): " + json.dumps(
                    [[lp[k] for k in ("instructions", "fp32", "shared",
                                      "global", "shuffle")]
                     for lp in entry]))
            continue
        shares = {k: round(v, 4) for k, v in entry["cycles_share"].items()}
        log(f"  {key}: {entry['ms']:.4f} ms (profiled "
            f"{entry['ms_profiled']:.4f}); cycle shares {json.dumps(shares)}; "
            f"SIMT {entry['simt']:.3f}; lane-tests {entry['lane_tests']:.0f} "
            f"(unculled {entry['unculled_lane_tests']}); overflow tiles' "
            f"cycles {entry['cycles_overflow_share']:.4f}; candidates "
            + json.dumps(entry["candidates"]))
    log(f"phase 16: the mesh kernel's phase profile on c4 frame 0 "
        f"({time.perf_counter() - t16:.1f} s) on {smi}")

    # -- phase 17 -----------------------------------------------------------
    # where K1's and K2's time goes: c4 frame 0 at 1080p and a 1080p fit step
    t17 = time.perf_counter()
    split_prof = {}
    split_phases(dev, split_prof)
    for key, entry in split_prof.items():
        if key.startswith("split entry"):
            log(f"  {key}: {entry['ptxas'][1]}; SASS local loads and "
                f"stores {json.dumps(entry['sass'])}")
            continue
        alone = {k: round(v, 4) for k, v in entry.items()
                 if k.startswith("ms")}
        groups = {g: [round(v["cycles_share"], 4),
                      None if v["simt"] is None else round(v["simt"], 3),
                      None if v["evals_per_hit"] is None
                      else round(v["evals_per_hit"], 2)]
                  for g, v in entry["phases"]["groups"].items()}
        log(f"  {key} ({entry['lanes']} lanes): {json.dumps(alone)}; "
            f"{entry['evals']} SDF evaluations profiled (the plain version "
            f"{entry['plain_evals']} with the FD normals'); per phase group "
            "[cycle share, SIMT efficiency, SDF evaluations per lane]: "
            + json.dumps(groups))
    log(f"phase 17: K1's and K2's phase profile on c4 frame 0 and a 1080p "
        f"fit step ({time.perf_counter() - t17:.1f} s) on {smi}")

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    # the fused kernel: times per 1080p frame in value_exact mode, the
    # error the largest over every buffer of phases 2 and 4; the split
    # kernels: times per 1080p frame of c4 in `ao` mode (all calls of the
    # frame, each kernel launched back to back), launches over both modes
    # of phase 6, errors over phases 5, 7 and 8 and (K1, K2) the fit steps
    # held in phase 14, K1 and K2 also their time and bound in one 1080p
    # fit step (phase 14); the crowd instantiation:
    # crowd_demo `config` per 1080p frame, launches of phase 9, errors over
    # phases 8 and 9; the priming kernel: the 1080p frame of phase 10; K1
    # and K2 also count the fit's launches (phase 14); the probe's entries:
    # one launch at the tool's defaults (unroll 4), launches of its sweep
    kernels = [{
        "name": "frame_fused", "route": "cuda",
        "source": "surfjax_torch/kernels/csrc/kf_staged.cu",
        "replaces": "surfjax/kernels/render_tile.py:2196",
        "launches": main_launches, "max_abs_err": max_err,
        "ms": per_frame["value_exact"][0],
        "plain_ms": per_frame["value_exact"][1],
        "bound_ms": kf_bound[0], "bound_by": kf_bound[1],
        "library_ms": None}, {
        # the fused kernel's instantiation with the crowd's member loops
        "name": "frame_fused_crowd", "route": "cuda",
        "source": "surfjax_torch/kernels/csrc/frame_fused.cu",
        "replaces": "surfjax/kernels/render_tile.py:1013",
        "launches": crowd_launches, "max_abs_err": crowd_err,
        "ms": crowd_frame[0], "plain_ms": crowd_frame[1],
        "bound_ms": crowd_bound[0], "bound_by": crowd_bound[1],
        "library_ms": None}, {
        "name": "prime_tile", "route": "cuda",
        "source": "surfjax_torch/kernels/csrc/prime_tile.cu",
        "replaces": "surfjax/kernels/render_tile.py:634",
        "launches": prime_launches, "max_abs_err": prime_err,
        "ms": prime_stats["prime_tile_ms"],
        "plain_ms": prime_stats["plain_ms"],
        "bound_ms": prime_bound[0], "bound_by": prime_bound[1],
        "library_ms": None}]
    sources = {"render_tile": ("split_staged.cu", "render_tile.py:2005"),
               "trace_rays": ("split_staged.cu", "render_tile.py:2037"),
               "ao_fix": ("split_path.cu", "render_tile.py:1954"),
               "mesh_tile": ("mesh_tile.cu", "mesh_tile.py:348")}
    for name in split:
        st7 = per_kernel["ao"][name]
        b = bound(st7["ops"], st7["bytes"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"surfjax_torch/kernels/csrc/{sources[name][0]}",
            "replaces": f"surfjax/kernels/{sources[name][1]}",
            "launches": sum(c[name] for c in mesh_launches.values())
            + fit_launches.get(name, 0),
            "max_abs_err": split_err[name], "ms": st7["ms"],
            "plain_ms": st7["plain_ms"], "bound_ms": b[0], "bound_by": b[1],
            "library_ms": None})
        if name in fit_stats:
            f_ = fit_stats[name]
            fb_ = bound(f_["ops"], f_["bytes"])
            kernels[-1].update(fit_ms=f_["ms"], fit_bound_ms=fb_[0],
                               fit_bound_by=fb_[1])
    for entry, info in probe.items():
        kernels.append({
            "name": entry, "route": "cuda",
            "source": "surfjax_torch/kernels/csrc/fp32_peak"
                      + ("_fma.cu" if info["fma"] else ".cu"),
            "replaces": "tools/vpu_peak.py:264",
            "launches": probe_launches[entry], "max_abs_err": info["err"],
            "ms": info["ms"], "plain_ms": info["plain_ms"],
            "bound_ms": info["bound"][0], "bound_by": info["bound"][1],
            "library_ms": None})
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
