#!/usr/bin/env python3
"""Drive surfjax_torch's fused-frame, split (mesh), crowd, primed, fit and
sharded paths, its benchmark harness and its FP32 roofline probe on one
CUDA GPU and check them.

    python3 chip_smoke.py

Phases (each prints its own line with its seconds; any failure raises, so
the script exits non-zero and never prints its last line):
  0. versions, the card's name and power limit; refuses to run without CUDA;
  1. builds the CUDA kernels from surfjax_torch/kernels/csrc (one nvcc per
     source, in parallel), prints ptxas' registers and spills of every
     entry and holds those of the crowd instantiation kf_frame_kernel<true>,
     of K1, K2 and ao_fix with a crowd, of the staged fused kernel and of
     the staged K1 and K2 to what they were before the staged ao_fix (K1's
     and K2's launches without a march cap to what they were before the
     caps, those with unres to the caps' first build; K1 and K2 with a
     crowd to their culled build, ao_fix with a crowd to its redesign's
     build, ao_fix_crowd.cu);
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
     settings; `ao`: AO and soft shadows on), one pass of the split path
     over all 16 frames: the first call's launches per pass (K1, K2 per
     light, ao_fix where AO is on, the mesh kernel and the candidate
     kernel for the primary rays and per light, the fused kernel never)
     and its peak memory, then
     three calls timed with CUDA events; output checks, every frame of
     every call bitwise equal to render() of that frame;
  7. every split kernel call of one more 16-frame c4 call per mode,
     launched again at the pass's shape, its rows of frames 0 and 15
     bitwise equal to its plain version run on those two frames alone
     (frame_cut: the ray arrays by rows, the mesh kernel's tables and
     the candidate kernel's outputs by tiles; out_rows); per frame: the
     kernel's and the wrapper's times, operations
     and bytes on frame 0's cut launched alone (one 1080p frame's call),
     the plain version's time (the two frames' halved) and the whole pass
     launched back to back over its frames (pass_ms); the mesh kernel's
     bound counts the culled algorithm it runs (its warps' votes, then
     each lane's voted candidates up to its first occluder), the candidate
     kernel's (mesh_candidates, csrc/mesh_candidates.cu) its bytes: the
     triangle table and each ray's origin, direction and segment end;
  8. the crowd loops (settings.vector_objects) in KF, K1, K2 and ao_fix
     against their plain versions, bitwise, at 256x256 x 2 frames: nine
     and four small objects with hard shadows + AO and with soft shadows,
     a crowd with no floor, pairs of all six CSG ops, analytic members,
     configs/crowd_demo.yaml in both modes (also at 250x131, which the
     kernel's blocks do not tile), the culling's edge scene in both modes
     (250x131) and a crowd beside a mesh through the split path; KF also
     against the culled twin (each warp visiting only the members in its
     masks), K1, K2 and ao_fix with a crowd against their masked plain
     versions the same way; each also with the crowd off: geometry
     bitwise equal, rgb within 2 ULP;
  9. the crowd main path: configs/crowd_demo.yaml (49 objects) at
     1920x1080, 48 camera positions in one render_sequence call, modes
     `config` (hard shadows + AO) and `soft` (soft shadows on): launch
     counts, outputs checked, frames 0, 24 and 47 of `config` against the
     twin, bitwise; once per mode with the crowd off, for the record; the
     masked members per warp of frame 0; the kernel alone with AO off,
     shadows off, both off and the crowd off;
 10. the priming kernel against its plain version, bitwise, at 256x256 and
     at 1920x1080; render(prime=True) on c3 at 1920x1080 launches
     prime_tile then KF with its t0; hit mask against the unprimed
     frame's, times with and without priming; the primed main path: c3
     (`value`, prime=True) at 1920x1080 x 16 frames in one
     render_sequence call, one pass: one priming launch over every
     frame's coarse rays and one KF launch, its peak memory, three calls
     timed, every frame of every call bitwise equal to a primed render()
     of that frame; the pass's priming launch over all 16 frames' coarse
     rays and its KF launch with all 16 t0, their coarse rows and pixels
     of frames 0 and 15 bitwise equal to the plain versions on those
     frames alone;
 11. member-count scaling: crowds of 16, 64 and 256 spheres at 1920x1080,
     frame 0 of each against the twin, bitwise;
 12. the FP32 roofline probe (tools/fp32_peak.py): every entry built with
     -fmad=false against its plain version, bitwise (the explicit-FMA chains
     within 1 ULP of their float64 plain versions), the contracted entries
     within 1e-5, at K = 16 on 64 x 256 x 128 lanes and every unroll; then
     the timed sweep at the tool's defaults (3 repeats): ps per
     iteration-lane and Tflop/s per row, contracted over uncontracted, and
     what c3's Mandelbulb iteration-lanes per 1080p frame cost at the
     probe's rate; then inside the mixes (tools/breakdown.py
     `probe_phases`, once per mix): the SM clock under load, cycles per
     substep per warp, the warps' finish spread and the SMs' busy share,
     the loop's SASS per substep by pipe, ptxas' registers, blocks per SM,
     the issue bound at the measured clock beside the operations bound;
     fma_dep's Tflop/s against the peak at that clock;
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
 17. where K1's, K2's and ao_fix's time goes (tools/breakdown.py,
     `split_phases`): on every K1, K2 and ao_fix call of frame 0 of c4 at
     1920x1080 in both modes and on every K1 and K2 call of one 1080p
     pose-fit step, the kernel's time, K1's with AO off, K2's on empty
     shadow segments and ao_fix's with need 0 on every lane, and the
     profiling instantiation of the staged kernels: its outputs equal to
     the plain version's, its SDF evaluations equal to the plain version's
     count (and on c4 AO's to lanes x taps: for ao_fix its needing lanes'),
     per phase group the share of the warps' cycles, the SIMT efficiency
     and the SDF evaluations per lane; each K1, K2 and ao_fix entry's local
     loads and stores (SASS);
 18. where the priming kernel's time goes (tools/breakdown.py,
     `prime_phases`) on the primed 1080p frame of c3: its time, its
     profiling instantiation's t0 equal to the plain version's and its SDF
     evaluations to the plain version's count, per phase the share of the
     warps' cycles, steps per ray and SIMT efficiency, the SM clock
     (clock64 against %globaltimer), the cycles per warp (median, p99,
     max) and the slowest warp in ms beside the kernel's time; ptxas' line,
     resident blocks per SM and waves;
 19. the capped-march residual (settings.march_cap, shadow_march_cap): every
     capped and residual K1 and K2 call of a 256x256 c3 frame (caps 32/16
     and 2/2) and of a crowd scene (hard and soft shadows, the crowd
     instantiations) against its plain version, bitwise, unres included;
     c3 at 1920x1080 through render() under every cap variant of surfjax's
     tools/cap_sweep.py (breakdown.CAP_VARIANTS), bitwise equal to the
     uncapped split path (render_rays_pallas with caps 0), with the launch
     counts (K1 and K2 twice where capped, the fused kernel never); the
     capped and residual launches of mc=32 sc=16 timed back to back; three
     1080p pose-fit steps on c5 with mc=32 sc=16: losses, pose and Adam
     moments bitwise equal to the uncapped steps';
 20. the card against the C++ golden (surfjax_torch/golden/): frame 0 of
     c1, c2, c3 (modes `value` and `value_exact`), c4 (modes `config` and
     `ao`) and c5 at the config's own camera and size, rendered
     on the card with backend="pallas" (the fused kernel on c1, c2, c3 and
     c5; K1, K2 and the mesh kernel on c4, and ao_fix in `ao` mode: each
     launch counted) and by the C++ golden on the host's threads; per case
     the shares of equal hit and obj_id, for rgb, depth and normal over the
     pixels both hit the largest and q99 ULP distance and the share within
     1 ULP, the largest rgb difference and the golden's seconds; each case
     held to the bounds surfjax holds its own path to against the golden
     (golden/compare.py BOUNDS), or where surfjax's own fused path breaks
     one on that frame (c3, c5), to surfjax's figure (REFERENCE_FIGURES);
 21. the sharding layer (surfjax_torch/parallel): (a) a world of one rank
     in this process over NCCL: c3 (`value`) and c4 (`ao`) frame 0 at
     1920x1080 through render_frame_sharded, every kernel call of each
     held against its plain version, each frame bitwise equal to
     render_rays_pallas on the same rays; render_sequence_sharded of c3 at
     1920x1080 x 48 frames (the shard's frames in passes of whole frames,
     K1 and K2 launched once per pass), frames 0, 24 and 47 bitwise equal
     to the unsharded split path, ms/frame beside the unsharded split
     path's and KF's render_sequence; ring_trace on c4's 8192 triangles
     with frame 0's primary rays, bitwise equal to one pass over the whole
     table and beside the grid DDA (hits and ids equal, t within 2e-7 relative); the
     dry run's step; (b) spawned gloo worlds of 2 and 4 ranks, every rank
     on this card: the same frames bitwise equal to (a), the c3 sequence
     of 4 frames on meshes (2, 1), (1, 2) and (2, 2) bitwise equal to (a),
     the ring at D = 2 and 4 bitwise equal to D = 1, the dry run at world
     4 within 1e-6 relative of world 1; each rank checks that it imported
     no jax and that the split kernels launched on its sharded path; (c)
     the dry run's defaults: dryrun_multichip(2) with no device (its gloo
     ranks on the card) within 1e-6 relative of world 1, and `python -m
     surfjax_torch.parallel.dryrun 2` in a process of its own, its printed
     loss within the same bound of world 1's, plus the half unit of the
     sixth decimal it rounds to.
 22. the benchmark harness and its entry points (surfjax_torch/bench.py,
     tools/bench_all.py, quickstart.py): (a) run_bench() in this process,
     c3 at 1920x1080 x 48 frames in both modes, 3 repeats: KF launched
     once per render_sequence call and nothing else, the hits per frame of
     both modes equal to phase 3's, rays_per_frame equal to phase 3's
     frames'; (b) `python -m surfjax_torch bench --repeats 1` in a process
     of its own: one JSON line, the same rays_per_frame; (c) bench_all's
     `matrix` and `gated` rows in this process, each row's launches: KF
     alone on c1, c2, c3 and c5_seq, the crowd instantiation on crowd64,
     K1, K2 and the mesh kernel and no KF on the c4 rows; in (a) and (c)
     the first and last frame of every timed call held bitwise against the
     plain versions on the same inputs (frame_fused_reference on a
     mesh-free scene; on a mesh, each kernel call of the two frames
     rendered again against its plain version, and those frames against
     the call's), and the hits the row counted equal to those frames'; (d)
     the quickstart on the card in a process of its own, into a temporary
     directory.
 23. the split path's crowd main path (workload.crowd_mesh_main_path:
     surfjax_torch/configs/crowd_mesh.yaml, crowd_demo's 49 objects and
     c4's octasphere, at 1920x1080 x 16 frames in one render_sequence call
     per mode, `config` and `soft`, one pass): the first call's launches
     per pass (K1, K2 and ao_fix only in their crowd instantiations, the
     mesh kernel beside them, the staged kernels and KF never) and its
     peak memory, three calls timed with CUDA events, every frame of
     every call bitwise equal to render() of that frame, outputs checked
     (the mesh and at least 10 crowd members on frame 0); every kernel
     call of one more 16-frame call, launched again at the pass's shape,
     its rows of frames 0 and 15 against the plain version run on those
     two frames alone (frame_cut), K1, K2 and ao_fix also against the
     plain version visiting only the members each warp votes
     (render_tile.split_warp_masks; a mesh kernel call whose arguments
     equal an earlier one's, as the `soft` mode's equal the `config`
     mode's, held against that call's plain result); the per-frame table
     (frames 0 and 15 each cut and launched alone, halved): each call
     launched back to back, K1 with AO off, K2 on empty segments, ao_fix
     with need 0, the plain version's time, the culled and unculled
     operations and bounds, the masked members per warp, and the whole
     pass launched back to back over its frames (pass_ms); then a ray
     batch that shoots each point both ways
     (its warps' directions sum to 0) through K1 and, as shadow segments,
     through K2 in both modes, each call held the same way.
 24. scenes past the kernels' former fixed bounds (64 objects outside the
     crowd, 32 tape nodes, 16 analytic leaves), which take the kernels'
     KF_WIDE build (the *_wide.cu units; the default build's SASS is the
     parent's): (a) the per-object half of compile_scaling and its crowd
     (surfjax_torch/tools/compile_scaling.py, tools/compile_scaling.py's
     spheres and two-leaf smooth pairs over a floor) at 65 and 129
     objects, 1920x1080 x 2 frames per render_sequence call: the first
     call's seconds and the steady ms/frame, KF launched once per call
     (the per-object rows in its KF_WIDE build), finite frames, the
     crowd's geometry bitwise the per-object one and its rgb within 2 ULP;
     KF's KF_WIDE build alone on the 129 spheres: its frames those of the
     row's last call, frame 0 bitwise equal to the plain version at
     1080p, its time without AO and with it, and KF with a crowd in its
     KF_WIDE build on crowd 120+8+70 at 1080p, AO off and on; (b) every
     KF_WIDE kernel against its plain version, bitwise, on
     workload.limit_cases at 128x72 (65 and 129 objects, 128 crowd
     members beside 71 objects, with and without a mesh, smooth unions of
     17 and 65 spheres left- and right-deep, analytic unions of 17 and 40
     leaves): KF on each mesh-free case (staged, or with the crowd), every
     K1 and K2 call of the split path's forward over the camera's rays,
     the 70 spheres beside a mesh through render() with the crowd off and
     on (K1, K2, ao_fix and the mesh kernel; with the crowd on, the
     default build), the crowd beside 71 objects and a mesh through
     render() (K1, K2 and ao_fix with a crowd in their KF_WIDE build), the
     priming kernel on two primed frames; (c) the 65-object scene primed
     at 1920x1080 through render(): its priming call and its KF launch
     with the primed starts bitwise equal to the plain versions, the
     frame KF's.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches on the main paths, largest errors, times
per 1080p frame (value_exact mode for the fused kernel, `ao` mode for the
split kernels, frame 0 of phase 7's pass launched alone, with pass_ms
the pass's launch over its 16 frames, crowd_demo `config` for the
fused kernel's crowd
instantiation; the probe's entries per launch at its defaults, unroll 4)
and bounds; K1 and K2 also with their time and bound in a 1080p fit step
(fit_ms, fit_bound_ms, fit_bound_by) and their capped and residual
launches on c3 at 1080p under mc=32 sc=16 (capped_ms, redo_ms, redo_rows:
the share of rows re-run); their launches and errors include phase 19's;
the split kernels' also phase 21's (the sharded paths' launches); KF's,
its crowd instantiation's and the split kernels' also phase 22's (the
harness and the workload matrix in this process, launches and the errors
of their frames against the plain versions). The split kernels' crowd
instantiations (render_tile_crowd, trace_rays_crowd, ao_fix_crowd) have
entries of their own: per frame of phase 23's `config` pass (frames 0
and 15 each launched alone, halved; pass_ms the pass's), launches of
its main path, errors over phases 8, 19 and 23, the bound of the culled
algorithm; their launches elsewhere leave the staged kernels' counts. KF's
and its crowd instantiation's launches also count phase 24's
compile_scaling path, and every kernel's error phase 24's checks; KF's
entry gives its KF_WIDE build's launches there (wide_launches) and its
time per 1080p frame alone on 129 objects (wide_ms; with AO wide_ao_ms),
its crowd instantiation's the KF_WIDE build's time on crowd 120+8+70 at
1080p (wide_ms, AO off; wide_ao_ms, AO on).
"""

from __future__ import annotations

import contextlib
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
# sm_90a; the crowd instantiation of KF as the parent of the staged fused
# kernel (d7d452f) built it, the staged fused kernel as c31b803, the parent
# of the staged K1 and K2 (split_staged.cu), built it, the staged K1 and K2
# as 40326d7, the parent of the staged ao_fix and priming kernels, built
# them; K1 and K2 without unres (their second template argument, CUT,
# false: the launches without a march cap) as 861907e, the parent of the
# caps, built them, and with unres (CUT) as the caps' first build did; K1
# and K2 with a crowd (split_path.cu, template argument CUT) as their
# culled build did; ao_fix with a crowd as its redesign
# (ao_fix_crowd.cu, a unit of its own, __launch_bounds__(128, 5)) built it,
# in place of split_path.cu's sp_ao_fix_kernel<true>, which it replaces
# (116 registers and 560 bytes of stack in its last build)
PTXAS_KEPT = {
    "_Z15kf_frame_kernelILb1EEv8KFTables10KFSettings": (
        "768 bytes stack frame, 176 bytes spill stores, 292 bytes spill loads",
        "Used 96 registers, used 0 barriers, 768 bytes cumulative stack size"),
    "_Z21sp_render_tile_kernelILb0EEv8KFTables10KFSettings9SplitRays": (
        "480 bytes stack frame, 120 bytes spill stores, 124 bytes spill loads",
        "Used 64 registers, used 0 barriers, 480 bytes cumulative stack size"),
    "_Z21sp_render_tile_kernelILb1EEv8KFTables10KFSettings9SplitRays": (
        "496 bytes stack frame, 130 bytes spill stores, 140 bytes spill loads",
        "Used 64 registers, used 0 barriers, 496 bytes cumulative stack size"),
    "_Z20sp_trace_rays_kernelILb0EEv8KFTables10KFSettings9SplitRays": (
        "224 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "Used 80 registers, used 0 barriers, 224 bytes cumulative stack size"),
    "_Z20sp_trace_rays_kernelILb1EEv8KFTables10KFSettings9SplitRays": (
        "240 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "Used 80 registers, used 0 barriers, 240 bytes cumulative stack size"),
    "_Z22sp_crowd_ao_fix_kernelILb0EEv8KFTables10KFSettings9SplitRaysPy": (
        "320 bytes stack frame, 36 bytes spill stores, 16 bytes spill loads",
        "Used 96 registers, used 0 barriers, 320 bytes cumulative stack "
        "size"),
    "_Z16kf_staged_kernelILb0EEv8KFTables10KFSettings8KSLayoutPyPi": (
        "528 bytes stack frame, 280 bytes spill stores, 532 bytes spill loads",
        "Used 64 registers, used 1 barriers, 528 bytes cumulative stack size"),
    "_Z28sp_staged_render_tile_kernelILb0ELb0EEv8KFTables10KFSettings9Split"
    "RaysPy": (
        "144 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "Used 72 registers, used 0 barriers, 144 bytes cumulative stack size"),
    "_Z28sp_staged_render_tile_kernelILb0ELb1EEv8KFTables10KFSettings9Split"
    "RaysPy": (
        "160 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "Used 72 registers, used 0 barriers, 160 bytes cumulative stack size"),
    "_Z27sp_staged_trace_rays_kernelILb0ELb0EEv8KFTables10KFSettings8KSLayout"
    "9SplitRaysPyPi": (
        "176 bytes stack frame, 52 bytes spill stores, 52 bytes spill loads",
        "Used 64 registers, used 1 barriers, 176 bytes cumulative stack size, "
        "112 bytes smem"),
    "_Z27sp_staged_trace_rays_kernelILb0ELb1EEv8KFTables10KFSettings8KSLayout"
    "9SplitRaysPyPi": (
        "176 bytes stack frame, 64 bytes spill stores, 64 bytes spill loads",
        "Used 64 registers, used 1 barriers, 176 bytes cumulative stack size, "
        "112 bytes smem"),
}
# phase 20: (config, bound class of golden/compare.py), each at the
# config's own camera and size
GOLDEN_CASES = (("c1_sphere", "strict"), ("c2_csg", "strict"),
                ("c3_sdf", "sdf"), ("c4_mesh", "mesh"),
                ("c5_anim", "strict"))
PRIME_HIT_MAX = 1e-4   # share of pixels whose hit flag priming may change
PROBE_K = 16           # substeps of the probe's comparison with plain
PROBE_UNROLL = 4       # the sweep row whose launch time the kernels line gives
# the hybrid's pose gradient against the eager pipeline's (the marches stop
# at different points inside the hit band): the bounds surfjax holds its
# own two backends to
FIT_LOSS_REL, FIT_GRAD_REL, FIT_GRAD_COS = 2e-3, 0.1, 0.995
FIT_CPU_REL = 1e-3     # the card's hybrid gradient against the CPU's
# the split path's kernels (K1, K2, ao_fix, the mesh kernel)
SPLIT = ("render_tile", "trace_rays", "ao_fix", "mesh_tile",
         "mesh_candidates")
# their crowd instantiations (csrc/split_path.cu), counted apart
CROWD_SPLIT = ("render_tile_crowd", "trace_rays_crowd", "ao_fix_crowd")
SHARD_FRAMES = 4       # the sequence of the gloo worlds (phase 21)
PRIME_FRAMES = 16      # the primed main path's frames (phase 10)
# phase 21's gloo worlds on the card: world size -> the meshes its c3
# sequence is rendered on
SHARD_WORLDS = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
# phase 24: compile_scaling's counts, its frames per call, and the size
# at which the kernels are held against their plain versions on
# workload.limit_cases
LIMIT_COUNTS = (64, 128)
LIMIT_FRAMES = 2
LIMITS_SIZE = (128, 72)
RING_T_REL = 2e-7      # the ring's t against the grid DDA on hit lanes
DRYRUN_REL = 1e-6      # the dry run's step at world 4 against world 1


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
    tables and every ray; the candidate kernel the triangle table and each
    ray's origin, direction and segment end."""
    if kname == "mesh_tile":
        return nbytes(args[:6])   # table, candidates, counts, rays
    if kname == "mesh_candidates":
        lanes = args[2][0].numel()
        return nbytes(args[1:4]) + 4 * lanes   # table, o, d, t_max
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


def frames_alone(scene, camera, positions, st, dev) -> list:
    """Each frame of a camera path rendered alone by render() -> its
    FrameBuffers, frame after frame."""
    from surfjax_torch.api import render
    return [render(scene, dataclasses.replace(
        camera, position=tuple(float(x) for x in p)), st, device=dev)
        for p in positions]


def same_frames(fb, alone, label: str) -> None:
    """Each frame of a sequence's buffers bitwise equal to that frame
    rendered alone (frames_alone, in the same order); raises on the first
    buffer that differs."""
    import torch

    from surfjax_torch.core.types import FrameBuffers
    if fb.rgb.shape[0] != len(alone):
        raise AssertionError(f"{label}: {fb.rgb.shape[0]} frames, "
                             f"{len(alone)} rendered alone")
    for f, single in enumerate(alone):
        for field in FrameBuffers._fields:
            if not torch.equal(getattr(fb, field)[f], getattr(single, field)):
                raise AssertionError(f"{label}: frame {f} differs from "
                                     f"render() of that frame in {field}")


def pass_launches(scene, camera, st, n_frames: int) -> dict:
    """The launches of a batched sequence of n_frames on the split path
    -> per kernel of _split_wrappers and frame_fused: per pass
    (render_tile.frames_per_pass) K1 once, the mesh kernel once per mesh
    for the primary rays and once per mesh and light, ao_fix once where
    AO meets a mesh and another object, K2 once per light (K1, K2 and
    ao_fix under their crowd instantiation's key on a crowd scene), KF
    never."""
    from surfjax_torch.kernels import render_tile as rt
    static = scene.freeze()[0]
    passes = -(-n_frames // rt.frames_per_pass(rt.pass_rays(
        static, camera.intrinsics, st)))
    meshes = len(rt._split(static)[2])
    lights = len(static.ir.lights) * bool(st.shadows)
    crowd = "_crowd" if rt.launches_crowd(static, st) else ""
    want = dict.fromkeys(list(_split_wrappers()) + ["frame_fused",
                                                    "frame_fused_crowd"], 0)
    want["render_tile" + crowd] = passes
    want["trace_rays" + crowd] = passes * lights
    want["mesh_tile"] = passes * meshes * (1 + lights)
    want["mesh_candidates"] = want["mesh_tile"]
    want["ao_fix" + crowd] = passes * bool(
        st.ao and meshes and len(static.ir.objects) > meshes)
    return want


def frame_rows(t, rows: int, frames):
    """The rows of a batched pass's array that belong to the given frames,
    each frame taking `rows` rows (of tiled rays, or of the mesh kernel's
    tiles), joined in the order given."""
    import torch
    return torch.cat([t[f * rows:(f + 1) * rows] for f in frames])


def out_rows(kname: str, args, rows: int) -> int:
    """The rows of a kernel call's outputs that one frame of `rows` ray
    rows takes: the candidate kernel's are tiles, the others' rays."""
    return rows // args[6] if kname == "mesh_candidates" else rows


def frame_cut(kname: str, args, rows: int, frames):
    """A recorded kernel call of a batched pass whose frames each take
    `rows` rows of its (rows, 128) ray arrays (prime_tile: of its coarse
    grid) -> the call's arguments cut to the given frames: every ray array
    (and a residual re-run's outputs and row flags) by rows, the mesh
    kernel's candidate table and counts by tiles; scene, settings,
    triangles and scalars as they are. The kernels take each tile, warp
    and ray on its own, so the cut is the call those frames make alone;
    raises where an array's rows are not whole frames."""
    import torch

    def cut(a, n):
        if isinstance(a, torch.Tensor):
            if a.dim() == 0 or a.shape[0] % n:
                raise AssertionError(f"{kname}: an argument of shape "
                                     f"{tuple(a.shape)} is not in frames "
                                     f"of {n} rows")
            return frame_rows(a, n, frames)
        if isinstance(a, tuple):
            return tuple(cut(x, n) for x in a)
        return a

    if kname == "mesh_tile":
        tri, cand, counts = args[:3]
        tiles = rows // (args[3][0].shape[0] // cand.shape[0])
        return (tri, cut(cand, tiles), cut(counts, tiles)) \
            + tuple(cut(a, rows) for a in args[3:6]) + tuple(args[6:])
    if kname == "prime_tile":
        return tuple(args[:3]) + tuple(cut(a, rows) for a in args[3:])
    return tuple(args[:2]) + tuple(cut(a, rows) for a in args[2:])


def peak_bytes(call, dev):
    """call() with the card's peak memory tracked -> (its result, the most
    bytes allocated above what was allocated before it, each pass
    included)."""
    import torch
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = call()
    torch.cuda.synchronize(dev)
    return out, torch.cuda.max_memory_allocated(dev) - base


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


def capped_residual(dev, smi: str) -> dict:
    """Phase 19, the capped-march residual (module docstring) -> {"launches":
    K1's and K2's launches on its main path, "err": the largest error of
    its kernel comparisons per kernel, "ms": per kernel the capped and
    residual launches' ms at c3 1080p under mc=32 sc=16 and the share of
    rows re-run}."""
    import numpy as np
    import torch
    import surfjax_torch.api as api
    from surfjax_torch.api import render
    from surfjax_torch.config import load_config
    from surfjax_torch.core.camera import flat_camera_rays
    from surfjax_torch.core.scene_compile import params_to_device
    from surfjax_torch.core.types import FrameBuffers
    from surfjax_torch.kernels.mesh_tile import mesh_tile
    from surfjax_torch.kernels.render_tile import (
        ao_fix, frame_fused, render_rays_pallas, render_tile, trace_rays,
    )
    from surfjax_torch.tools.breakdown import CAP_VARIANTS
    from surfjax_torch.tools.fit_bench import pose_step_fn
    from surfjax_torch.tools.kernel_check import (
        KERNELS, capture_calls, compare, fresh,
    )
    from surfjax_torch.tools.workload import crowd_scene, cuda_ms, reframe
    t19 = time.perf_counter()
    errs = {"render_tile": 0.0, "trace_rays": 0.0}
    c3_scene, c3_cam, c3_st, _ = load_config(os.path.join(
        ROOT, "configs/c3_sdf.yaml"))
    c3_st = c3_st.with_(backend="pallas")
    # every capped and residual K1 and K2 call against its plain version
    cases = [(f"c3 256x256 mc={mc} sc={sc}", c3_scene,
              reframe(c3_cam, 256, 256),
              c3_st.with_(march_cap=mc, shadow_march_cap=sc))
             for mc, sc in ((32, 16), (2, 2))]
    for mode in ("hard", "soft"):
        sc_, cam_, st_ = crowd_scene(api, n_sdf_spheres=3, size=(256, 192),
                                     shadows=True,
                                     soft_shadows=mode == "soft")
        cases.append((f"crowd {mode} 256x192", sc_, cam_, st_.with_(
            vector_objects=True, march_cap=2, shadow_march_cap=2)))
    for name, scene, cam, st in cases:
        with capture_calls() as calls:
            render(scene, cam, st, device=dev)
        names = [c[0] for c in calls]
        if "render_tile_redo" not in names or "trace_rays_redo" not in names:
            raise AssertionError(f"{name}: no residual re-run in {names}")
        shares = {}
        for k, (kname, args) in enumerate(calls):
            err, _, _ = compare(kname, args, f"{name} call {k}")
            key = kernel_key(kname, args)
            errs[key] = max(errs.get(key, 0.0), err)
            if kname.endswith("_redo"):
                shares[kname] = round(float(args[3].mean()), 4)
        log(f"  {name}: {len(calls)} capped and residual K1/K2 calls bitwise "
            f"equal to the plain versions, unres included; rows re-run "
            f"{json.dumps(shares)}")
    # the full-size path: c3 at 1080p under every cap variant of the sweep
    # against the uncapped split path
    cam = reframe(c3_cam, 1920, 1080)
    H, W = cam.intrinsics.height, cam.intrinsics.width
    static, params = c3_scene.freeze()
    params_d = params_to_device(params, dev)
    R = torch.as_tensor(np.asarray(cam.rotation, np.float32).reshape(9),
                        device=dev)
    pos = torch.as_tensor(np.asarray(cam.position, np.float32), device=dev)
    o, d, _ = flat_camera_rays(cam.intrinsics, R, pos)
    with torch.no_grad():
        ref = render_rays_pallas(static, c3_st, params_d, o, d)
    ref = FrameBuffers(*(a.reshape((H, W) + tuple(a.shape[1:]))
                         for a in ref))
    if not all(bool(torch.isfinite(a.float()).all()) for a in ref) or \
            not 0.3 < float(ref.hit.mean()) < 1.0:
        raise AssertionError("c3 1080p: the uncapped split path's frame is "
                             "not finite or its hit fraction is off")
    wrappers = (render_tile, trace_rays, ao_fix, mesh_tile, frame_fused)
    for w in wrappers:
        w.launches = 0
    n_lights = len(c3_scene.lights)
    want = [0, 0, 0, 0, 0]
    for name, mc, sc in CAP_VARIANTS:
        fb = render(c3_scene, cam, c3_st.with_(march_cap=mc,
                                                shadow_march_cap=sc),
                    device=dev)
        bitwise(fb, ref, FrameBuffers._fields, f"c3 1080p {name}")
        want[0] += 2 if mc else 1
        want[1] += (2 if sc else 1) * n_lights
    got = [w.launches for w in wrappers]
    if got != want:
        raise AssertionError(f"c3 1080p caps: launches (K1, K2, ao_fix, "
                             f"mesh, fused) {got}, expected {want}")
    launches = {"render_tile": got[0], "trace_rays": got[1]}
    log(f"  c3 1080p: render() under {len(CAP_VARIANTS)} cap variants "
        f"bitwise equal to the uncapped split path; launches {launches}")
    # the capped and residual launches of one variant, back to back
    with capture_calls() as calls:
        render(c3_scene, cam, c3_st.with_(march_cap=32, shadow_march_cap=16),
               device=dev)
    timing = {}
    for kname, args in calls:
        launch, _ = KERNELS[kname][3](*fresh(kname, args))
        launch()
        k_ms, _ = cuda_ms(lambda: [launch() for _ in range(LAUNCH_REPS)], 3)
        base = kname.replace("_redo", "")
        key = "redo_ms" if kname.endswith("_redo") else "capped_ms"
        timing.setdefault(base, {})[key] = min(k_ms) / LAUNCH_REPS
        if kname.endswith("_redo"):
            timing[base]["redo_rows"] = float(args[3].mean())
    log(f"  c3 1080p mc=32 sc=16, launched back to back: "
        + json.dumps(timing))
    # a few capped 1080p pose-fit steps against uncapped ones
    runs = []
    for mc, sc in ((0, 0), (32, 16)):
        step, x, state, _ = pose_step_fn("pallas", 60, (1920, 1080), dev,
                                         march_cap=mc, shadow_march_cap=sc)
        render_tile.launches = trace_rays.launches = 0
        losses = []
        for _ in range(3):
            x, state, loss = step(x, state)
            losses.append(loss.detach())
        runs.append(([*losses, x["w"], x["dt"], state["mu"]["w"],
                      state["mu"]["dt"], state["nu"]["w"], state["nu"]["dt"]],
                     (render_tile.launches, trace_rays.launches)))
    for k, (a, b) in enumerate(zip(runs[0][0], runs[1][0])):
        if not torch.equal(a, b):
            raise AssertionError(f"capped 1080p fit steps differ from the "
                                 f"uncapped ones in value {k}")
    if runs[0][1][0] != 3 or runs[1][1] != (6, 2 * runs[0][1][1]):
        raise AssertionError(f"capped fit steps: launches K1, K2 "
                             f"{runs[1][1]}")
    launches["render_tile"] += runs[1][1][0]
    launches["trace_rays"] += runs[1][1][1]
    log(f"  c5 pose fit at 1920x1080, 3 steps with mc=32 sc=16: losses, "
        f"pose and Adam moments bitwise equal to the uncapped steps "
        f"(losses {[float(v) for v in runs[1][0][:3]]})")
    log(f"phase 19: the capped-march residual ({time.perf_counter() - t19:.1f}"
        f" s) on {smi}")
    return {"launches": launches, "err": errs, "ms": timing}


def golden_phase(dev, smi: str) -> list:
    """Phase 20, the card's frames against the C++ golden (module
    docstring) -> one dict per case: config, mode, size, launches, the
    golden's seconds and golden_gap's figures."""
    from surfjax_torch.api import render
    from surfjax_torch.config import load_config
    from surfjax_torch.golden import cpp_bridge
    from surfjax_torch.golden.compare import broken_bounds, golden_gap
    from surfjax_torch.kernels.mesh_tile import mesh_tile
    from surfjax_torch.kernels.render_tile import (
        ao_fix, frame_fused, render_tile, trace_rays,
    )
    from surfjax_torch.tools.workload import EXACT, mesh_modes
    t20 = time.perf_counter()
    cpp_bridge.build()
    log(f"  C++ golden ready in {time.perf_counter() - t20:.1f} s "
        f"({os.path.relpath(cpp_bridge.library_path(), ROOT)})")
    wrappers = {"frame_fused": frame_fused, "render_tile": render_tile,
                "trace_rays": trace_rays, "ao_fix": ao_fix,
                "mesh_tile": mesh_tile}
    rows, broken = [], []
    for name, kind in GOLDEN_CASES:
        scene, cam, st, _ = load_config(os.path.join(ROOT, "configs",
                                                     name + ".yaml"))
        if kind == "mesh":
            modes = mesh_modes(st)
        elif kind == "sdf":
            modes = {"value": st.with_(backend="pallas"),
                     "value_exact": st.with_(backend="pallas", **EXACT)}
        else:
            modes = {"config": st.with_(backend="pallas")}
        golds = {}
        for mode, mst in modes.items():
            # the golden has no LoD and no over-relaxation (EXACT's
            # fields): c3's two modes share one golden frame
            gkey = (mst.ao, mst.soft_shadows)
            if gkey not in golds:
                tg = time.perf_counter()
                golds[gkey] = (cpp_bridge.render(scene, cam, mst),
                               time.perf_counter() - tg)
            gold, golden_s = golds[gkey]
            for w in wrappers.values():
                w.launches = 0
            fb = render(scene, cam, mst, device=dev)
            launches = {k: w.launches for k, w in wrappers.items()}
            if kind == "mesh":
                want = {"render_tile", "trace_rays", "mesh_tile"} | (
                    {"ao_fix"} if mst.ao else set())
            else:
                want = {"frame_fused"}
            if {k for k, v in launches.items() if v} != want:
                raise AssertionError(f"{name} {mode}: launches {launches}, "
                                     f"expected {sorted(want)} only")
            gap = golden_gap(fb, gold)
            intr = cam.intrinsics
            row = {"config": name, "mode": mode,
                   "size": f"{intr.width}x{intr.height}",
                   "launches": {k: v for k, v in launches.items() if v},
                   "golden_s": golden_s, **gap}
            rows.append(row)
            log(f"  {name} {mode}: " + json.dumps(row))
            broken += [f"{name} {mode}: {b}"
                       for b in broken_bounds(gap, kind, name, mode)]
    if broken:
        raise AssertionError("phase 20: the card breaks the golden bounds: "
                             + "; ".join(broken))
    log(f"phase 20: the card against the C++ golden on c1-c5 "
        f"({time.perf_counter() - t20:.1f} s) on {smi}")
    return rows


def _split_wrappers() -> dict:
    """-> kernel -> its launch counter (`.launches`): the split wrappers
    for the staged kernels, the mesh kernel and the candidate kernel, their
    `.crowd` for the crowd instantiations."""
    from surfjax_torch.kernels import mesh_tile as mt, render_tile as rt
    return {"render_tile": rt.render_tile, "trace_rays": rt.trace_rays,
            "ao_fix": rt.ao_fix, "mesh_tile": mt.mesh_tile,
            "mesh_candidates": mt.mesh_candidates,
            "render_tile_crowd": rt.render_tile.crowd,
            "trace_rays_crowd": rt.trace_rays.crowd,
            "ao_fix_crowd": rt.ao_fix.crowd}


def kernel_key(kname: str, args) -> str:
    """A recorded split-kernel call -> the kernel it launches: its wrapper's
    name without `_redo`, `_crowd` added where the scene forms a crowd
    (csrc/split_path.cu's instantiations, csrc/ao_fix_crowd.cu)."""
    from surfjax_torch.kernels.render_tile import launches_crowd
    base = kname.replace("_redo", "")
    if base in ("render_tile", "trace_rays", "ao_fix") and \
            launches_crowd(args[0].static, args[1]):
        return base + "_crowd"
    return base


def _counted(fn, totals: dict):
    """fn() with the split kernels' counts set to 0 just before it and
    read just after, added to totals -> (fn's result, its counts)."""
    wrappers = _split_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    got = {k: w.launches for k, w in wrappers.items()}
    for k, v in got.items():
        totals[k] = totals.get(k, 0) + v
    return out, got


def _wall_ms(fn, reps: int, dev):
    """-> (per-call ms on the host clock, each call ended by a sync of the
    card, last result)."""
    import torch
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    times, out = [], None
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, out


def _digests(fb) -> list:
    """sha256 of each buffer's bytes: equal digests, equal bits."""
    import hashlib
    return [hashlib.sha256(a.contiguous().cpu().numpy().tobytes()).hexdigest()
            for a in fb]


def _shard_cases(n_frames: int, size=None):
    """-> {"c3": (scene, camera at frame 0, settings `value`, poses),
    "c4": (scene, camera at frame 0, settings `ao`, poses)}, at 1920x1080
    or at size (w, h)."""
    from surfjax_torch.tools.workload import (
        main_path, mesh_main_path, reframe,
    )
    c3 = main_path(os.path.join(ROOT, "configs/c3_sdf.yaml"), n_frames)
    c4 = mesh_main_path(os.path.join(ROOT, "configs/c4_mesh.yaml"),
                        n_frames)
    out = {}
    for key, (scene, cam, Rs, ps, modes), mode in (("c3", c3, "value"),
                                                   ("c4", c4, "ao")):
        if size is not None:
            cam = reframe(cam, *size)
        cam0 = dataclasses.replace(cam,
                                   position=tuple(float(x) for x in ps[0]))
        out[key] = (scene, cam0, modes[mode], (Rs, ps))
    return out


def _ring_inputs(dev, scene, cam):
    """c4's mesh as shard_triangles takes it, and frame 0's primary rays
    on dev -> (MeshTables, o, d)."""
    from surfjax_torch.core.camera import flat_camera_rays
    from surfjax_torch.engines.mesh import MeshTables
    from surfjax_torch.pipeline.frame import _pose_tensors
    static, params = scene.freeze()
    tables = MeshTables(static.mesh_static[0],
                        {k[len("mesh0_"):]: v for k, v in params.items()
                         if k.startswith("mesh0_")})
    R, t = _pose_tensors(cam, dev)
    o, d, _ = flat_camera_rays(cam.intrinsics, R, t)
    return tables, tuple(c.contiguous() for c in o), d


def _sharding_rank(world: int, device_type: str, size) -> dict:
    """One rank of a phase-21 gloo world, every rank on the card: c3 and c4
    frame 0 on the default mesh, the c3 sequence on each mesh of
    SHARD_WORLDS[world], the ring over the world, at world 4 the dry run
    -> digests, times, the split kernels' counts on the sharded path."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from surfjax_torch.kernels import _build
    from surfjax_torch.parallel import (
        make_mesh, render_frame_sharded, render_sequence_sharded,
    )
    from surfjax_torch.parallel.dryrun import dryrun_step
    from surfjax_torch.parallel.mesh import (
        params_to_device, rank_device, render_frame_shard,
    )
    from surfjax_torch.parallel.ring_mesh import ring_trace, shard_triangles
    from surfjax_torch.pipeline.frame import _pose_tensors
    dev = rank_device(device_type)
    if dev.type == "cuda":
        _build.load()
        torch.cuda.set_device(dev)
    counts, out = {}, {"frames": {}, "sequences": {}, "ms": {}}
    cases = _shard_cases(SHARD_FRAMES, size)
    mesh = make_mesh(device=device_type)
    coord = mesh.get_coordinate()
    for key, (scene, cam, st, _) in cases.items():
        (ms, fb), _ = _counted(lambda: _wall_ms(lambda: render_frame_sharded(
            scene, cam, st, mesh, device_type), 1, dev), counts)
        out["frames"][key] = _digests(fb)
        out["ms"][f"{key} frame"] = ms[0]
        static, params = scene.freeze()
        params = params_to_device(params, dev)
        R, t = _pose_tensors(cam, dev)
        ms, _ = _wall_ms(lambda: render_frame_shard(
            static, st, params, cam.intrinsics, R, t, coord[1], world), 1,
            dev)
        out["ms"][f"{key} shard alone"] = ms[0]
    scene, cam, st, poses_ = cases["c3"]
    for shape in SHARD_WORLDS[world]:
        smesh = make_mesh(*shape, device=device_type)
        (ms, fb), _ = _counted(lambda: _wall_ms(
            lambda: render_sequence_sharded(scene, cam, poses_, st, smesh,
                                            device_type), 1, dev), counts)
        out["sequences"][str(shape)] = _digests(fb)
        out["ms"][f"c3 sequence {shape}"] = ms[0]
    c4_scene, c4_cam, c4_st, _ = cases["c4"]
    tables, o, d = _ring_inputs(dev, c4_scene, c4_cam)
    ring = init_device_mesh(device_type, (world,), mesh_dim_names=("shard",))
    ms, (t, tri) = _wall_ms(lambda: ring_trace(
        shard_triangles(tables, world), o, d, c4_st.t_min, c4_st.t_max,
        ring), 1, dev)
    out["ring"] = _digests((t, tri))
    out["ms"]["ring"] = ms[0]
    if world == 4:
        out["dryrun"] = dryrun_step(device_type)
    out["counts"] = counts
    out["jax"] = "jax" in sys.modules
    out["rank"] = dist.get_rank()
    return out


def sharding_phase(dev, smi: str, size=None, n_seq: int = 48) -> dict:
    """Phase 21, the sharding layer on the card (module docstring), at
    1920x1080 or at size (w, h) -> {"launches": the split kernels'
    launches on the sharded paths of worlds 1, 2 and 4, "ms": the times,
    "err": per kernel the largest error of its calls in world 1's sharded
    frames against the plain version}."""
    import re
    import subprocess
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from surfjax_torch.api import render_sequence
    from surfjax_torch.core.camera import flat_camera_rays
    from surfjax_torch.core.math import BIG
    from surfjax_torch.core.types import FrameBuffers
    from surfjax_torch.engines.mesh import intersect_mesh
    from surfjax_torch.kernels import render_tile as rt
    from surfjax_torch.kernels.render_tile import render_rays_pallas
    from surfjax_torch.parallel import (
        initialize_distributed, make_mesh, render_frame_sharded,
        render_sequence_sharded,
    )
    from surfjax_torch.parallel.dryrun import dryrun_multichip, dryrun_step
    from surfjax_torch.parallel.launch import run_world
    from surfjax_torch.parallel.mesh import _crop_reshape, params_to_device
    from surfjax_torch.parallel.ring_mesh import (
        NO_ID, _mt_shard, ring_trace, shard_triangles,
    )
    from surfjax_torch.pipeline.frame import _pose_tensors
    from surfjax_torch.tools.kernel_check import capture_calls, compare
    t21 = time.perf_counter()
    names = FrameBuffers._fields
    totals, ms, errs = {}, {}, {}
    # (a) world 1 in this process: NCCL on the card
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    # NCCL reaches the store at its first collective: it outlives the group
    store = tempfile.TemporaryDirectory()
    initialize_distributed(dev.type, init_method=f"file://{store.name}/store",
                           rank=0, world_size=1)
    try:
        one = torch.ones(1, device=dev)
        dist.all_reduce(one)
        if float(one) != 1.0:
            raise AssertionError(f"{dist.get_backend()}'s all_reduce over "
                                 "one rank")
        mesh = make_mesh(1, 1, device=dev.type)
        cases = _shard_cases(n_seq, size)
        ref_digests = {}

        def unsharded(scene, cam, st):
            static, params = scene.freeze()
            params = params_to_device(params, dev)
            R, t = _pose_tensors(cam, dev)
            o, d, n = flat_camera_rays(cam.intrinsics, R, t)
            intr = cam.intrinsics
            with torch.no_grad():
                return _crop_reshape(render_rays_pallas(static, st, params,
                                                        o, d),
                                     n, intr.height, intr.width)

        for key, (scene, cam, st, _) in cases.items():
            with capture_calls() as calls:
                fb, got = _counted(lambda: render_frame_sharded(
                    scene, cam, st, mesh, dev.type), totals)
            want = {"render_tile", "trace_rays"} | (
                {"mesh_tile", "mesh_candidates", "ao_fix"} if key == "c4"
                else set())
            if {k for k, v in got.items() if v} != want:
                raise AssertionError(f"{key} sharded frame: launches {got}, "
                                     f"expected {sorted(want)} only")
            # every kernel call of the sharded frame against its plain
            # version, at the shapes the sharded path gives it
            for k, (kname, args) in enumerate(calls):
                err, _, _ = compare(kname, args, f"{key} sharded call {k}")
                errs[kname] = max(errs.get(kname, 0.0), err)
            log(f"  {key} sharded frame: {len(calls)} kernel calls bitwise "
                "equal to their plain versions")
            del calls
            bitwise(fb, unsharded(scene, cam, st), names,
                    f"{key} frame 0 sharded (world 1) == render_rays_pallas")
            ref_digests[key] = _digests(fb)
            s_ms, _ = _wall_ms(lambda: render_frame_sharded(
                scene, cam, st, mesh, dev.type), 3, dev)
            u_ms, _ = _wall_ms(lambda: unsharded(scene, cam, st), 3, dev)
            ms[f"{key} frame"] = {"sharded": s_ms,
                                  "unsharded split path": u_ms}
            log(f"  {key} frame 0, world 1: launches {got}, ms "
                + json.dumps(ms[f"{key} frame"]))
            del fb
        # the c3 sequence against the unsharded split path, frame by frame
        scene, cam, st, (Rs, ps) = cases["c3"]
        (seq_ms, fb), got = _counted(lambda: _wall_ms(
            lambda: render_sequence_sharded(scene, cam, (Rs, ps), st, mesh,
                                            dev.type), 1, dev), totals)
        # world 1's shard is every frame whole, padded to whole tiles, in
        # passes of whole frames: K1 once and K2 once per light per pass
        intr = cam.intrinsics
        passes = -(-n_seq // rt.frames_per_pass(rt.batch_rays(
            intr.width * intr.height, st)))
        if got["render_tile"] != passes or \
                got["trace_rays"] != passes * len(scene.lights):
            raise AssertionError(f"c3 sequence: launches {got}, expected "
                                 f"{passes} passes")
        check_sequence("c3 sharded", fb, len(scene.objects), 2e-4, 2.5e-3)
        for f in (0, n_seq // 2, n_seq - 1):
            cam_f = dataclasses.replace(
                cam, position=tuple(float(x) for x in ps[f]))
            bitwise([a[f] for a in fb], unsharded(scene, cam_f, st), names,
                    f"c3 sequence frame {f} sharded == split path")
        ref_digests["c3 sequence"] = _digests([a[:SHARD_FRAMES] for a in fb])
        del fb

        def split_loop():
            for f in range(n_seq):
                unsharded(scene, dataclasses.replace(
                    cam, position=tuple(float(x) for x in ps[f])), st)

        s_ms, _ = _wall_ms(lambda: render_sequence_sharded(
            scene, cam, (Rs, ps), st, mesh, dev.type), 2, dev)
        u_ms, _ = _wall_ms(split_loop, 2, dev)
        k_ms, _ = _wall_ms(lambda: render_sequence(
            scene, cam, (Rs, ps), st, device=dev), 3, dev)
        ms["c3 sequence"] = {
            "frames": n_seq,
            "sharded ms/frame": [t / n_seq for t in seq_ms + s_ms],
            "unsharded split path ms/frame": [t / n_seq for t in u_ms],
            "KF render_sequence ms/frame": [t / n_seq for t in k_ms]}
        log(f"  c3 sequence x {n_seq}, world 1: launches {got}; "
            + json.dumps(ms["c3 sequence"]))
        # the ring over c4's mesh and frame 0's primary rays
        scene, cam, st, _ = cases["c4"]
        tables, o, d = _ring_inputs(dev, scene, cam)
        ring = init_device_mesh(dev.type, (1,), mesh_dim_names=("shard",))
        r_ms, (t1, tri1) = _wall_ms(lambda: ring_trace(
            shard_triangles(tables, 1), o, d, st.t_min, st.t_max, ring), 2,
            dev)
        full = [torch.as_tensor(tables.arrays[k], device=dev)
                for k in ("tri_v0", "tri_e1", "tri_e2")]
        n_tris = full[0].shape[0]
        p_ms, (t_p, tri_p) = _wall_ms(lambda: _mt_shard(
            o, d, *full, torch.arange(n_tris, dtype=torch.int32, device=dev),
            st.t_min, torch.full_like(o[0], st.t_max),
            torch.full_like(o[0], BIG),
            torch.full_like(o[0], NO_ID, dtype=torch.int32)), 1, dev)
        tri_p = torch.where(t_p < BIG * 0.5, tri_p, n_tris)
        bitwise((t1, tri1), (t_p, tri_p), ("t", "tri"),
                "ring D=1 == one pass over the whole table")
        static, params = scene.freeze()
        params = params_to_device(params, dev)
        d_ms, (t_d, tri_d) = _wall_ms(lambda: intersect_mesh(
            static.mesh_static[0], 0, params, o, d, st.t_min, st.t_max), 1,
            dev)
        hit = t1 < BIG * 0.5
        if not torch.equal(hit, t_d < BIG * 0.5):
            raise AssertionError("ring and grid DDA disagree on hits: "
                                 f"{int((hit != (t_d < BIG * 0.5)).sum())}")
        if not torch.equal(tri1[hit], tri_d[hit]):
            raise AssertionError("ring and grid DDA disagree on triangle "
                                 f"ids on {int((tri1 != tri_d)[hit].sum())}"
                                 " hit lanes")
        rel = float(((t1 - t_d).abs() / t_d.abs())[hit].max())
        if rel > RING_T_REL:
            raise AssertionError(f"ring t against the grid DDA: {rel} "
                                 f"relative (bound {RING_T_REL})")
        ref_digests["ring"] = _digests((t1, tri1))
        ms["ring"] = {"rays": int(o[0].shape[0]), "triangles": n_tris,
                      "hit lanes": int(hit.sum()), "ring D=1 ms": r_ms,
                      "one pass ms": p_ms, "grid DDA ms": d_ms,
                      "t rel vs DDA": rel}
        log("  ring on c4's mesh, frame 0's primary rays: "
            + json.dumps(ms["ring"]))
        leaf1, loss1 = dryrun_step(dev.type, n_frames=4)
    finally:
        dist.destroy_process_group()
        store.cleanup()
    # (b) gloo worlds of 2 and 4, every rank on this card, spawned
    for world, shapes in SHARD_WORLDS.items():
        tw = time.perf_counter()
        ranks = run_world(_sharding_rank, world, world, dev.type, size,
                          device=dev.type, backend="gloo", timeout=600.0)
        for res in ranks:
            label = f"world {world} rank {res['rank']}"
            if res["jax"]:
                raise AssertionError(f"{label}: jax was imported")
            if any(res["counts"].get(k, 0) < 1 for k in SPLIT):
                raise AssertionError(f"{label}: launches {res['counts']}")
            for key in ("c3", "c4"):
                if res["frames"][key] != ref_digests[key]:
                    raise AssertionError(f"{label}: {key} frame 0 differs "
                                         "from world 1")
            for shape in shapes:
                if res["sequences"][str(shape)] != ref_digests["c3 sequence"]:
                    raise AssertionError(f"{label}: the c3 sequence on "
                                         f"{shape} differs from world 1")
            if res["ring"] != ref_digests["ring"]:
                raise AssertionError(f"{label}: the ring at D={world} "
                                     "differs from D=1")
            if world == 4:
                leaf4, loss4 = res["dryrun"]
                rel = max(abs(loss4 - loss1) / abs(loss1),
                          float(np.abs(leaf4 - leaf1).max()
                                / np.abs(leaf1).max()))
                if rel > DRYRUN_REL:
                    raise AssertionError(f"{label}: the dry run differs "
                                         f"from world 1 by {rel} relative")
                ms["dryrun world 4 vs 1 rel"] = rel
            for k, v in res["counts"].items():
                totals[k] = totals.get(k, 0) + v
        ms[f"world {world}"] = {f"rank {r['rank']}": r["ms"] for r in ranks}
        secs = time.perf_counter() - tw
        log(f"  gloo world of {world} ({secs:.1f} s): frames, sequences on "
            f"{list(shapes)} and the ring at D={world} bitwise equal to "
            f"world 1; ms " + json.dumps(ms[f"world {world}"]))
    log(f"  the dry run at world 4 against world 1: "
        f"{ms['dryrun world 4 vs 1 rel']:.3g} relative")
    # (c) the dry run's defaults: the ranks go on the card
    tw = time.perf_counter()
    leaf2, loss2 = dryrun_multichip(2)
    rel = max(abs(loss2 - loss1) / abs(loss1),
              float(np.abs(leaf2 - leaf1).max() / np.abs(leaf1).max()))
    if rel > DRYRUN_REL:
        raise AssertionError(f"dryrun_multichip(2) differs from world 1 by "
                             f"{rel} relative")
    ms["dryrun_multichip(2) vs world 1 rel"] = rel
    proc = subprocess.run(
        [sys.executable, "-m", "surfjax_torch.parallel.dryrun", "2"],
        cwd=ROOT, env=_module_env(), capture_output=True, text=True,
        timeout=600)
    printed = re.search(r"loss=(\S+) OK", proc.stdout)
    if proc.returncode != 0 or printed is None:
        raise AssertionError("python -m surfjax_torch.parallel.dryrun 2 "
                             f"failed:\n{proc.stdout}{proc.stderr[-4000:]}")
    # the printed loss is rounded to 6 decimals: half a unit of the last
    # one on top of the bound
    if abs(float(printed.group(1)) - loss1) > 5e-7 + DRYRUN_REL * abs(loss1):
        raise AssertionError(f"the dry run's command line printed loss "
                             f"{printed.group(1)}, world 1 {loss1!r}")
    log(f"  the dry run's defaults on the card: dryrun_multichip(2) "
        f"{rel:.3g} relative of world 1; the command line: "
        f"{proc.stdout.strip()} ({time.perf_counter() - tw:.1f} s)")
    log(f"phase 21: the sharding layer, launches {totals} "
        f"({time.perf_counter() - t21:.1f} s) on {smi}")
    return {"launches": totals, "ms": ms, "err": errs}


def _same_args(a, b) -> bool:
    """Two recorded arguments equal: tensors bitwise and of one dtype and
    shape, sequences item by item, anything else by ==."""
    import torch
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) \
            and a.dtype == b.dtype and a.shape == b.shape \
            and torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return isinstance(b, (tuple, list)) and len(a) == len(b) and \
            all(_same_args(x, y) for x, y in zip(a, b))
    return a == b


def _hold_call(kname: str, args, label: str, errs: dict, stats=None,
               memo=None, part=None):
    """One recorded kernel call: the kernel against its plain version,
    bitwise, and on a crowd scene K1, K2 and ao_fix also against the
    plain version visiting only the members each warp votes
    (split_warp_masks).
    memo: None, or a list of earlier mesh_tile calls with their plain
    results; a mesh_tile call whose arguments equal one of them is held
    against that result rather than running the plain grid DDA again (the
    two modes of the crowd-mesh path give the mesh kernel the same rays).
    part: None, or (rows, frames): args are a call of a batched pass
    whose frames each take `rows` rows of its ray arrays; the kernel runs
    on the whole pass, and its rows of those frames are held against the
    plain versions run on those frames alone (frame_cut).
    -> the kernel's outputs (flat; with part, of those frames). stats:
    None, or the kernel's sums to add this call's numbers
    to: its time launched back to back, K1's with AO off, K2's on empty
    segments, ao_fix's with need 0 (with part, each frame's cut launched
    alone, and the whole pass's time as pass_ms), the plain version's
    time, the operations of the unculled and the culled algorithm
    (count_ops), the bytes it must move and, per loop, the masked members
    per warp."""
    import torch

    from surfjax_torch.kernels.render_tile import count_ops
    from surfjax_torch.tools.breakdown import _empty_segments, _need_zero
    from surfjax_torch.tools.kernel_check import KERNELS, flat, masks_of
    from surfjax_torch.tools.workload import cuda_ms
    wrapper, reference, names, launcher = KERNELS[kname]
    key = kernel_key(kname, args)
    got = flat(wrapper(*args))
    held, timed = args, [args]
    if part is not None:
        rows, frames = part
        got = [frame_rows(g, out_rows(kname, args, rows), frames)
               for g in got]
        held = frame_cut(kname, args, rows, frames)
        timed = [frame_cut(kname, args, rows, [f]) for f in frames]
    # operations are counted for the table only: counting syncs the host
    # with the card at every tally
    counted = count_ops if stats is not None else \
        lambda: contextlib.nullcontext({})
    seen = None
    if memo is not None and kname == "mesh_tile":
        seen = next((m for m in memo if _same_args(m[0], args)), None)
    if seen is None:
        with counted() as plain_ops:
            p_ms, ref = cuda_ms(lambda: reference(*held), 1)
        if memo is not None and kname == "mesh_tile":
            memo.append((args, ref, p_ms, plain_ops))
    else:
        _, ref, p_ms, plain_ops = seen
    refs = [("plain", flat(ref)[:len(got)])]
    culled_ops = plain_ops
    counts = {}
    if key.endswith("_crowd"):
        m = masks_of(kname, held)
        counts = m.counts()
        with counted() as culled_ops:
            masked = reference(*held, masks=m)
        refs.append(("masked plain", flat(masked)[:len(got)]))
    for which, r in refs:
        for out_name, a, b in zip(names, got, r):
            if not torch.equal(a, b):
                err = float((a.double() - b.double()).abs().max())
                raise AssertionError(f"{label}: {key} differs from its "
                                     f"{which} version in {out_name} "
                                     f"(max abs diff {err})")
    errs[key] = max(errs.get(key, 0.0), max(
        float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
        for a, b in zip(got, refs[0][1])))
    if stats is None:
        return got
    s_ = stats.setdefault(key, dict(ms=0.0, plain_ms=0.0, ops=0,
                                    ops_unculled=0, bytes=0, calls=0))

    def launch_ms(call_args):
        launch, _ = launcher(*call_args)
        launch()
        k_ms, _ = cuda_ms(lambda: [launch() for _ in range(LAUNCH_REPS)], 3)
        return min(k_ms) / LAUNCH_REPS

    scene_t, st = args[:2]
    for one in timed:
        s_["ms"] += launch_ms(one)
        if kname == "render_tile":
            s_["ms_ao_off"] = s_.get("ms_ao_off", 0.0) + launch_ms(
                (scene_t, st.with_(ao=False)) + tuple(one[2:]))
        elif kname == "trace_rays":
            s_["ms_empty_segments"] = s_.get("ms_empty_segments", 0.0) + \
                launch_ms(_empty_segments(one))
        elif kname == "ao_fix":
            s_["ms_need_zero"] = s_.get("ms_need_zero", 0.0) + launch_ms(
                _need_zero(one))
    if part is not None:
        s_["pass_ms"] = s_.get("pass_ms", 0.0) + launch_ms(args)
    s_["plain_ms"] += p_ms[0]
    s_["ops"] += culled_ops["ops"]
    s_["ops_unculled"] += plain_ops["ops"]
    s_["bytes"] += bytes_read(kname, held) + nbytes(got)
    s_["calls"] += 1
    for loop, (mean, top) in counts.items():
        s_.setdefault("masked_members", {})[
            f"{loop} call {s_['calls'] - 1}"] = [round(mean, 3), top]
    return got


def opposed_rays(n_pairs: int, seed: int = 5):
    """n_pairs rays from scattered origins above crowd_demo's floor, each
    aimed at a random point of the crowd's field (numpy, from seed), and
    each also shot the other way: ray 2k+1 is ray 2k with its direction
    negated, so a whole warp's directions sum to exactly 0 -> (o, d), each
    float32 (3, 2 n_pairs)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    o = rng.uniform((-3.0, 0.2, -2.5), (3.0, 2.5, 1.0), (n_pairs, 3))
    d = rng.uniform((-4.5, -1.0, 1.5), (4.5, 0.0, 9.0), (n_pairs, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.repeat(o.astype(np.float32), 2, axis=0)
    d = np.stack((d, -d), 1).reshape(-1, 3).astype(np.float32)
    return o.T.copy(), d.T.copy()


def _hold_opposed(dev, scene, modes: dict, errs: dict) -> int:
    """A ray batch that shoots each point both ways (opposed_rays, 4083
    rays: the last warp ragged) through K1 with the crowd, and through K2
    in both modes as shadow segments of length 6, each call held as
    _hold_call holds them: each warp's capsule takes the fallback axis,
    and a kernel that culled with no axis would miss the crowd. -> the
    number of calls held."""
    import torch

    from surfjax_torch.core.math import f32
    from surfjax_torch.core.scene_compile import params_to_device
    from surfjax_torch.kernels.render_tile import SceneTensors
    o_np, d_np = opposed_rays(2048)
    n = o_np.shape[1] - 13
    o = tuple(torch.as_tensor(c[:n], device=dev) for c in o_np)
    d = tuple(torch.as_tensor(c[:n], device=dev) for c in d_np)
    static, params = scene.freeze()
    scene_t = SceneTensors(static, params_to_device(params, dev))
    calls = [("render_tile", (scene_t, modes["config"], o, d))]
    calls += [("trace_rays", (scene_t, st, o, d,
                              torch.full((n,), 6.0, device=dev),
                              torch.full((n,), f32(st.soft_shadow_k),
                                         device=dev)))
              for st in modes.values()]
    outs = [_hold_call(kname, args, f"opposed rays {kname}", errs)
            for kname, args in calls]
    ids = torch.unique(outs[0][1]).tolist()
    if sum(0 <= i < len(scene.objects) - 1 for i in ids) < 10:
        raise AssertionError(f"opposed rays: K1 hit the objects {ids}")
    return len(calls)


def crowd_mesh_phase(dev, smi: str) -> dict:
    """Phase 23, the split path's crowd main path (module docstring) ->
    {"launches": per crowd kernel, its launches on the path (both modes);
    "err": per crowd kernel, the largest error of its checks; "frame":
    per mode and kernel, the per-frame table of frames 0 and F-1 of a
    16-frame pass, each cut and launched alone (_hold_call's stats halved,
    pass_ms over the pass's frames, with each kernel's bound, culled and
    unculled); "results": per mode the path's figures}."""
    import torch

    from surfjax_torch.api import render_sequence
    from surfjax_torch.kernels.render_tile import (
        LANES, frame_fused, pass_rays, split_crowd,
    )
    from surfjax_torch.tools.kernel_check import capture_calls
    from surfjax_torch.tools.workload import crowd_mesh_main_path, cuda_ms
    t23 = time.perf_counter()
    scene, camera, Rs, ps, modes = crowd_mesh_main_path()
    n_frames, n_lights = len(ps), len(scene.lights)
    H, W = camera.intrinsics.height, camera.intrinsics.width
    static = scene.freeze()[0]
    mesh_id = len(scene.objects) - 1
    n_members = len(split_crowd(static, modes["config"])[0].members)
    rows = pass_rays(static, camera.intrinsics, modes["config"]) // LANES
    wrappers = dict(_split_wrappers(), frame_fused=frame_fused,
                    frame_fused_crowd=frame_fused.crowd)
    idx = [0, n_frames - 1]
    launches = dict.fromkeys(CROWD_SPLIT, 0)
    errs, frame, results, memo = {}, {}, {}, []
    for mode, st in modes.items():
        call = lambda st=st: render_sequence(scene, camera, (Rs, ps), st,
                                             device=dev)
        alone = frames_alone(scene, camera, ps, st, dev)
        for w in wrappers.values():
            w.launches = 0
        fb, peak = peak_bytes(call, dev)
        got = {k: w.launches for k, w in wrappers.items()}
        want = pass_launches(scene, camera, st, n_frames)
        if got != want:
            raise AssertionError(f"crowd_mesh {mode}: launches {got}, "
                                 f"expected {want}")
        same_frames(fb, alone, f"crowd_mesh {mode} first call")
        times = []
        for c in range(3):
            ms, fb = cuda_ms(call, 1)
            times += ms
            same_frames(fb, alone, f"crowd_mesh {mode} timed call {c}")
        for k in CROWD_SPLIT:
            launches[k] += got[k]
        step, drift = check_sequence(f"crowd_mesh {mode}", fb,
                                     len(scene.objects), CROWD_STEP_MAX,
                                     CROWD_DRIFT_MAX)
        ids = torch.unique(fb.obj_id[0])
        n_crowd_ids = int(((ids >= 0) & (ids != mesh_id)).sum())
        if mesh_id not in ids.tolist() or n_crowd_ids < 10:
            raise AssertionError(f"crowd_mesh {mode}: frame 0 shows the mesh "
                                 f"{mesh_id in ids.tolist()} and "
                                 f"{n_crowd_ids} crowd members")
        # the kernel calls of one more call, each launched at the pass's
        # shape, its rows of frames 0 and F-1 held against the plain
        # versions on those frames alone; the table per frame: frames 0
        # and F-1 each launched alone, halved, and the pass's time over
        # its frames
        with capture_calls() as calls:
            again = call()
        same_frames(again, alone, f"crowd_mesh {mode} recorded call")
        del again, alone
        k1 = [k for k, (kname, _) in enumerate(calls)
              if kname == "render_tile"]
        if len(k1) != 1:
            raise AssertionError(f"crowd_mesh {mode}: K1 calls at {k1}")
        stats = {}
        for k, (kname, args) in enumerate(calls):
            _hold_call(kname, args, f"crowd_mesh {mode} call {k}", errs,
                       stats, memo, part=(rows, idx))
        del calls
        for key, s_ in stats.items():
            for name in s_:
                if name != "calls" and isinstance(s_[name], (int, float)):
                    s_[name] /= n_frames if name == "pass_ms" else len(idx)
            if key in CROWD_SPLIT:
                s_["bound_ms"], s_["bound_by"] = bound(s_["ops"], s_["bytes"])
                s_["unculled_bound_ms"] = bound(s_["ops_unculled"],
                                                s_["bytes"])[0]
            log(f"  {mode} per frame (frames {idx}) {key}: " + json.dumps(s_))
        frame[mode] = stats
        n_hits = float(fb.hit.sum()) / n_frames
        rays = float(W * H) + n_hits * n_lights * st.shadows \
            + n_hits * st.ao_samples * st.ao
        s_frame = min(times) / 1e3 / n_frames
        results[mode] = dict(
            ms_per_frame=min(times) / n_frames,
            ms_per_call=[round(t, 3) for t in times],
            frames_per_s=1.0 / s_frame, rays_per_frame=rays,
            mrays_per_s=rays / s_frame / 1e6, hit_fraction=n_hits / (W * H),
            mesh_fraction=float((fb.obj_id[0] == mesh_id).float().mean()),
            crowd_ids=n_crowd_ids, hit_fraction_drift=drift,
            hit_fraction_max_step=step, launches=got,
            peak_bytes_per_pass=peak, peak_bytes_per_ray=peak / (
                n_frames * pass_rays(static, camera.intrinsics, st)))
        log(f"  {mode}: " + json.dumps(results[mode]))
        del fb
    t_opp = time.perf_counter()
    held = _hold_opposed(dev, scene, modes, errs)
    log(f"  a batch shooting each point both ways: {held} calls (K1, K2 "
        "hard and soft) bitwise equal to their plain versions, masked and "
        f"unmasked ({time.perf_counter() - t_opp:.1f} s)")
    log(f"phase 23: the crowd-mesh main path 1920x1080 x {n_frames} frames, "
        f"{n_members} crowd members, in one pass, every frame of every "
        f"call == render(), the pass's kernel calls on frames 0 and "
        f"{n_frames - 1} bitwise equal to the plain versions, masked and "
        f"unmasked; launches {json.dumps(launches)} "
        f"({time.perf_counter() - t23:.1f} s) on {smi}")
    return {"launches": launches, "err": errs, "frame": frame,
            "results": results}


def limits_phase(dev, smi: str) -> dict:
    """Phase 24, scenes past the kernels' former fixed bounds (module
    docstring) -> {"launches": the fused kernel's on compile_scaling's
    path, per instantiation; "err": per kernel, the largest error of its
    checks; "rows": compile_scaling's rows}."""
    import numpy as np
    import torch

    from surfjax_torch import api
    from surfjax_torch.core.camera import flat_camera_rays
    from surfjax_torch.core.scene_compile import ENGINE_MESH, params_to_device
    from surfjax_torch.core.types import FrameBuffers
    from surfjax_torch.kernels.render_tile import (
        SceneTensors, frame_buffers, frame_fused, frame_fused_reference,
        launches_crowd, prime_frame, prime_tile, render_rays_pallas,
        wide_scene,
    )
    from surfjax_torch.tools import compile_scaling
    from surfjax_torch.tools.kernel_check import capture_calls
    from surfjax_torch.tools.workload import (
        cam_rows_of, cuda_ms, limit_cases, reframe,
    )
    t24 = time.perf_counter()
    # (a) compile_scaling's per-object half and its crowd at 1080p: the
    # counts set to 0 just before each call and read just after
    launches = {"frame_fused": 0, "frame_fused_crowd": 0}
    rows, errs, widest = [], {}, None
    for kind in ("sphere", "csgpair"):
        for n in LIMIT_COUNTS:
            fbs = {}
            for mode, vec in compile_scaling.MODES:
                got = []
                row = compile_scaling.measure(n, vec, kind, LIMIT_FRAMES, 3,
                                              device=dev, out=got)
                key = "frame_fused_crowd" if vec else "frame_fused"
                if row["launches"] != 4:
                    raise AssertionError(f"compile_scaling {kind} {n} {mode}"
                                         f": {row['launches']} launches, "
                                         "expected 4")
                launches[key] += row["launches"]
                fb = got[-1]
                ids = fb.obj_id
                if not all(bool(torch.isfinite(a).all()) for a in fb) or \
                        not bool(((ids >= -1) & (ids <= n)).all()) or \
                        row["hit_fraction"] < 0.2:
                    raise AssertionError(f"compile_scaling {kind} {n} {mode}"
                                         f": bad frames ({row})")
                fbs[mode] = fb
                if (kind, n, vec) == ("sphere", LIMIT_COUNTS[-1], False):
                    widest = fb
                rows.append(row)
                log(f"  compile_scaling {kind} {row['objects']} objects "
                    f"{mode}: first call {row['first_s']:.4f} s, "
                    f"{row['ms_frame']:.4f} ms/frame, hit fraction "
                    f"{row['hit_fraction']:.4f}")
            on, off = fbs["crowd"], fbs["per-object"]
            for name in ("depth", "normal", "hit", "obj_id"):
                if not torch.equal(getattr(on, name), getattr(off, name)):
                    raise AssertionError(f"compile_scaling {kind} {n}: the "
                                         f"crowd changed {name}")
            ulp = (on.rgb.view(torch.int32).long()
                   - off.rgb.view(torch.int32).long()).abs().max()
            if int(ulp) > 2:
                raise AssertionError(f"compile_scaling {kind} {n}: the crowd "
                                     f"moved rgb by {int(ulp)} ulp")
    for key, n_l in launches.items():
        if n_l < 1:
            raise AssertionError(f"compile_scaling launched no {key}")
    log(f"  compile_scaling at 1920x1080 x {LIMIT_FRAMES} frames: "
        + json.dumps(rows))
    # KF's KF_WIDE build alone on the widest per-object row, 129 spheres:
    # its frames those of the row's last call, frame 0 bitwise equal to
    # the plain version at 1080p (where each persistent block takes more
    # than one tile), then its time, without AO as the row and with it
    t_w = time.perf_counter()
    scene, cam, seq = compile_scaling.case(LIMIT_COUNTS[-1], "sphere",
                                           LIMIT_FRAMES)
    static, params = scene.freeze()
    if not wide_scene(static, False):
        raise AssertionError("compile_scaling's widest row takes the "
                             "default build")
    scene_t = SceneTensors(static, params_to_device(params, dev))
    st = compile_scaling.settings_of(False)
    intr = cam.intrinsics
    rows12 = cam_rows_of(*seq, dev)
    out = frame_fused(scene_t, st, intr, rows12)
    bitwise(frame_buffers(out), widest, FrameBuffers._fields,
            f"compile_scaling {LIMIT_COUNTS[-1] + 1} spheres per object, "
            "KF's frames against the row's")
    errs["frame_fused"] = bitwise(
        [a[:1] for a in out], frame_fused_reference(scene_t, st, intr,
                                                    rows12[:1]),
        NINE, f"KF_WIDE on {LIMIT_COUNTS[-1] + 1} spheres, 1080p frame 0")
    k_ms, _ = cuda_ms(lambda: frame_fused(scene_t, st, intr, rows12), 3)
    wide_ms = min(k_ms) / LIMIT_FRAMES
    st_ao = st.with_(ao=True)
    frame_fused(scene_t, st_ao, intr, rows12)
    k_ms, _ = cuda_ms(lambda: frame_fused(scene_t, st_ao, intr, rows12), 3)
    wide_ao_ms = min(k_ms) / LIMIT_FRAMES
    # KF with a crowd in its KF_WIDE build: crowd 120+8+70 at 1080p, AO
    # off and on (AO's objects past the mask's 64 in ao_core)
    c_scene, c_cam, c_st = limit_cases(api, (1920, 1080))["crowd 120+8+70"]
    c_static, c_params = c_scene.freeze()
    if not (wide_scene(c_static, True) and launches_crowd(c_static, c_st)):
        raise AssertionError("crowd 120+8+70 takes no wide crowd kernel")
    c_t = SceneTensors(c_static, params_to_device(c_params, dev))
    c_rows = cam_rows_of(np.asarray(c_cam.rotation, np.float32).reshape(1, 9),
                         np.asarray(c_cam.position, np.float32).reshape(1, 3),
                         dev)
    crowd_ms = {}
    for ao in (False, True):
        st_c = c_st.with_(ao=ao)
        frame_fused(c_t, st_c, c_cam.intrinsics, c_rows)
        k_ms, _ = cuda_ms(lambda st_c=st_c: frame_fused(
            c_t, st_c, c_cam.intrinsics, c_rows), 3)
        crowd_ms["ao" if ao else "no_ao"] = min(k_ms)
    log(f"  KF's KF_WIDE build on {LIMIT_COUNTS[-1] + 1} spheres at "
        f"1920x1080: {wide_ms:.4f} ms/frame, with AO {wide_ao_ms:.4f}; with "
        f"a crowd on crowd 120+8+70 (71 objects outside it) "
        f"{crowd_ms['no_ao']:.4f}, with AO {crowd_ms['ao']:.4f} "
        f"({time.perf_counter() - t_w:.1f} s)")
    t_b = time.perf_counter()
    # (b) every kernel whose source changed against its plain version on
    # workload.limit_cases at 128x72: KF (staged, and with a crowd), K1,
    # K2 and ao_fix (staged and with a crowd) with the mesh kernel, the
    # priming kernel
    cases = limit_cases(api, LIMITS_SIZE)
    n_calls = 0
    for name, (scene, cam, st) in cases.items():
        static, params = scene.freeze()
        if not wide_scene(static, bool(st.vector_objects)):
            raise AssertionError(f"limits {name}: not a wide scene")
        scene_t = SceneTensors(static, params_to_device(params, dev))
        intr = cam.intrinsics
        R = np.asarray(cam.rotation, np.float32).reshape(1, 9)
        pos = np.asarray(cam.position, np.float32).reshape(1, 3)
        if "mesh" in name:
            mesh_id = next(i for i, o in enumerate(static.ir.objects)
                           if o.engine == ENGINE_MESH)
            for vec in sorted({False, True} if name == "mesh + 70" else
                              {bool(st.vector_objects)}):
                with capture_calls() as calls:
                    fb = api.render(scene, cam, st.with_(vector_objects=vec),
                                    device=dev)
                names = {kernel_key(k, a) for k, a in calls}
                want = {"render_tile", "trace_rays", "ao_fix", "mesh_tile",
                        "mesh_candidates"}
                if vec:
                    want = {k if k.startswith("mesh") else k + "_crowd"
                            for k in want}
                if names != want:
                    raise AssertionError(f"limits {name} crowd {vec}: "
                                         f"kernels {names}, expected {want}")
                for k, (kname, args) in enumerate(calls):
                    _hold_call(kname, args, f"limits {name} crowd {vec} "
                               f"call {k}", errs)
                n_calls += len(calls)
                if int((fb.obj_id == mesh_id).sum()) < 10:
                    raise AssertionError(f"limits {name}: the mesh is not "
                                         "in view")
            continue
        rows12 = cam_rows_of(R, pos, dev)
        key = "frame_fused_crowd" if launches_crowd(static, st) \
            else "frame_fused"
        out = frame_fused(scene_t, st, intr, rows12)
        ref = frame_fused_reference(scene_t, st, intr, rows12)
        errs[key] = max(errs.get(key, 0.0),
                        bitwise(out, ref, NINE, f"limits {name} {key}"))
        o, d, _ = flat_camera_rays(intr, rows12[0, :9], rows12[0, 9:])
        with capture_calls() as calls:
            render_rays_pallas(static, st, scene_t.params, o, d)
        for k, (kname, args) in enumerate(calls):
            _hold_call(kname, args, f"limits {name} call {k}", errs)
        n_calls += len(calls) + 1
        if name in ("64 spheres", "smooth 65 right"):
            with capture_calls() as calls:
                api.render(scene, cam, st.with_(prime=True, prime_min=64),
                           device=dev)
            if [k for k, _ in calls] != ["prime_tile"]:
                raise AssertionError(f"limits {name} primed: calls "
                                     f"{[k for k, _ in calls]}")
            _hold_call("prime_tile", calls[0][1], f"limits {name} primed",
                       errs)
            n_calls += 1
    log(f"  {n_calls} kernel calls held ({time.perf_counter() - t_b:.1f} s)")
    # (c) a primed 1080p frame of the 65-object scene through render(): its
    # priming call and its KF launch (KF_WIDE, with the primed starts)
    # bitwise equal to their plain versions, the frame KF's
    t_c = time.perf_counter()
    scene, cam, st = limit_cases(api)["64 spheres"]
    cam = reframe(cam, 1920, 1080)
    st = st.with_(prime=True)
    before = (prime_tile.launches, frame_fused.launches)
    with capture_calls() as calls:
        ms, fb = cuda_ms(lambda: api.render(scene, cam, st, device=dev), 1)
    made = (prime_tile.launches - before[0],
            frame_fused.launches - before[1])
    if made != (1, 1) or [k for k, _ in calls] != ["prime_tile"]:
        raise AssertionError(f"limits primed 1080p: launches {made}, calls "
                             f"{[k for k, _ in calls]}")
    _hold_call("prime_tile", calls[0][1], "limits primed 1080p", errs)
    static, params = scene.freeze()
    scene_t = SceneTensors(static, params_to_device(params, dev))
    R, pos = (torch.as_tensor(np.asarray(a, np.float32).reshape(-1),
                              device=dev)
              for a in (cam.rotation, cam.position))
    t0 = prime_frame(static, cam.intrinsics, st, scene_t.params, R, pos)[None]
    row = torch.cat([R, pos]).reshape(1, 12)
    out = frame_fused(scene_t, st, cam.intrinsics, row, t0)
    errs["frame_fused"] = max(errs["frame_fused"], bitwise(
        out, frame_fused_reference(scene_t, st, cam.intrinsics, row, t0),
        NINE, "limits primed 1080p KF_WIDE"))
    bitwise(FrameBuffers(*(a[0] for a in frame_buffers(out))), fb,
            FrameBuffers._fields, "limits primed 1080p render() against KF")
    if float(fb.hit.float().mean()) < 0.5:
        raise AssertionError("limits primed 1080p: bad frame")
    log(f"  the 65-object scene primed at 1920x1080: {ms[0]:.2f} ms "
        "through render(), its priming call and KF launch bitwise equal to "
        f"the plain versions ({time.perf_counter() - t_c:.1f} s)")
    log(f"phase 24: scenes past the former fixed bounds: compile_scaling "
        f"at {', '.join(str(n + 1) for n in LIMIT_COUNTS)} objects (per "
        f"object and as a crowd, both kinds), launches "
        f"{json.dumps(launches)}; {n_calls} kernel calls on "
        f"{len(cases)} scenes at {LIMITS_SIZE[0]}x{LIMITS_SIZE[1]} bitwise "
        f"equal to their plain versions; errors {json.dumps(errs)} "
        f"({time.perf_counter() - t24:.1f} s) on {smi}")
    return {"launches": launches, "err": errs, "rows": rows,
            "wide_ms": wide_ms, "wide_ao_ms": wide_ao_ms,
            "wide_crowd_ms": crowd_ms,
            "wide_launches": sum(r["launches"] for r in rows
                                 if r["mode"] == "per-object")}


BENCH_KERNELS = ("frame_fused", "render_tile", "trace_rays", "ao_fix",
                 "mesh_tile", "prime_tile", "mesh_candidates")
C4_ROW_KERNELS = ("render_tile", "trace_rays", "mesh_tile", "mesh_candidates")


def _module_env() -> dict:
    """The environment of a `python -m surfjax_torch...` child process: this
    checkout first on its path."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))


def check_frames(seqs: list, timings: list, dev, errs: dict,
                 label: str) -> None:
    """Frames 0 and F-1 of each recorded call held bitwise against the
    plain versions on the same inputs (mesh-free: frame_fused_reference
    on the frame's camera row; mesh: each split-kernel call of the two
    frames rendered again, and those frames equal to the call's), and
    the call's hits per frame equal to those time_mode counted; then
    the records are dropped. seqs: (scene, camera, poses, settings,
    buffers) of each call; timings: bench.time_mode's results, one per
    call; errs: per kernel the largest error so far, updated."""
    import numpy as np
    import torch

    from surfjax_torch.api import render_sequence
    from surfjax_torch.core.scene_compile import params_to_device
    from surfjax_torch.core.types import FrameBuffers
    from surfjax_torch.kernels import render_tile as rt
    from surfjax_torch.tools.kernel_check import capture_calls, compare
    from surfjax_torch.tools.workload import cam_rows_of
    if len(seqs) != len(timings):
        raise AssertionError(f"{label}: {len(timings)} timed modes, "
                             f"{len(seqs)} recorded sequences")
    for (scene, camera, (Rs, ps), st, fb), timing in zip(seqs, timings):
        hits = fb.hit.sum(dim=(1, 2), dtype=torch.float64).cpu().numpy()
        if not np.array_equal(hits, timing.hits):
            raise AssertionError(f"{label}: the checked frames' hits "
                                 "differ from the counted ones")
        idx = sorted({0, len(ps) - 1})
        static, params = scene.freeze()
        if static.mesh_static:
            with capture_calls() as calls:
                again = render_sequence(scene, camera, (Rs[idx], ps[idx]),
                                        st, device=dev)
            if not set(C4_ROW_KERNELS) <= {c[0] for c in calls}:
                raise AssertionError(f"{label}: calls {[c[0] for c in calls]}")
            for k, (kname, args) in enumerate(calls):
                err, _, _ = compare(kname, args, f"{label} call {k}")
                errs[kname] = max(errs[kname], err)
            bitwise(FrameBuffers(*(a[idx] for a in fb)), again,
                    FrameBuffers._fields,
                    f"{label} frames {idx} against {len(calls)} kernel "
                    "calls each equal to its plain version")
            continue
        key = ("frame_fused_crowd" if rt.split_crowd(static, st)[0]
               is not None else "frame_fused")
        scene_t = rt.SceneTensors(static, params_to_device(params, dev))
        rows_ = cam_rows_of(Rs, ps, dev)
        for f in idx:
            ref = rt.frame_fused_reference(scene_t, st, camera.intrinsics,
                                           rows_[f:f + 1])
            errs[key] = max(errs[key], bitwise(
                FrameBuffers(*(a[f:f + 1] for a in fb)),
                rt.frame_buffers(ref), FrameBuffers._fields,
                f"{label} frame {f} against the plain version"))
    timings.clear()
    seqs.clear()


def bench_phase(dev, smi: str, hits3: dict) -> dict:
    """Phase 22: the benchmark harness (surfjax_torch.bench), its `bench`
    subcommand, the workload matrix (tools/bench_all.py, --rows matrix and
    gated) and the quickstart on the card. hits3: phase 3's hits per frame
    of each mode. -> {"launches": per kernel, the launches of the in-process
    runs (a) and (c); "err": per kernel, the largest error of the checks
    of their frames against the plain versions; KF's crowd instantiation
    as frame_fused_crowd}."""
    import subprocess
    import tempfile

    import numpy as np

    from surfjax_torch import bench
    from surfjax_torch.kernels import mesh_tile as mt, render_tile as rt
    from surfjax_torch.tools import bench_all
    t22 = time.perf_counter()
    wrappers = {"frame_fused": rt.frame_fused, "render_tile": rt.render_tile,
                "trace_rays": rt.trace_rays, "ao_fix": rt.ao_fix,
                "mesh_tile": mt.mesh_tile, "prime_tile": rt.prime_tile,
                "mesh_candidates": mt.mesh_candidates,
                "frame_fused_crowd": rt.frame_fused.crowd}
    totals = dict.fromkeys(BENCH_KERNELS + ("frame_fused_crowd",), 0)
    errs = dict.fromkeys(totals, 0.0)

    def counted(fn):
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        return out, {k: w.launches for k, w in wrappers.items()}

    # every bench.time_mode call of a run and the buffers of its last
    # render_sequence call, kept for the checks against the plain versions
    timings, seqs = [], []
    time_mode, render_sequence = bench.time_mode, bench.render_sequence

    def recording_time_mode(*args, **kw):
        timings.append(time_mode(*args, **kw))
        return timings[-1]

    def recording_sequence(scene, camera, poses_, settings, device):
        fb = render_sequence(scene, camera, poses_, settings, device=device)
        if seqs and seqs[-1][2] is poses_ and seqs[-1][3] is settings:
            seqs.pop()
        seqs.append((scene, camera, poses_, settings, fb))
        return fb

    # bench_all holds its own name of time_mode; both call bench's
    # render_sequence
    bench.time_mode = bench_all.time_mode = recording_time_mode
    bench.render_sequence = recording_sequence
    try:
        # (a) run_bench in this process
        hb, got = counted(lambda: bench.run_bench(device=dev))
        want = dict.fromkeys(wrappers, 0)
        want["frame_fused"] = 2 * (1 + hb["repeats"])   # one per call
        if got != want:
            raise AssertionError(f"run_bench launched {got}, expected "
                                 f"{want}")
        for k, v in got.items():
            totals[k] += v
        for timing, mode in zip(timings, ("value", "value_exact")):
            if not np.array_equal(timing.hits, hits3[mode]):
                raise AssertionError(f"run_bench's hits per frame ({mode}) "
                                     "differ from phase 3's")
        check_frames(seqs, timings, dev, errs, "run_bench")
        scene, camera, settings = bench.metric_workload()[:3]
        rays3 = int(bench.rays_per_frame(scene, settings, camera.intrinsics,
                                         float(hits3["value"].sum()) / 48))
        if hb["rays_per_frame"] != rays3:
            raise AssertionError(f"rays_per_frame {hb['rays_per_frame']}, "
                                 f"from phase 3's frames {rays3}")
        log("  run_bench (hits per frame == phase 3's, both modes; frames "
            "0 and 47 == the plain version's; launches "
            f"{got['frame_fused']} of KF, none else): " + json.dumps(hb))

        # (c) the workload matrix and the gated rows: each row's launches,
        # its first and last frame against the plain versions
        for kind in ("matrix", "gated"):
            for workload, measure in bench_all.rows(kind, dev):
                rows, got = counted(measure)
                kf = got["frame_fused"] + got["frame_fused_crowd"]
                others = {k: v for k, v in got.items()
                          if k not in ("frame_fused", "frame_fused_crowd")}
                if workload in ("c4_fixture", "c4_config"):
                    ok = kf == 0 and all(got[k] > 0 for k in C4_ROW_KERNELS)
                else:
                    ok = kf > 0 and not any(others.values())
                if not ok:
                    raise AssertionError(f"{kind} {workload}: launches {got}")
                if workload == "crowd64" and got["frame_fused"]:
                    # KF's launches on a crowd are its crowd instantiation's
                    raise AssertionError(f"crowd64 launched {got}")
                for k, v in got.items():
                    totals[k] += v
                check_frames(seqs, timings, dev, errs,
                             f"{kind} {workload}")
                for r in rows:
                    if not r["frame_ms"] > 0:
                        raise AssertionError(f"{kind} {workload}: {r}")
                    log(f"  {kind} {workload}: " + json.dumps(r))
                log(f"    launches {json.dumps(got)}")
    finally:
        bench.time_mode = bench_all.time_mode = time_mode
        bench.render_sequence = render_sequence

    # (b) the command line in a process of its own
    env = _module_env()
    tb = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "surfjax_torch", "bench", "--repeats", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError("python -m surfjax_torch bench failed:\n"
                             + proc.stderr[-4000:])
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    if len(lines) != 1:
        raise AssertionError(f"bench printed {len(lines)} lines: {lines}")
    sub = json.loads(lines[0])
    if sub["rays_per_frame"] != hb["rays_per_frame"]:
        raise AssertionError(f"bench's rays_per_frame {sub['rays_per_frame']}"
                             f" against run_bench's {hb['rays_per_frame']}")
    log(f"  python -m surfjax_torch bench --repeats 1 "
        f"({time.perf_counter() - tb:.1f} s): {lines[0]}")

    # (d) the quickstart on the card, in a process of its own
    with tempfile.TemporaryDirectory() as tmp:
        tq = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "surfjax_torch.quickstart", "--out-dir",
             tmp], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            raise AssertionError("the quickstart failed:\n"
                                 + proc.stderr[-4000:])
        png = os.path.join(tmp, "frame.png")
        if not os.path.getsize(png) > 0:
            raise AssertionError("the quickstart wrote no frame.png")
        for ln in proc.stdout.splitlines():
            log(f"  quickstart: {ln}")
        log(f"  quickstart ({time.perf_counter() - tq:.1f} s): frame.png "
            f"{os.path.getsize(png)} bytes")
    log(f"phase 22: the benchmark harness, the workload matrix and the "
        f"quickstart, launches {json.dumps(totals)} "
        f"({time.perf_counter() - t22:.1f} s) on {smi}")
    return {"launches": totals, "err": errs}


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
    from surfjax_torch.kernels.mesh_tile import mesh_tile
    from surfjax_torch.kernels.render_tile import (
        SceneTensors, ao_fix, count_ops, frame_buffers, frame_fused,
        frame_fused_reference, render_tile, trace_rays,
    )
    from surfjax_torch.tools.kernel_check import (
        KERNELS, capture_calls, compare, flat, fresh,
    )
    from surfjax_torch.tools.workload import (
        EXACT, cam_rows_of, cuda_ms, gpu_line, main_path, mesh_main_path,
        crowd_cases, crowd_main_path, mesh_modes, mesh_soft_ao_scene, poses,
        reframe, sphere_crowd, two_mesh_scene,
    )
    from surfjax_torch.kernels.render_tile import (
        LANES, crowd_warp_masks, frames_per_pass, pass_rays, prime_frame,
        prime_frames, prime_tile, split_crowd,
    )
    from surfjax_torch.tools.breakdown import (
        crowd_variants, fused_path, kf_phases, mesh_phases, prime_phases,
        split_phases,
    )
    from surfjax_torch.kernels.mesh_tile import (
        mesh_cull_count, mesh_warp_masks,
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
        "<true>, K1, K2 and ao_fix with a crowd, the staged fused kernel, "
        "the staged K1 and K2, both K1 and K2 with and without unres) "
        "unchanged")
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
    hits3 = {}   # hits per frame of each mode, exact, for phase 22
    frame_fused.launches = 0
    for mode, st in modes.items():
        call = lambda st=st: render_sequence(scene, camera, (Rs, ps), st,
                                             device=dev)
        call()
        torch.cuda.synchronize()
        times, fb = cuda_ms(call, 3)
        results[mode] = (times, st, fb)
        hits3[mode] = fb.hit.sum(dim=(1, 2), dtype=torch.float64).cpu()
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
    split = SPLIT
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
    # the c4 main path: 16 frames in one pass of the split path, launches
    # per pass, every frame of each timed call against render() of it
    t6 = time.perf_counter()
    scene, camera, Rs, ps, modes = mesh_main_path(c4_path)
    n_frames = len(ps)
    n_objects = len(scene.objects)
    H, W = camera.intrinsics.height, camera.intrinsics.width
    wrappers = dict(_split_wrappers(), frame_fused=frame_fused,
                    frame_fused_crowd=frame_fused.crowd)
    mesh_results, mesh_launches, mesh_alone = {}, {}, {}
    for mode, st in modes.items():
        call = lambda st=st: render_sequence(scene, camera, (Rs, ps), st,
                                             device=dev)
        alone = frames_alone(scene, camera, ps, st, dev)
        mesh_alone[mode] = (alone[0], alone[-1])
        for w in wrappers.values():
            w.launches = 0
        fb, peak = peak_bytes(call, dev)
        counts = {name: w.launches for name, w in wrappers.items()}
        want = pass_launches(scene, camera, st, n_frames)
        if counts != want:
            raise AssertionError(f"{mode}: launches {counts}, expected "
                                 f"{want}")
        same_frames(fb, alone, f"c4 {mode} first call")
        times = []
        for c in range(3):
            ms, fb = cuda_ms(call, 1)
            times += ms
            same_frames(fb, alone, f"c4 {mode} timed call {c}")
        mesh_launches[mode] = counts
        step, drift = check_sequence(mode, fb, n_objects, MESH_STEP_MAX,
                                     MESH_DRIFT_MAX)
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
            launches=counts, peak_bytes_per_pass=peak,
            peak_bytes_per_ray=peak / (n_frames * pass_rays(
                scene.freeze()[0], camera.intrinsics, st)))
        log(f"  {mode}: " + json.dumps(mesh_results[mode]))
        del fb, alone
    log(f"phase 6: mesh main path 1920x1080 x {n_frames} frames in one pass "
        f"(launches per pass; every frame of every call == render()) "
        f"({time.perf_counter() - t6:.1f} s) on {smi}")

    # -- phase 7 ------------------------------------------------------------
    # every split kernel call of one 16-frame pass of phase 6's main path,
    # launched at the pass's shape, its rows of frames 0 and F-1 held
    # against the plain version run on those two frames alone (frame_cut);
    # per frame: the kernel's times, operations and bytes on frame 0's cut
    # launched alone (one 1080p frame's call), the plain version's time
    # (the two frames' halved), and the whole pass launched back to back
    # over its frames (pass_ms)
    t7 = time.perf_counter()
    idx = [0, n_frames - 1]
    rows = pass_rays(scene.freeze()[0], camera.intrinsics,
                     modes["ao"]) // LANES
    per_kernel = {}
    for mode, st in modes.items():
        with capture_calls() as calls:
            render_sequence(scene, camera, (Rs, ps), st, device=dev)
        stats = {k: dict(ms=0.0, call_ms=0.0, pass_ms=0.0, plain_ms=0.0,
                         ops=0, bytes=0, calls=0) for k in split}
        for k, (kname, args) in enumerate(calls):
            wrapper, reference, names, launcher = KERNELS[kname]
            label = f"c4 {mode} 1080p x {n_frames} call {k} {kname}"
            got = [frame_rows(g, out_rows(kname, args, rows), idx)
                   for g in flat(wrapper(*fresh(kname, args)))]
            held = frame_cut(kname, args, rows, idx)
            p_ms, ref = cuda_ms(lambda: reference(*held), 1)
            err = bitwise(got, flat(ref)[:len(got)], names,
                          f"{label} frames {idx} == plain")
            split_err[kname] = max(split_err[kname], err)
            del got, ref, held
            one = frame_cut(kname, args, rows, [0])
            c_ms, got1 = cuda_ms(lambda: wrapper(*fresh(kname, one)), 3)
            # the kernel alone: prepared once, launched back to back, on
            # frame 0 and on the whole pass
            k_ms = []
            for call_args in (one, args):
                launch, _ = launcher(*fresh(kname, call_args))
                launch()
                k_ms.append(min(cuda_ms(
                    lambda: [launch() for _ in range(LAUNCH_REPS)], 3)[0])
                    / LAUNCH_REPS)
                del launch
            if kname == "mesh_tile":
                culled = mesh_cull_count(one, mesh_warp_masks(
                    *one[:7], one[9]))
                ops = culled["ops"]
                log(f"  {mode} call {k} mesh_tile frame 0: culled "
                    f"{json.dumps(culled)}")
            else:
                with count_ops() as c:
                    reference(*fresh(kname, one))
                ops = c["ops"]
            s_ = stats[kname]
            s_["ms"] += k_ms[0]
            s_["pass_ms"] += k_ms[1] / n_frames
            s_["call_ms"] += min(c_ms)
            s_["plain_ms"] += p_ms[0] / len(idx)
            s_["ops"] += ops
            s_["bytes"] += bytes_read(kname, one) + nbytes(flat(got1))
            s_["calls"] += 1
        per_kernel[mode] = stats
        del calls
        log(f"  {mode} per frame: " + json.dumps(stats))
    log(f"phase 7: split kernels of a {n_frames}-frame 1920x1080 pass, "
        f"frames {idx} vs plain ({time.perf_counter() - t7:.1f} s) on {smi}")

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
                _hold_call(kname, args, f"{name} call {k}", split_err)
            log(f"  {name}: {len(calls)} split kernel calls bitwise equal "
                "(K1, K2 and ao_fix also to the masked plain versions)")
        else:
            scene_t = SceneTensors(static, params_to_device(params, dev))
            before = frame_fused.crowd.launches
            fb_on = render_sequence(scene8, cam8, (Rs, ps), on, device=dev)
            if frame_fused.crowd.launches != before + 1:
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
    frame_fused.crowd.launches = 0
    for mode, st in modes.items():
        call = lambda st=st: render_sequence(scene, camera, (Rs, ps), st,
                                             device=dev)
        call()
        torch.cuda.synchronize()
        times, fb = cuda_ms(call, 3)
        crowd_results[mode] = (times, st, fb)
    crowd_launches = frame_fused.crowd.launches
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
    # the primed main path: c3 `value` primed, 1080p x PRIME_FRAMES frames
    # in one pass (one priming launch over every frame's coarse rays, one
    # KF launch with their t0), every frame of each call == render()
    scene10, cam10, Rs10, ps10, modes10 = main_path(
        os.path.join(ROOT, "configs/c3_sdf.yaml"), PRIME_FRAMES)
    st10 = modes10["value"].with_(prime=True)
    call10 = lambda: render_sequence(scene10, cam10, (Rs10, ps10), st10,
                                     device=dev)
    alone = frames_alone(scene10, cam10, ps10, st10, dev)
    prime_tile.launches = frame_fused.launches = 0
    seq10, peak10 = peak_bytes(call10, dev)
    seq_launches = (prime_tile.launches, frame_fused.launches)
    static10, params10 = scene10.freeze()
    passes = -(-PRIME_FRAMES // frames_per_pass(pass_rays(
        static10, cam10.intrinsics, st10)))
    if seq_launches != (passes, passes):
        raise AssertionError(f"primed sequence: launches (prime_tile, KF) "
                             f"{seq_launches}, expected {passes} each")
    same_frames(seq10, alone, "primed c3 first call")
    seq_ms = []
    for c in range(3):
        ms, seq10 = cuda_ms(call10, 1)
        seq_ms += ms
        same_frames(seq10, alone, f"primed c3 timed call {c}")
    check_sequence("primed c3", seq10, len(scene10.objects), 2e-4, 2.5e-3)
    del seq10, alone
    # the pass's two kernels at its shape: prime_tile over every frame's
    # coarse rays and KF over every frame with their t0, the coarse rows
    # and the pixels of frames 0 and F-1 held against the plain versions
    # on those frames alone
    idx10 = [0, PRIME_FRAMES - 1]
    params10 = params_to_device(params10, dev)
    Rs10_t, ps10_t = (torch.as_tensor(np.asarray(a, np.float32).reshape(
        PRIME_FRAMES, -1), device=dev) for a in (Rs10, ps10))
    with capture_calls() as calls:
        t0_all = prime_frames(static10, cam10.intrinsics, st10, params10,
                              Rs10_t, ps10_t)
    (kname, args), = calls
    hc10 = args[3][0].shape[0] // PRIME_FRAMES
    got = [frame_rows(g, hc10, idx10) for g in flat(prime_tile(*args))]
    ref = KERNELS["prime_tile"][1](*frame_cut(kname, args, hc10, idx10))
    prime_err = max(prime_err, bitwise(
        got, flat(ref), KERNELS["prime_tile"][2],
        f"primed c3 1080p x {PRIME_FRAMES} prime_tile frames {idx10}"))
    rows10 = cam_rows_of(Rs10_t, ps10_t, dev)
    scene_t10 = SceneTensors(static10, params10)
    out = frame_fused(scene_t10, st10, cam10.intrinsics, rows10, t0_all)
    ref = frame_fused_reference(scene_t10, st10, cam10.intrinsics,
                                rows10[idx10], t0_all[idx10])
    prime_err = max(prime_err, bitwise(
        [a[idx10] for a in out], ref, NINE,
        f"primed c3 1080p x {PRIME_FRAMES} KF frames {idx10}"))
    del calls, args, got, ref, out, t0_all
    prime_launches, kf_primed_launches = seq_launches
    prime_stats.update(
        sequence_ms_per_frame=min(seq_ms) / PRIME_FRAMES,
        sequence_ms_per_call=[round(t, 3) for t in seq_ms],
        sequence_launches=seq_launches, sequence_peak_bytes_per_pass=peak10,
        sequence_peak_bytes_per_pixel=peak10 / (
            PRIME_FRAMES * cam10.intrinsics.width * cam10.intrinsics.height))
    log(f"  primed c3 1080p x {PRIME_FRAMES} frames: " + json.dumps({
        k: v for k, v in prime_stats.items() if k.startswith("sequence")}))
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
    sweep = fp.run(repeats=3)
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
    # inside the mixes (breakdown.probe_phases, once per mix, then fma_dep
    # against the clock they ran at): the SM clock under load, cycles per
    # substep, the warps' finish spread, SASS per substep by pipe, ptxas,
    # blocks per SM and the issue bound
    from surfjax_torch.tools.breakdown import probe_label, probe_phases
    inside = {}
    for pk in fp.KINDS:
        probe_phases(dev, inside, kinds=(pk,))
    for label, row in inside.items():
        if isinstance(row, str):
            log(f"  {label}: {row} (clocks.sm, power.draw)")
        elif "issue_bound" in row:
            ib = row["issue_bound"]
            log(f"  {label}: {row['ms']:.4f} ms, "
                f"{row['ps_per_iter_lane']:.4f} ps/iter-lane; SM clock "
                f"{row['sm_clock_ghz']:.4f} GHz (warps "
                f"{row['warp_ghz']['p01']:.4f}-{row['warp_ghz']['p99']:.4f});"
                f" {row['cycles_per_substep']['median']:.1f} cycles per "
                f"substep per warp; finish {row['finish_us']['min']:.1f}-"
                f"{row['finish_us']['max']:.1f} us, SMs busy "
                f"{row['sm_busy_share']:.1%}; SASS per substep "
                + json.dumps({k: round(v, 3) for k, v in
                              row["sass"]["per_substep"].items()})
                + f", CALLs in the loop {row['sass']['calls_in_loop']} of "
                f"{row['sass']['calls']}; {row['ptxas'][1]}, "
                f"{row['blocks_per_sm']} blocks/SM, grid {row['grid']} "
                f"({row['waves']:.2f} waves); issue bound {ib['ms']:.4f} ms "
                f"({ib['bound_by']}) = {row['issue_share']:.1%} of the time, "
                f"operations bound {row['ops_bound_ms']:.4f} ms = "
                f"{row['ops_share']:.1%}")
        else:
            log(f"  {label}: " + json.dumps(row))
    for entry, info in probe.items():
        pk, fma = info["kind"], info["fma"]
        if pk in fp.MIXES:
            info["issue_bound"] = inside[probe_label(
                pk, fma, PROBE_UNROLL)]["issue_bound"]["ms"]
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
    log(f"phase 17: K1's, K2's and ao_fix's phase profile on c4 frame 0 "
        f"and a 1080p fit step ({time.perf_counter() - t17:.1f} s) on {smi}")

    # -- phase 18 -----------------------------------------------------------
    # where the priming kernel's time goes: primed c3 at 1080p
    t18 = time.perf_counter()
    prime_prof = {}
    prime_phases(dev, prime_prof)
    pp = prime_prof["prime phases"]
    groups = {g: [round(v["cycles_share"], 4),
                  None if v["simt"] is None else round(v["simt"], 3),
                  None if v["evals_per_hit"] is None
                  else round(v["evals_per_hit"], 2)]
              for g, v in pp["phases"]["groups"].items()}
    log(f"  prime_tile {pp['ms']:.4f} ms ({pp['ms_profiled']:.4f} profiled), "
        f"{pp['evals']} SDF evaluations profiled (the plain version "
        f"{pp['plain_evals']}); SM clock {pp['sm_clock_ghz']:.4f} GHz; "
        f"cycles per warp {json.dumps(pp['warp_cycles'])}; the slowest warp "
        f"{pp['slowest_warp_ms']:.4f} ms, its rays alone "
        f"{pp['slowest_warp_alone_ms']:.4f} ms; most steps in a warp "
        f"{json.dumps(pp['max_warp_steps'])}; per phase group [cycle share, "
        "SIMT efficiency, steps or evaluations per ray]: "
        + json.dumps(groups))
    log(f"  prime_tile: {pp['coarse_rays']} coarse rays in {pp['blocks']} "
        f"blocks, {pp['bytes']} bytes of shared memory and "
        f"{pp['blocks_per_sm']} blocks resident per SM, {pp['waves']:.3f} "
        f"waves; ptxas {json.dumps(pp['ptxas'])}")
    log(f"phase 18: the priming kernel's phase profile on primed c3 at "
        f"1920x1080 ({time.perf_counter() - t18:.1f} s) on {smi}")

    # -- phase 19 -----------------------------------------------------------
    capped = capped_residual(dev, smi)

    # -- phase 20 -----------------------------------------------------------
    golden_phase(dev, smi)

    # -- phase 21 -----------------------------------------------------------
    sharded = sharding_phase(dev, smi)

    # -- phase 22 -----------------------------------------------------------
    benched = bench_phase(dev, smi, {k: v.numpy() for k, v in hits3.items()})

    # -- phase 23 -----------------------------------------------------------
    crowd_split = crowd_mesh_phase(dev, smi)

    # -- phase 24 -----------------------------------------------------------
    limits = limits_phase(dev, smi)

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    # the fused kernel: times per 1080p frame in value_exact mode, the
    # error the largest over every buffer of phases 2 and 4; the split
    # kernels: times per 1080p frame of c4 in `ao` mode (all calls of frame
    # 0 of phase 7's pass, each cut and launched back to back alone;
    # pass_ms the whole pass's over its frames), launches per pass over
    # both modes
    # of phase 6, errors over phases 5, 7 and 8 and (K1, K2) the fit steps
    # held in phase 14, K1 and K2 also their time and bound in one 1080p
    # fit step (phase 14); the crowd instantiation:
    # crowd_demo `config` per 1080p frame, launches of phase 9, errors over
    # phases 8 and 9; the priming kernel: the 1080p frame of phase 10,
    # launches of its 16-frame primed main path (KF's count that KF launch
    # too); K1
    # and K2 also count the fit's launches (phase 14); the split kernels
    # also count the sharded paths' launches and errors (phase 21); KF,
    # its crowd instantiation and the split kernels also count the
    # launches of the benchmark harness and the workload matrix and the
    # errors of their frames against the plain versions (phase 22); KF and
    # its crowd instantiation also count compile_scaling's launches (phase
    # 24), and every kernel the errors of phase 24's checks; the probe's
    # entries: one launch at the tool's defaults (unroll 4), launches of
    # its sweep
    kernels = [{
        "name": "frame_fused", "route": "cuda",
        "source": "surfjax_torch/kernels/csrc/kf_staged.cu",
        "replaces": "surfjax/kernels/render_tile.py:2196",
        "launches": main_launches + kf_primed_launches
        + benched["launches"]["frame_fused"]
        + limits["launches"]["frame_fused"],
        "max_abs_err": max(max_err, benched["err"]["frame_fused"],
                           limits["err"].get("frame_fused", 0.0)),
        "ms": per_frame["value_exact"][0],
        "plain_ms": per_frame["value_exact"][1],
        "bound_ms": kf_bound[0], "bound_by": kf_bound[1],
        "library_ms": None,
        # its KF_WIDE build: compile_scaling's per-object rows (phase 24),
        # the kernel alone per 1080p frame on 129 objects, AO off and on
        "wide_launches": limits["wide_launches"],
        "wide_ms": limits["wide_ms"], "wide_ao_ms": limits["wide_ao_ms"]}, {
        # the fused kernel's instantiation with the crowd's member loops
        "name": "frame_fused_crowd", "route": "cuda",
        "source": "surfjax_torch/kernels/csrc/frame_fused.cu",
        "replaces": "surfjax/kernels/render_tile.py:1013",
        "launches": crowd_launches + benched["launches"]["frame_fused_crowd"]
        + limits["launches"]["frame_fused_crowd"],
        "max_abs_err": max(crowd_err, benched["err"]["frame_fused_crowd"],
                           limits["err"].get("frame_fused_crowd", 0.0)),
        "ms": crowd_frame[0], "plain_ms": crowd_frame[1],
        "bound_ms": crowd_bound[0], "bound_by": crowd_bound[1],
        "library_ms": None,
        # its KF_WIDE build per 1080p frame on crowd 120+8+70 (phase 24)
        "wide_ms": limits["wide_crowd_ms"]["no_ao"],
        "wide_ao_ms": limits["wide_crowd_ms"]["ao"]}, {
        "name": "prime_tile", "route": "cuda",
        "source": "surfjax_torch/kernels/csrc/prime_tile.cu",
        "replaces": "surfjax/kernels/render_tile.py:634",
        "launches": prime_launches,
        "max_abs_err": max(prime_err, limits["err"].get("prime_tile", 0.0)),
        "ms": prime_stats["prime_tile_ms"],
        "plain_ms": prime_stats["plain_ms"],
        "bound_ms": prime_bound[0], "bound_by": prime_bound[1],
        "library_ms": None}]
    sources = {"render_tile": ("split_staged.cu", "render_tile.py:2005"),
               "trace_rays": ("split_staged.cu", "render_tile.py:2037"),
               "ao_fix": ("ao_fix_staged.cu", "render_tile.py:1954"),
               "mesh_tile": ("mesh_tile.cu", "mesh_tile.py:348"),
               "mesh_candidates": ("mesh_candidates.cu", "mesh_tile.py:59")}
    for name in split:
        st7 = per_kernel["ao"][name]
        b = bound(st7["ops"], st7["bytes"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"surfjax_torch/kernels/csrc/{sources[name][0]}",
            "replaces": f"surfjax/kernels/{sources[name][1]}",
            "launches": sum(c[name] for c in mesh_launches.values())
            + fit_launches.get(name, 0) + capped["launches"].get(name, 0)
            + sharded["launches"].get(name, 0)
            + benched["launches"][name],
            "max_abs_err": max(split_err[name],
                               capped["err"].get(name, 0.0),
                               sharded["err"].get(name, 0.0),
                               benched["err"][name],
                               limits["err"].get(name, 0.0)),
            "ms": st7["ms"],
            "plain_ms": st7["plain_ms"], "bound_ms": b[0], "bound_by": b[1],
            "library_ms": None, "pass_ms": st7["pass_ms"]})
        if name in fit_stats:
            f_ = fit_stats[name]
            fb_ = bound(f_["ops"], f_["bytes"])
            kernels[-1].update(fit_ms=f_["ms"], fit_bound_ms=fb_[0],
                               fit_bound_by=fb_[1])
        if name in capped["ms"]:
            # c3 1080p, mc=32 sc=16: the capped launch and its re-run
            kernels[-1].update(capped["ms"][name])
    # the split kernels' crowd instantiations: per frame of the crowd-mesh
    # pass at 1080p in `config` mode (every call, frames 0 and 15 each cut
    # and launched back to back alone, halved; pass_ms the whole pass's
    # over its frames), launches of phase 23's main path, errors
    # over phases 8, 19 and 23 (phases 8 and 23 also against the masked
    # plain versions); the bound counts the culled algorithm
    for name in CROWD_SPLIT:
        f_ = crowd_split["frame"]["config"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "surfjax_torch/kernels/csrc/" + (
                "ao_fix_crowd.cu" if name == "ao_fix_crowd"
                else "split_path.cu"),
            "replaces": "surfjax/kernels/"
                        + sources[name.replace("_crowd", "")][1],
            "launches": crowd_split["launches"][name],
            "max_abs_err": max(split_err.get(name, 0.0),
                               capped["err"].get(name, 0.0),
                               crowd_split["err"][name],
                               limits["err"].get(name, 0.0)),
            "ms": f_["ms"], "plain_ms": f_["plain_ms"],
            "bound_ms": f_["bound_ms"], "bound_by": f_["bound_by"],
            "library_ms": None, "pass_ms": f_["pass_ms"]})
    for entry, info in probe.items():
        kernels.append({
            "name": entry, "route": "cuda",
            "source": "surfjax_torch/kernels/csrc/fp32_peak"
                      + ("_fma.cu" if info["fma"] else ".cu"),
            "replaces": "tools/vpu_peak.py:264",
            "launches": probe_launches[entry], "max_abs_err": info["err"],
            "ms": info["ms"], "plain_ms": info["plain_ms"],
            "bound_ms": info["bound"][0], "bound_by": info["bound"][1],
            "library_ms": None,
            **({"issue_bound_ms": info["issue_bound"]}
               if "issue_bound" in info else {})})
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
