"""What the card sustains on the Mandelbulb orbit update: the FP32 roofline
probe (counterpart of `tools/vpu_peak.py`).

    python -m surfjax_torch.tools.fp32_peak [--iters 512] [--rows 256]
        [--grid 64] [--repeats 5] [--unroll 1,4,8]

Synthetic kernels (kernels/csrc/fp32_peak.cu) run over grid*rows*128
float32 lanes, everything in registers, no divergence (the mixes: one orbit
per thread, in blocks of MIX_BLOCK = 64 threads):

  bulb_mix  K substeps of the expanded ("std") power-8 orbit update, on
            seeds uniform in [0.1, 0.3]^3 (numpy default_rng(0)) that never
            reach the bailout of 64; out = (wx + wy) + (wz + dz) + m;
  cheb_mix  the same with the restructured ("cheb") update, the default of
            RenderSettings.bulb_iter;
  fma_dep   the TPU tool's dependent a = fma(a, b, c) chain, b = 0.999 a0
            and c = 1e-6 a0 per lane, K scaled by 32: the sanity check of
            the method. Each of its FMAs reads three registers of its own.

The two mixes run `bulb_substep` of frame_fused.cuh, the function the render
kernels' DE loop runs, built like them with -fmad=false (every multiply and
add rounds on its own) and once more with -fmad=true (`*_fma` rows: the
compiler may contract a*b+c), which prices the contraction the render
kernels forgo. `unroll` is the number of substeps per loop trip (mixes) or
of independent chains per thread (fma_dep).

Timing is differential, as in the TPU tool: each kernel is timed with CUDA
events at K and at 2K iterations, interleaved, and the cost of K iterations
is min(t_2K) - min(t_K), which cancels the launch and the 16 bytes a lane
moves; a difference that is not positive is reported as nan, never as a
rate. An fma_dep reading above 105% of the data-sheet FP32 peak, or a mix
faster per operation than the best fma_dep row, means the measurement is
broken: the tool raises instead of printing it.

Operations of one substep, counted by hand from `bulb_substep` with equal
subexpressions counted once (the compiler merges them) and an IEEE division
and a square root counted as 1 each, as the TPU tool counts its rsqrt:
  shared by both forms: escape test 1; m2, m4 2; dz_new = 8*((m4 *
  (1/sqrt(max(m, 1e-30)))) * dz) + 1: 7; x2, y2, z2, y4 4; k3 1; k3s 1;
  k37 (k3s^2 once) 4; k2 = 1/sqrt(k37) 2; k4 2; m = (wx^2 + wy^2) + wz^2
  5 => 29.
  cheb: t13 2; k1 3; a1 1; b1 2; a2 3; b2 2; re8 3; im8 2; s8 4; wx 2;
  wy 7; wz 2 => 33, so 62 per substep.
  std: x4, z4 2; k1 11; wx 13 (x2*z2 shared with k1); wy 7; wz 19 => 52,
  so 81 per substep.
`render_tile.BULB_ITER_OPS` holds these two numbers, so that the rate
printed here and the operation bound of the render kernels speak of the
same operations; the rate under the flat 60 that the bounds used before is
printed beside it. fma_dep counts 2 per iteration. Under -fmad=false every
one of them is an instruction of its own, while 67 Tflop/s counts an FMA as
two operations: no such kernel can pass half of that operations bound. The
bound the mixes do meet is the issue bound (issue_bound: the instructions
of the loop's fast path, from the SASS, over the SM's issue slots at the
measured clock), which `breakdown.py probe_phases` prints beside the time
with the profiling instantiation's clock, cycles and finish times
(profile_launcher, profile_table).

Needs one CUDA card; prints the card's name and power limit first and one
JSON line last.
"""

from __future__ import annotations

import argparse
import bisect
import ctypes
import json
import re
import sys

import numpy as np
import torch

from surfjax_torch.core.math import f32
from surfjax_torch.engines.sdf import _bulb_orbit, _new_w_cheb, _new_w_std

FP32_PEAK_TFLOPS = 67.0    # NVIDIA H100 SXM data sheet, at the 700 W limit
FMA_K_SCALE = 32           # fma_dep runs this many times the mixes' K
FORMER_BULB_ITER_OPS = 60  # the flat estimate earlier operation bounds used
BAILOUT2 = 64.0
MIXES = ("bulb_mix", "cheb_mix")
CHAINS = ("fma_dep",)
KINDS = MIXES + CHAINS
UNROLLS = (1, 4, 8)
DEFAULT_ITERS, DEFAULT_ROWS, DEFAULT_GRID, DEFAULT_REPEATS = 512, 256, 64, 5
# threads per block of the mixes (FP_MIX_BLOCK): smaller blocks than the
# first port's 256 shorten the tail of the last ones (PERF.md §6, PR 18)
MIX_BLOCK = 64
PROF_WORDS = 4      # a warp's profile record (FP_PROF_WORDS)


def ops_per_iter(kind: str) -> int:
    from surfjax_torch.kernels.render_tile import BULB_ITER_OPS
    return {"bulb_mix": BULB_ITER_OPS["std"],
            "cheb_mix": BULB_ITER_OPS["cheb"], "fma_dep": 2}[kind]


def seeds(rows: int, grid: int, device):
    """The TPU tool's orbit seeds: three (grid*rows, 128) float32 arrays
    uniform in [0.1, 0.3], drawn in its order from numpy's default_rng(0)."""
    rng = np.random.default_rng(0)
    shape = (grid * rows, 128)
    return tuple(torch.as_tensor(
        rng.uniform(0.1, 0.3, shape).astype(np.float32), device=device)
        for _ in range(3))


def fp32_peak_reference(kind: str, px, py, pz, iters: int):
    """Plain version of the probe's kernels -> out, shaped like px.

    The mixes run the DE loop of engines/sdf.py::_bulb_while_driver
    (`_bulb_orbit`: its `new_w` and its dz and m updates, a lane frozen
    once m > 64) and return (wx + wy) + (wz + dz) + m. fma_dep returns
    K times a = fma(a, b, c), py and pz unused, with b = 0.999 a0 and
    c = 1e-6 a0; the fused value is computed in float64 and rounded to
    float32. a*b is exact in
    float64 and the sum rounds once there, so the second rounding can
    differ from the fused result only when the float64 sum lands within
    2^-29 of a float32 rounding boundary: 1 ULP, on a small share of the
    steps."""
    if kind in CHAINS:
        a = px
        b = (a * f32(0.999)).double()
        c = (a * f32(1e-6)).double()
        for _ in range(iters):
            a = (a.double() * b + c).float()
        return a
    if kind not in MIXES:
        raise ValueError(f"kind must be one of {KINDS}; got {kind!r}")
    form = _new_w_cheb if kind == "cheb_mix" else _new_w_std
    wx, wy, wz, dz, m = _bulb_orbit(px, py, pz, BAILOUT2, iters, form)
    return (wx + wy) + (wz + dz) + m


def entry_name(kind: str, fma: bool = False) -> str:
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}; got {kind!r}")
    if fma and kind in CHAINS:
        raise ValueError(f"{kind} has no contracted variant: it is a chain "
                         "of explicit fused multiply-adds")
    return f"fp_{kind}" + ("_fma" if fma else "")


def mix_grid(kind: str, fma: bool, n: int, unroll: int, profile: bool,
             dev) -> tuple:
    """-> (the grid a mix launch over n lanes takes, the blocks an SM holds
    of its instantiation, from the library: fp_mix_occupancy)."""
    from surfjax_torch.kernels import _build
    from surfjax_torch.kernels.render_tile import _raise_on
    per_sm = ctypes.c_int(0)
    name = "fp_mix_occupancy" + ("_fma" if fma else "")
    _raise_on(getattr(_build.load(), name)(
        int(kind == "cheb_mix"), unroll, int(profile), dev.index,
        ctypes.byref(per_sm)), name)
    return -(-n // MIX_BLOCK), per_sm.value


def _launcher(kind, px, py, pz, iters, unroll, fma, profile):
    from surfjax_torch.kernels import _build
    from surfjax_torch.kernels.render_tile import _raise_on
    entry = entry_name(kind, fma)
    if unroll not in UNROLLS or iters < 0 or iters % unroll:
        raise ValueError(f"unroll must be one of {UNROLLS} and divide "
                         f"iters; got unroll {unroll}, iters {iters}")
    ins = [px] if kind in CHAINS else [px, py, pz]
    dev = px.device
    for a in ins:
        if a.device != dev or a.dtype != torch.float32 or \
                a.shape != px.shape or not a.is_contiguous():
            raise ValueError(f"{entry}: need contiguous float32 tensors of "
                             f"one shape on {dev}")
    out = torch.empty_like(px)
    n = px.numel()
    lib, prof = _build.load(), None
    if kind in CHAINS:
        if n % unroll:
            raise ValueError(f"{entry}: {n} lanes do not divide into "
                             f"{unroll} chains per thread")
        fn = lib.fp_fma_dep
        args = [ctypes.c_void_p(a.data_ptr()) for a in ins + [out]] + [
            n, iters, unroll, dev.index]
    else:
        if profile:
            prof = torch.zeros((-(-n // MIX_BLOCK) * MIX_BLOCK // 32,
                                PROF_WORDS), dtype=torch.int64, device=dev)
        fn = getattr(lib, "fp_mix" + ("_fma" if fma else ""))
        args = [int(kind == "cheb_mix")] + [
            ctypes.c_void_p(a.data_ptr()) for a in ins + [out]] + [
            ctypes.c_void_p(prof.data_ptr() if profile else None), n, iters,
            unroll, dev.index]
    key = entry + ("_profile" if profile else "")

    def launch():
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            _raise_on(fn(*args, ctypes.c_void_p(stream)), entry)
        fp32_peak.launches[key] = fp32_peak.launches.get(key, 0) + 1
        return ins     # the arrays the kernel reads stay alive with launch

    return launch, out, prof


def peak_launcher(kind: str, px, py, pz, iters: int, unroll: int = 1,
                  fma: bool = False):
    """Prepare one launch of a probe kernel on CUDA tensors -> (launch,
    out): launch() enqueues the kernel on the current stream, writing
    `out`, counts itself in `fp32_peak.launches[entry]` and raises if the
    launch was refused. A mix runs one block of MIX_BLOCK threads per
    MIX_BLOCK lanes."""
    launch, out, _ = _launcher(kind, px, py, pz, iters, unroll, fma, False)
    return launch, out


def profile_launcher(kind: str, px, py, pz, iters: int, unroll: int = 1,
                     fma: bool = False):
    """A mix's profiling instantiation, prepared as peak_launcher prepares
    the kernel -> (launch, out, prof): prof holds one record per warp of
    the grid (PROF_WORDS int64: lane 0's clock64 delta over the kernel,
    its %globaltimer at the start and at the end, its SM), written by
    each launch; launches count under `<entry>_profile`."""
    if kind not in MIXES:
        raise ValueError(f"only the mixes have a profiling instantiation; "
                         f"got {kind!r}")
    return _launcher(kind, px, py, pz, iters, unroll, fma, True)


def fp32_peak(kind: str, px, py, pz, iters: int, unroll: int = 1,
              fma: bool = False):
    """One probe kernel over lanes of any shape -> out (see
    fp32_peak_reference). CUDA tensors launch the kernel, counted per entry
    in `fp32_peak.launches`; CPU tensors run the plain version (which
    rounds every operation on its own, with or without `fma`)."""
    entry_name(kind, fma)
    if px.device.type == "cpu":
        return fp32_peak_reference(kind, px, py, pz, iters)
    if px.device.type != "cuda":
        raise ValueError(f"unsupported device {px.device}")
    launch, out = peak_launcher(kind, px, py, pz, iters, unroll, fma)
    launch()
    return out


fp32_peak.launches = {}


def time_differential(launch_k, launch_2k, repeats: int):
    """-> (ms of the extra K iterations or nan, ms of one launch at K):
    both launches timed with CUDA events `repeats` times in turns, the
    minimum of each taken."""
    ms = ([], [])
    for _ in range(repeats):
        for which, launch in enumerate((launch_k, launch_2k)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch()
            end.record()
            torch.cuda.synchronize()
            ms[which].append(start.elapsed_time(end))
    t1, t2 = min(ms[0]), min(ms[1])
    return (t2 - t1) if t2 > t1 else float("nan"), t1


def check_rows(rows: dict) -> None:
    """Raise on a sweep that cannot be right: an fma_dep row above 105% of
    the data-sheet peak, or a mix doing more operations per second than
    the best fma_dep row."""
    fma = {name: r["tflops"] for name, r in rows.items()
           if name.startswith(CHAINS) and r["tflops"] == r["tflops"]}
    for name, t in fma.items():
        if t > 1.05 * FP32_PEAK_TFLOPS:
            raise RuntimeError(
                f"{name} reads {t:.2f} Tflop/s, above 105% of the card's "
                f"{FP32_PEAK_TFLOPS} Tflop/s: the measurement is broken")
    best = max(fma.values(), default=None)
    for name, r in rows.items():
        if name not in fma and best is not None and r["tflops"] > best:
            raise RuntimeError(
                f"{name} reads {r['tflops']:.2f} Tflop/s, more than the "
                f"best fma_dep row's {best:.2f}: the measurement is broken")


# Per SM and cycle on compute capability 9.0: the lanes of FP32 add,
# multiply and FMA (128), of the multi-function unit (16: reciprocal,
# reciprocal square root), of compares, min and max (64) and of integer
# add, multiply-add, logic and shifts (64) (CUDA C++ Programming Guide,
# "Arithmetic Instructions", throughput per clock cycle per multiprocessor);
# one warp instruction issued per scheduler and cycle, four schedulers per
# SM (NVIDIA H100 Tensor Core GPU Architecture white paper). Compares and
# integer work are counted as two pipes of their own, so that the bound
# stays a least time if they share one.
PIPE_LANES = {"fp32": 128, "mufu": 16, "compare": 64, "integer": 64}
ISSUE_PER_SM = 4


def mix_names(log: str) -> dict:
    """build()'s log -> {(kind, fma, unroll, prof): (the mix kernel's
    mangled name, its ptxas lines)}."""
    from surfjax_torch.kernels import _build
    out = {}
    for name, lines in _build.entries(log).items():
        m = re.search(r"fp_mix_kernel(_fma)?ILi(\d)ELi(\d)ELb([01])E", name)
        if m:
            kind = "cheb_mix" if m.group(2) == "1" else "bulb_mix"
            out[(kind, bool(m.group(1)), int(m.group(3)),
                 m.group(4) == "1")] = (name, lines)
    return out


def substep_sass(code, unroll: int) -> dict:
    """A mix kernel's SASS (`_build.sass_of`) -> its innermost loop that
    holds MUFU (the trip loop: `unroll` substeps and the loop's own
    test), its path when no orbit escapes and no IEEE division
    or square root leaves its fast path (the loop less each block that a
    forward branch skips which holds a CALL and no MUFU: the call of the
    slow path), that path's instructions per class of
    `_build.PIPE_CLASSES` per substep, and the CALLs inside
    the loop and in the whole kernel."""
    from surfjax_torch.kernels import _build
    loops = [lp for lp in _build.sass_loops(None, None, _build.PIPE_CLASSES,
                                            code) if lp["mufu"]]
    if not loops:
        raise RuntimeError("no loop with MUFU in the mix kernel's SASS")
    loop = loops[0]
    lo, hi = int(loop["start"], 16), int(loop["end"], 16)
    body = sorted((a, _build.opcode(t), t) for a, t in code
                  if lo <= a <= hi)
    addrs = [a for a, _, _ in body]
    skipped = set()
    for k, (a, _, t) in enumerate(body):
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", t)
        if not m or int(m.group(1), 16) <= a:
            continue
        block = range(k + 1, bisect.bisect_left(addrs, int(m.group(1), 16)))
        ops = [body[j][1] for j in block]
        if any(op.startswith("CALL") for op in ops) and \
                not any(op.startswith("MUFU") for op in ops):
            skipped.update(block)
    path = [op for k, (_, op, _) in enumerate(body) if k not in skipped]
    per = {"instructions": len(path) / unroll}
    for cls, names in _build.PIPE_CLASSES.items():
        per[cls] = sum(op.startswith(names) for op in path) / unroll
    per["other"] = per["instructions"] - sum(
        per[k] for k in _build.PIPE_CLASSES)
    calls = [a for a, t in code if _build.opcode(t).startswith("CALL")]
    return {"loop": loop, "path_instructions": len(path),
            "per_substep": per,
            "calls_in_loop": sum(lo <= a <= hi for a in calls),
            "calls": len(calls)}


def issue_bound(per_substep: dict, lane_iters: float, ghz: float,
                sms: int) -> dict:
    """The least time for the instructions of `lane_iters`
    iteration-lanes, `per_substep` (substep_sass) each, on `sms` SMs at
    `ghz`: per pipe the SM cycles of one warp's substep (its instructions
    over the pipe's lanes per SM and cycle x 32; issue: over ISSUE_PER_SM)
    -> {"cycles": per pipe, "bound_by", "ms", "ps_per_iter_lane"}."""
    cyc = {"issue": per_substep["instructions"] / ISSUE_PER_SM}
    cyc.update({k: per_substep[k] * 32 / lanes
                for k, lanes in PIPE_LANES.items()})
    by = max(cyc, key=cyc.get)
    ms = lane_iters / 32 * cyc[by] / (sms * ghz * 1e9) * 1e3
    return {"cycles": cyc, "bound_by": by, "ms": ms,
            "ps_per_iter_lane": ms * 1e9 / lane_iters}


def profile_table(prof, iters: int) -> dict:
    """A profile launch's records (profile_launcher: one row per warp) ->
    the SM clock under load (clock64 cycles over %globaltimer ns: over all
    warps, and per warp median, 1st and 99th percentile), cycles per
    substep per warp (a warp's cycles over K: median, min, max), the
    warps' finish times from the launch's first start (us: min, median,
    99th percentile, max), the launch's span (us), the SMs it ran on,
    warps per SM (min, max), each SM's last finish (us: min, median, max)
    and the SMs' busy share of the span."""
    rec = prof.cpu()
    t0 = int(rec[:, 1].min())
    cyc = rec[:, 0].double()
    start = (rec[:, 1] - t0).double()
    end = (rec[:, 2] - t0).double()
    ns = end - start
    per_substep = cyc / iters
    ghz = cyc[ns > 0] / ns[ns > 0]
    qs = torch.tensor([0.01, 0.5, 0.99], dtype=torch.float64)
    q_ghz = torch.quantile(ghz, qs)
    q_end = torch.quantile(end, qs)
    span = float(end.max())
    sm = rec[:, 3]
    sms = torch.unique(sm)
    per_sm_warps = torch.stack([(sm == k).sum() for k in sms])
    sm_first = torch.stack([start[sm == k].min() for k in sms])
    sm_last = torch.stack([end[sm == k].max() for k in sms])
    q_last = torch.quantile(sm_last, qs)
    return {
        "sm_clock_ghz": float(cyc.sum() / ns.sum()),
        "warp_ghz": {"p01": float(q_ghz[0]), "median": float(q_ghz[1]),
                     "p99": float(q_ghz[2])},
        "cycles_per_substep": {"median": float(per_substep.median()),
                               "min": float(per_substep.min()),
                               "max": float(per_substep.max())},
        "finish_us": {"min": float(end.min()) / 1e3,
                      "median": float(q_end[1]) / 1e3,
                      "p99": float(q_end[2]) / 1e3, "max": span / 1e3},
        "span_us": span / 1e3,
        "sms": int(sms.numel()),
        "warps_per_sm": {"min": int(per_sm_warps.min()),
                         "max": int(per_sm_warps.max())},
        "sm_last_finish_us": {"min": float(sm_last.min()) / 1e3,
                              "median": float(q_last[1]) / 1e3,
                              "max": float(sm_last.max()) / 1e3},
        "sm_busy_share": float((sm_last - sm_first).sum())
        / (sms.numel() * span) if span > 0 else float("nan")}


def run(iters: int = DEFAULT_ITERS, rows: int = DEFAULT_ROWS,
        grid: int = DEFAULT_GRID, repeats: int = DEFAULT_REPEATS,
        unrolls=UNROLLS, device="cuda") -> dict:
    """The timed sweep -> {"<kind>[_fma]@u<unroll>": {ps_per_iter_lane,
    tflops, tflops_at_60_ops (mixes), ms_extra_K, ms_launch_K}}; raises
    without a CUDA device and on a broken measurement (check_rows)."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("fp32_peak measures a CUDA card; "
                           "torch.cuda.is_available() is false or the "
                           f"device asked for is {device}")
    px, py, pz = seeds(rows, grid, device)
    lanes = float(px.numel())
    # the clocks ramp during the first launches: keep the card busy first
    warm, _ = peak_launcher("fma_dep", px, py, pz, iters * FMA_K_SCALE, 8)
    for _ in range(20):
        warm()
    torch.cuda.synchronize()
    res = {}
    for kind, fma in (("bulb_mix", False), ("bulb_mix", True),
                      ("cheb_mix", False), ("cheb_mix", True),
                      ("fma_dep", False)):
        k = iters * (FMA_K_SCALE if kind in CHAINS else 1)
        ops = ops_per_iter(kind)
        for unroll in unrolls:
            if k % unroll:
                continue
            launch_k, _ = peak_launcher(kind, px, py, pz, k, unroll, fma)
            launch_2k, _ = peak_launcher(kind, px, py, pz, 2 * k, unroll, fma)
            launch_k()
            launch_2k()
            torch.cuda.synchronize()
            dt, t_k = time_differential(launch_k, launch_2k, repeats)
            row = {"ps_per_iter_lane": dt * 1e9 / (lanes * k),
                   "tflops": ops * lanes * k / (dt * 1e-3) / 1e12,
                   "ms_extra_K": dt, "ms_launch_K": t_k}
            if kind in MIXES:
                row["tflops_at_60_ops"] = \
                    row["tflops"] * FORMER_BULB_ITER_OPS / ops
            res[f"{kind}{'_fma' if fma else ''}@u{unroll}"] = row
    check_rows(res)
    return res


def format_row(name: str, r: dict) -> str:
    former = (f" | {r['tflops_at_60_ops']:7.3f} at 60 ops"
              if "tflops_at_60_ops" in r else "")
    return (f"| {name:16s} | {r['ps_per_iter_lane']:8.3f} ps/iter-lane "
            f"| {r['tflops']:7.3f} Tflop/s{former} "
            f"| extra-K {r['ms_extra_K']:8.3f} ms "
            f"| launch {r['ms_launch_K']:8.3f} ms |")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="surfjax_torch.tools.fp32_peak")
    ap.add_argument("--iters", type=int, default=DEFAULT_ITERS)
    ap.add_argument("--rows", type=int, default=DEFAULT_ROWS)
    ap.add_argument("--grid", type=int, default=DEFAULT_GRID)
    ap.add_argument("--repeats", type=int, default=DEFAULT_REPEATS)
    ap.add_argument("--unroll", type=str, default="1,4,8",
                    help="comma list of substeps per loop trip (chains per "
                         "thread for fma_dep); the render kernels' DE loop "
                         "is not unrolled by hand: compare them with the "
                         "fastest row")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fp32_peak: torch.cuda.is_available() is false; "
                         "this tool measures a CUDA GPU")
    from surfjax_torch.tools.workload import gpu_line
    print(gpu_line(), flush=True)
    unrolls = tuple(int(u) for u in args.unroll.split(","))
    res = run(args.iters, args.rows, args.grid, args.repeats, unrolls)
    for name, r in res.items():
        print(format_row(name, r))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
