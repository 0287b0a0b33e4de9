"""The port's benchmark: one run of one cell.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is a `workloads` entry of
BENCHMARK.json; its configuration, traffic, check and metric readers are
files under portbench/ found by name (portbench/README.md). The run needs
as many CUDA devices as the cell asks for and fails without them. It sets
up the cell (the inputs from the configuration file and the seed, the
kernels built or loaded from the checkout's build directory, every shape
of the cell warmed up), drives the cell's entry in a closed loop for
`--seconds`, checks a sample of the window's output against the plain
reference, and prints one JSON line last on standard output:
with --trace 0 the cell's end-to-end metrics, with --trace 1 its
per-layer metrics from a torch.profiler trace of the window.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()   # the start of set-up (setup_s)

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

EXIT_NO_CARD, EXIT_FORBIDDEN = 3, 4


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def gpu_line() -> str:
    """The card's name and power limit as nvidia-smi reports them, or what
    went wrong."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0]


def device_line(peak_bytes: int, chips: int, trace=None) -> dict:
    import torch
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": peak_bytes,
           "nvidia_smi": gpu_line()}
    if trace is not None:
        out["busy_s"] = trace.busy_s
        out["window_s"] = trace.window_s
    return out


def metrics_of(entries, kind: str, source) -> dict:
    """Each metric entry's reader applied to `source`; a reader that finds
    nothing (None) leaves its metric out."""
    from portbench import spec
    out = {}
    for m in entries:
        v = spec.reader(m["name"], kind).read(source)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def report_forbidden(when: str) -> bool:
    from portbench.harness import forbidden_modules
    bad = forbidden_modules()
    if bad:
        print(f"{when}: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
    return bool(bad)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    from portbench import spec
    cell = spec.cell(args.workload)
    t_import = time.perf_counter()
    from portbench import harness
    t_import = time.perf_counter() - t_import
    try:
        harness.require_cards(cell.chips)
    except harness.NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return EXIT_NO_CARD
    bench = harness.Bench(cell)
    if report_forbidden("after set-up"):
        return EXIT_FORBIDDEN
    w = bench.window(args.seed, args.seconds, T_PROCESS, trace=bool(args.trace))
    if report_forbidden("after the window"):
        return EXIT_FORBIDDEN
    print("set-up: " + "; ".join(
        f"{what} {sec:.3f} s" for what, sec in
        [("imports", t_import)] + bench.setup_steps), file=sys.stderr)
    print(f"{cell.name}: {w.calls} calls, {w.frames} frames in "
          f"{w.window_s} s; set-up {w.setup_s} s; sampled "
          f"{len(w.slots)} calls", file=sys.stderr)
    breakdown = None
    if args.trace:
        from portbench.trace import breakdown as make_breakdown
        t = time.perf_counter()
        metrics = metrics_of(cell.per_layer, "metrics", w.trace)
        breakdown = make_breakdown(w.trace)
        print(f"trace: read in {time.perf_counter() - t} s", file=sys.stderr)
    else:
        metrics = metrics_of(cell.end_to_end, "end_to_end", w)
    device = device_line(w.peak_bytes, cell.chips, w.trace)
    w.trace = None
    t = time.perf_counter()
    verdict = bench.check(w)
    print(f"check: the reference took {time.perf_counter() - t} s; the run "
          f"{time.perf_counter() - T_PROCESS} s so far", file=sys.stderr)
    # a call that raises ends the run without a result: none fails quietly
    result = {"correct": verdict["correct"], "attempted": w.calls,
              "failed": 0, "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": j["value"], "limit": j["limit"]}
                        for k, j in verdict["judged"].items()}
    # the readers and the reference ran after the window: look again
    if report_forbidden("before the result"):
        return EXIT_FORBIDDEN
    print(f"check: {verdict['pixels']} pixels of {verdict['calls']} calls "
          f"against the reference", file=sys.stderr)
    for k, j in verdict["judged"].items():
        print(f"check {k} {j['value']!r} limit {j['limit']!r} "
              f"{'ok' if j['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
