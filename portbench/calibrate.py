"""The readings that each cell's check limits are set from, on the card.

    python -m portbench.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2]

In one process, after one set-up: for each seed a short window of the
cell's own calls and the run's own sample, the program's numbers against
the plain reference (the lower readings); for each control seed the same
sample with the reference computed in bfloat16 put in the program's place
(the control, whose numbers are the upper readings). One JSON line per
reading, then the largest program reading and the smallest control
reading of each number. The benchmark's runs never run this.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402


def control_values(bench, w) -> dict:
    """The reference in bfloat16 at the window's sampled pixels."""
    return bench.reference(w.slots, dtype=torch.bfloat16)


def readings(bench, seeds, control_seeds, seconds: float):
    from portbench import check
    out = []
    for kind, ss in (("program", seeds), ("control", control_seeds)):
        for seed in ss:
            w = bench.window(seed, seconds, time.perf_counter())
            t = time.perf_counter()
            ref = bench.reference(w.slots)
            ref_s = time.perf_counter() - t
            vals = bench.program_values(w.slots) if kind == "program" \
                else control_values(bench, w)
            row = {"kind": kind, "seed": seed, "calls": w.calls,
                   "sampled_calls": len(w.slots),
                   "pixels": int(sum(len(s.pix) for s in w.slots)),
                   "reference_s": ref_s,
                   "numbers": check.numbers(vals, ref)}
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


def summary(rows) -> dict:
    from portbench.check import NAMES
    res = {}
    for name in NAMES:
        prog = [r["numbers"][name] for r in rows if r["kind"] == "program"]
        ctrl = [r["numbers"][name] for r in rows if r["kind"] == "control"]
        res[name] = {"lower": max(prog) if prog else None,
                     "upper": min(ctrl) if ctrl else None}
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args(sys.argv[1:] if argv is None else argv)
    from portbench import harness, spec
    cell = spec.cell(a.workload)
    harness.require_cards(cell.chips)
    bench = harness.Bench(cell)
    ints = lambda s: [int(x) for x in s.split(",") if x]
    rows = readings(bench, ints(a.seeds), ints(a.control_seeds), a.seconds)
    print(json.dumps({"workload": a.workload, "summary": summary(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
