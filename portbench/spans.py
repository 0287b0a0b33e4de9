"""The program's own spans in a traced window, for the readers of
portbench/metrics/ that select by span.

The program marks its layers with record_function ranges named
`surfjax_torch.<span>` (surfjax_torch/utils/profiling.annotate): the call
(`render_sequence`, `render_frame`), each `pass`, the glue (`rays`,
`primary`, `merge`, `lights`, `visibility`, `mesh_candidates`, `shade`,
`outputs`, `prime`) and each kernel wrapper (`kernel.kf`, `kernel.k1`,
...). They are host events of the Trace, on the profiler's clock.

`of(trace)` puts each device operation of the window under the program
spans that were open when it was launched, outermost first. The Trace
keeps no correlation ids, and the hand kernels (launched from the port's
own libraries) carry none in the profiler's trace either, so an
operation is matched with its launch by order: the program and the harness launch on one stream, which runs its
operations in the order they were launched, so the k-th kernel of the
window is the k-th kernel launch on the host (cudaLaunchKernel and its
kin), the k-th copy the k-th cudaMemcpy* call and the k-th fill the k-th
cudaMemset* call. Where the counts of a kind differ, its operations are
counted in `unmatched` and carry no span. (The device's timestamps may
lead the host's by a few microseconds, so an operation that starts at
once can seem to start before its launch; the order holds regardless.) The idle gaps of the device and the host's waits on it are put
under the spans that cover them. Program spans are found in one sweep
over the events sorted by start, each query costing a push or a pop.

A trace with no program span (a program without them) gives None, and the
readers then report nothing.

    python -m portbench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell's traced window as `portbench.run --trace 1` does and writes
the whole split by span to build/spans/spans_<cell>.json (`--out` names
another directory): device ms per frame under each span (with its inner
spans, and as the innermost), the idle gaps and the syncs by innermost
span, and the match checked against the profiler's correlation ids.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

from portbench.accounting import gaps

PREFIX = "surfjax_torch."
ROOT = PREFIX + "render_sequence"
# host runtime calls that wait for the device
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def launch_kind(name: str) -> Optional[str]:
    """The kind of device operation a host runtime call enqueues, or None."""
    if name.startswith(("cudaLaunch", "cuLaunch")):
        return "kernel"
    if name.startswith(("cudaMemcpy", "cuMemcpy")):
        return "copy"
    if name.startswith(("cudaMemset", "cuMemset")):
        return "fill"
    return None


def op_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "fill"
    return "kernel"


def stacks_at(spans, times) -> List[Tuple[str, ...]]:
    """The names of the spans open at each of `times` (sorted), outermost
    first; spans (start, end, name) sorted by start, properly nested. Each
    entry of the stack holds its span's end and the path to it."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            start, end, name = spans[i]
            while stack and stack[-1][0] <= start:
                stack.pop()
            stack.append((end, (stack[-1][1] if stack else ()) + (name,)))
            i += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        out.append(stack[-1][1] if stack else ())
    return out


def _interned(paths):
    seen = {}
    return [seen.setdefault(p, p) for p in paths]


def _paths(spans, at) -> List[Tuple[str, ...]]:
    """The spans open at each time of `at` (None: no span), in the order
    of `at`."""
    known = sorted((k for k in range(len(at)) if at[k] is not None),
                   key=lambda k: at[k])
    out = [()] * len(at)
    paths = _interned(stacks_at(spans, [at[k] for k in known]))
    for k, p in zip(known, paths):
        out[k] = p
    return out


@dataclasses.dataclass
class Spans:
    ops: List[Tuple[str, ...]]    # per trace.device op, outermost first
    spans: list                   # (start, end, name), sorted by start
    syncs: List[Tuple[str, ...]]  # per wait on the device inside a span
    # the device's idle gaps (start, end, the spans open at its middle)
    gaps: List[Tuple[float, float, Tuple[str, ...]]]
    unmatched: int                # operations left without a span (_match)

    def under(self, trace, span: str):
        """trace.device's operations launched inside `span`."""
        inside = {p: span in p for p in set(self.ops)}
        return [o for o, p in zip(trace.device, self.ops) if inside[p]]

    def idle_in(self, span: str) -> float:
        """Seconds of the device's idle gaps that lie inside `span`."""
        iv = [(s, e) for s, e, n in self.spans if n == span]
        starts = [s for s, _e in iv]
        total = 0.0
        for gs, ge, _p in self.gaps:
            # the spans of one name do not overlap: back from the last
            # that starts before the gap ends, while they end after it
            # starts
            j = bisect.bisect_right(starts, ge) - 1
            while j >= 0 and iv[j][1] > gs:
                total += max(0.0, min(ge, iv[j][1]) - max(gs, iv[j][0]))
                j -= 1
        return total


def _match(device_ops, launches):
    """Per kind, the k-th operation to the k-th launch (sorted starts) ->
    ({id(op): launch start}, the operations left without one). A kind
    whose counts differ (a record the profiler lost) is left unmatched
    whole: by order, one lost record would shift every later match."""
    by_kind: Dict[str, list] = {}
    for o in sorted(device_ops, key=lambda o: o.start):
        by_kind.setdefault(op_kind(o.name), []).append(o)
    out, unmatched = {}, 0
    for kind, ops in by_kind.items():
        ls = launches.get(kind, [])
        if len(ls) != len(ops):
            unmatched += len(ops)
            continue
        out.update((id(o), t) for o, t in zip(ops, ls))
    return out, unmatched


def of(trace) -> Optional[Spans]:
    """The program's spans of a Trace, computed once per trace; None when
    it holds none."""
    cached = trace.__dict__.get("_program_spans", False)
    if cached is not False:
        return cached
    lo, hi = trace.window
    spans, launches, syncs = [], {}, []
    for o in trace.host:
        if o.name.startswith(PREFIX):
            spans.append((o.start, o.end, o.name))
        elif lo <= o.start <= hi:
            kind = launch_kind(o.name)
            if kind is not None:
                launches.setdefault(kind, []).append(o.start)
            if o.name in SYNCS:
                syncs.append(o.start)
    result = None
    if spans:
        spans.sort(key=lambda s: (s[0], -s[1]))
        for ls in launches.values():
            ls.sort()
        matched, unmatched = _match(trace.device + trace.harness, launches)
        ops = _paths(spans, [matched.get(id(o)) for o in trace.device])
        syncs.sort()
        sync_paths = [p for p in stacks_at(spans, syncs) if p]
        idle = gaps([(o.start, o.end) for o in trace.device + trace.harness],
                    lo, hi)
        gap_paths = stacks_at(spans, [0.5 * (s + e) for s, e in idle])
        result = Spans(ops=ops, spans=spans, syncs=_interned(sync_paths),
                       gaps=[(s, e, p) for (s, e), p in zip(idle, gap_paths)],
                       unmatched=unmatched)
    trace.__dict__["_program_spans"] = result
    return result


def ms_per_frame_under(trace, span: str) -> Optional[float]:
    """Device milliseconds per frame of the operations launched inside
    `span`; None without program spans or without such operations."""
    sp = of(trace)
    if sp is None:
        return None
    return trace.ms_per_frame(sp.under(trace, span))


# --- the whole split by span, on the card -----------------------------------

def split(trace) -> dict:
    """Every span's device ms per frame (with its inner spans and as the
    innermost), the idle gaps and syncs by innermost span, the device time
    with no program span."""
    sp = of(trace)
    if sp is None:
        return {}
    per_frame = 1e3 / trace.frames
    inclusive, innermost, ops_of = {}, {}, {}
    for o, p in zip(trace.device, sp.ops):
        leaf = p[-1] if p else "(no program span)"
        innermost[leaf] = innermost.get(leaf, 0.0) + o.seconds
        for name in set(p):
            inclusive[name] = inclusive.get(name, 0.0) + o.seconds
        kinds = ops_of.setdefault(leaf, {})
        kinds[o.name[:80]] = kinds.get(o.name[:80], 0.0) + o.seconds
    idle, syncs = {}, {}
    for s, e, p in sp.gaps:
        leaf = p[-1] if p else "(no program span)"
        idle[leaf] = idle.get(leaf, 0.0) + (e - s)
    for p in sp.syncs:
        syncs[p[-1]] = syncs.get(p[-1], 0) + 1
    device_s = sum(o.seconds for o in trace.device)
    scale = lambda d, f: {k: v * f for k, v in
                          sorted(d.items(), key=lambda kv: -kv[1])}
    return {
        "frames": trace.frames, "window_s": trace.window_s,
        "busy_s": trace.busy_s, "device_s": device_s,
        "unmatched_ops": sp.unmatched,
        "no_span_share": innermost.get("(no program span)", 0.0) / device_s
        if device_s else 0.0,
        "ms_per_frame": scale(inclusive, per_frame),
        "innermost_ms_per_frame": scale(innermost, per_frame),
        "innermost_top_ops_ms_per_frame": {
            k: dict(list(scale(v, per_frame).items())[:6])
            for k, v in ops_of.items()},
        "idle_ms_per_frame": scale(idle, per_frame),
        "idle_in_root_ms_per_frame": sp.idle_in(ROOT) * per_frame,
        "syncs_per_frame": scale(syncs, 1.0 / trace.frames),
    }


def correlated(prof, trace) -> dict:
    """The same attribution through the profiler's correlation ids,
    against of(trace): a device operation's linked correlation id is that
    of its launch on the host, whose start is taken. The hand kernels,
    launched from the port's own libraries, carry none. -> the operations,
    those with an id, and among those the ones whose spans differ (and
    their device seconds)."""
    from torch.autograd import DeviceType

    from portbench.trace import _ns
    host_at, device = {}, {}
    for e in prof.profiler.kineto_results.events():
        corr = e.linked_correlation_id()
        if not corr:
            continue
        if e.device_type() == DeviceType.CUDA:
            device[(e.name(), _ns(e, "start"))] = corr
        else:
            t = _ns(e, "start")
            host_at[corr] = min(t, host_at.get(corr, t))
    sp = of(trace)
    at = [host_at.get(device.get((o.name, o.start))) for o in trace.device]
    truth = _paths(sp.spans, at)
    differ = [k for k, p in enumerate(truth)
              if at[k] is not None and p != sp.ops[k]]
    return {"ops": len(truth),
            "with_correlation": sum(1 for t in at if t is not None),
            "differ": len(differ),
            "differ_s": sum(trace.device[k].seconds for k in differ),
            "differ_examples": [[trace.device[k].name[:60], truth[k],
                                 sp.ops[k]] for k in differ[:5]]}


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import sys
    import time

    from portbench import harness, spec
    from portbench import trace as trace_mod
    p = argparse.ArgumentParser(prog="python -m portbench.spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=os.path.join("build", "spans"))
    args = p.parse_args(argv)
    t_process = time.perf_counter()
    cell = spec.cell(args.workload)
    harness.require_cards(cell.chips)
    bench = harness.Bench(cell)
    kept = {}

    def keep(prof, frames):
        kept["prof"] = prof
        return trace_mod.from_profile(prof, frames)

    harness.from_profile = keep
    w = bench.window(args.seed, args.seconds, t_process, trace=True)
    t = time.perf_counter()
    of(w.trace)
    out = {"cell": cell.name, "seed": args.seed, "calls": w.calls,
           "attribution_s": time.perf_counter() - t,
           "metrics": {m["name"]: spec.reader(m["name"]).read(w.trace)
                       for m in cell.per_layer},
           "split": split(w.trace),
           "correlated": correlated(kept.pop("prof"), w.trace),
           "breakdown": trace_mod.breakdown(w.trace)}
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"spans_{cell.name}.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out), file=sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
