"""The traced run: torch.profiler over the window, reduced to plain lists.

The harness marks its own work with spans (record_function):
    portbench.window   the measured window, first call to last sync
    portbench.call     one call of the entry
    portbench.sync     the synchronisation that ends a call
    portbench.count    the harness's hit count of a call (ray accounting)
    portbench.sample   the harness's copy of the pixels the check compares
A per-layer reader (portbench/metrics/<name>.py) gets a Trace: the device
operations that ran inside the window, with the operations launched from
the harness's own spans (count, sample) left out, the host events, the
window's length and the frames rendered in it.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Tuple

from portbench.accounting import gaps, union_length

HARNESS_SPANS = ("portbench.count", "portbench.sample")
TOP = 10


@dataclasses.dataclass
class Op:
    name: str
    start: float           # seconds, the profiler's clock
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def kernel(self) -> bool:
        """A kernel launch, not a copy or a fill."""
        return not self.name.startswith(("Memcpy", "Memset"))


@dataclasses.dataclass
class Trace:
    device: List[Op]       # device operations in the window, harness's out
    harness: List[Op]      # those the harness's own spans launched
    host: List[Op]         # host events (operators, runtime calls, spans)
    window: Tuple[float, float]
    frames: int

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union), the
        harness's own among them."""
        return union_length([(o.start, o.end)
                             for o in self.device + self.harness],
                            *self.window)

    def matching(self, patterns) -> List[Op]:
        return [o for o in self.device if any(p in o.name for p in patterns)]

    def ms_per_frame(self, ops) -> Optional[float]:
        """Device milliseconds of `ops` per frame, None where `ops` is
        empty (a pattern that matches nothing reports nothing)."""
        if not ops:
            return None
        return sum(o.seconds for o in ops) * 1e3 / self.frames


def _ns(e, what: str) -> float:
    if hasattr(e, what + "_ns"):
        return getattr(e, what + "_ns")() * 1e-9
    return getattr(e, what + "_us")() * 1e-6


def from_profile(prof, frames: int) -> Trace:
    """A finished torch.profiler.profile -> Trace."""
    from torch.autograd import DeviceType
    host, device, harness, harness_corr = [], [], [], set()
    raw_device = []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        op = Op(e.name(), start, start + _ns(e, "duration"))
        corr = e.linked_correlation_id() if hasattr(
            e, "linked_correlation_id") else 0
        annotation = (getattr(e, "is_user_annotation", lambda: False)()
                      or op.name.startswith("portbench."))
        if e.device_type() == DeviceType.CUDA:
            if not annotation:     # spans mirrored on the device's timeline
                raw_device.append((op, corr))
        else:
            host.append((op, corr))
    spans = {n: [o for o, _c in host if o.name == n]
             for n in ("portbench.window",) + HARNESS_SPANS}
    if len(spans["portbench.window"]) != 1:
        raise RuntimeError("the trace holds no single portbench.window span")
    w = spans["portbench.window"][0]
    mine = sorted((o.start, o.end) for n in HARNESS_SPANS for o in spans[n])
    starts = [s for s, _e in mine]
    for o, corr in host:
        i = bisect.bisect_right(starts, o.start) - 1
        if corr and i >= 0 and o.end <= mine[i][1]:
            harness_corr.add(corr)
    for op, corr in raw_device:
        if op.end <= w.start or op.start >= w.end:
            continue
        (harness if corr and corr in harness_corr else device).append(op)
    return Trace(device=device, harness=harness, host=[o for o, _c in host],
                 window=(w.start, w.end), frames=frames)


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, and the idle gaps of the
    device by the host event that was running in them (the innermost one
    that covers the middle of the gap), each at most TOP entries of
    [name, seconds]."""
    per_op = {}
    for o in trace.device:
        per_op[o.name] = per_op.get(o.name, 0.0) + o.seconds
    host = sorted(trace.host, key=lambda o: o.start)
    starts = [o.start for o in host]
    per_gap = {}
    for s, e in gaps([(o.start, o.end)
                      for o in trace.device + trace.harness],
                     *trace.window):
        mid = 0.5 * (s + e)
        label = "no host event"
        i = bisect.bisect_right(starts, mid) - 1
        for k in range(i, max(i - 5000, -1), -1):
            if host[k].end >= mid:
                label = host[k].name
                break
        per_gap[label] = per_gap.get(label, 0.0) + (e - s)
    top = lambda d: [[n[:160], v] for n, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(per_op), "idle_gaps": top(per_gap)}
