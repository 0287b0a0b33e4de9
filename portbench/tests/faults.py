"""The faults the tests plant under the timed path (one card, so no
exchange between cards to leave out):

  stale   every call returns the frames of a call made before the window
          (state unchanged)
  half    half of each call's frames are not rendered: the other half's
          frames stand in for them
  altered every call's rgb is off by 0.05 where it is produced
"""

import torch

from portbench import traffic

FAULTS = ("stale", "half", "altered")


def plant_fault(bench, fault: str) -> None:
    """Break the timed path under `bench` with `fault`, and make the call
    whose frames a stale path keeps, at the configuration's own pose."""
    entry = bench.traffic["entry"]
    inner = bench.entries[entry]
    first = []

    def broken(*args, **kw):
        fb = inner(*args, **kw)
        if fault == "stale":
            first[:] = first or [fb]
            return first[0]
        if fault == "altered":
            return fb._replace(rgb=fb.rgb + 0.05)
        if fault == "half":
            n = fb.hit.shape[0] // 2
            return type(fb)(*(torch.cat([t[n:], t[n:]]) for t in fb))
        raise ValueError(fault)
    bench.entries[entry] = broken
    bench.call(*traffic.warmup_call(bench.traffic, bench.R, bench.pos))
