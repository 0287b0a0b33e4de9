"""Tracing hooks (SURVEY.md §5.1), the counterpart of
`surfjax/utils/profiling.py`: `trace_render(dir)` profiles whatever runs
inside it with torch.profiler and writes a Chrome trace into `dir`;
`annotate(name)` names a stage in that trace, and on the card also in an
NVTX range. Neither costs anything when unused."""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace_render(profile_dir):
    """Profile a render, host and CUDA activity:
    `with trace_render("prof"): render(...)` writes
    prof/trace_<pid>_<ns>.json (chrome://tracing, Perfetto). No directory
    (None or "") -> nothing is profiled."""
    if not profile_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named scope for a pipeline stage: a record_function range in the
    profiler's trace, and an NVTX range when a card is present."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield
