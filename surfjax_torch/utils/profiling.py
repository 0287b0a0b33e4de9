"""Tracing hooks (SURVEY.md §5.1), the counterpart of
`surfjax/utils/profiling.py`: `trace_render(dir)` profiles whatever runs
inside it with torch.profiler and writes a Chrome trace into `dir`;
`annotate(name)` names a stage of the program in that trace (a
record_function range, on the same clock as the kernels it launches).
Under `torch.autograd.profiler.emit_nvtx()` the same ranges become NVTX
ranges for Nsight. With no profiler running, `annotate` records nothing
and costs one check of the profiler's state."""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch

_profiling = torch._C._autograd._profiler_enabled


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


class annotate:
    """A named span of the program: `with annotate("x"): ...` around a
    block, or `@annotate("x")` on a whole function (which keeps its name,
    docstring and attributes). The span is a record_function range when
    the torch profiler is recording as the block or call starts, and
    nothing otherwise. A `with` takes a fresh object each time."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            r, self._range = self._range, None
            r.__exit__(*exc)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _profiling():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return spanned
