"""One run of one cell: set-up, the measured window, the output check.

    bench = Bench(spec.cell(name))      # inputs built, shapes warmed up
    w = bench.window(seed, seconds)     # closed loop for `seconds`
    verdict = bench.check(w)            # the sample against the reference

The program is driven only through portbench/port.py. The reference
(portbench/reference/) runs once the window has closed, the peak memory
has been read and the program's outputs are freed.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from portbench import check as checks
from portbench import port, traffic
from portbench.accounting import rays
from portbench.reference import golden
from portbench.reference import scene as ref_scene
from portbench.trace import from_profile

BUFFERS = ("rgb", "depth", "normal", "hit", "obj_id")
# top-level module names that may not be loaded: JAX, its relatives, and
# the JAX package this port was made from (compared whole, so that
# surfjax_torch is not surfjax)
FORBIDDEN = ("jax", "jaxlib", "flax", "surfjax")
REF_BLOCK = 16384        # rays the reference renders at once


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class NoCard(RuntimeError):
    pass


def require_cards(n: int) -> None:
    """Raise NoCard unless torch sees at least n CUDA devices."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark "
                     "measures the card and does not fall back to the CPU")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell asks for {n} cards; torch sees "
                     f"{torch.cuda.device_count()}")


@dataclasses.dataclass
class Slot:
    """A sampled call: its poses, the flat pixel indices (over its frames)
    and the program's values there."""
    R: np.ndarray
    P: np.ndarray
    pix: np.ndarray
    values: dict


@dataclasses.dataclass
class Window:
    calls: int
    frames: int
    call_seconds: List[float]
    window_s: float
    rays: float
    peak_bytes: int
    setup_s: float
    slots: List[Slot]
    trace: object = None


class Bench:
    """A cell's inputs, made from its configuration and traffic files and
    handed to the program; `size` (width, height) shrinks the camera for
    tests on the CPU only."""

    def __init__(self, cell, device="cuda", size=None, warmup: int = 2):
        self.cell = cell
        cfg = copy.deepcopy(cell.config)
        if size is not None:
            cfg["camera"].update(width=int(size[0]), height=int(size[1]))
        self.cfg = cfg
        self.traffic = cell.traffic
        traffic.check(self.traffic)
        self.mode = dict(self.traffic.get("mode", {}))
        self.dev = torch.device(device)
        self.intr = ref_scene.intrinsics_of(cfg)
        self.R, self.pos = ref_scene.camera_pose(cfg)
        # (what, seconds) of each step of the set-up, for standard error
        self.setup_steps = []
        t = time.perf_counter()
        self.scene, self.camera, self.settings, self.entries = port.build(
            cfg, self.mode, self.intr, self.R)
        self.setup_steps.append(("scene", time.perf_counter() - t))
        self.ref_settings = ref_scene.settings_of(cfg, self.mode)
        self.frames_per_call = int(self.traffic["frames_per_call"])
        self.n_pixels = self.intr.width * self.intr.height
        self.sample = cell.check["sample"]
        for k in range(warmup):
            t = time.perf_counter()
            self._step(*traffic.warmup_call(self.traffic, self.R, self.pos),
                       torch.zeros((), dtype=torch.float64, device=self.dev),
                       keep=True)
            self.sync()
            self.setup_steps.append((f"warm-up call {k + 1}",
                                     time.perf_counter() - t))

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def call(self, R_flats, positions):
        """One call of the traffic's entry -> its buffers with a leading
        frame axis."""
        return self.entries["render_sequence"](
            self.scene, self.camera, (R_flats, positions), self.settings,
            device=self.dev)

    def _step(self, R, P, hits, keep: bool, pix=None):
        """A call, its hit count added to `hits`, and (keep) its values at
        the pixels `pix` -> those values or None."""
        rf = torch.profiler.record_function
        with rf("portbench.call"):
            fb = self.call(R, P)
        with rf("portbench.count"):
            hits += fb.hit.sum(dtype=torch.float64)
        if not keep:
            return None
        if pix is None:
            pix = np.arange(min(self.sample["pixels_per_call"],
                                fb.hit.numel()))
        with rf("portbench.sample"):
            idx = torch.as_tensor(pix, device=self.dev)
            return {k: getattr(fb, k).reshape(fb.hit.numel(), -1)[idx]
                    for k in BUFFERS}

    def window(self, seed: int, seconds: float, t_process: float,
               trace: bool = False) -> Window:
        """Calls back to back for `seconds`, each ended by a
        synchronisation; the sample is a reservoir of the calls, drawn from
        the seed, and of each kept call's pixels."""
        calls = traffic.calls(self.traffic, seed, self.R, self.pos)
        pick = np.random.default_rng([int(seed), 1])
        K = int(self.sample["calls"])
        S = int(self.sample["pixels_per_call"])
        N = self.frames_per_call * self.n_pixels
        hits = torch.zeros((), dtype=torch.float64, device=self.dev)
        slots, times = [], []
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
        with prof if prof is not None else contextlib.nullcontext():
            self.sync()
            setup_s = time.perf_counter() - t_process
            with torch.profiler.record_function("portbench.window"):
                start = time.perf_counter()
                i = 0
                while True:
                    R, P = next(calls)
                    slot = i if i < K else int(pick.integers(0, i + 1))
                    keep = slot < K
                    pix = np.sort(pick.choice(N, size=min(S, N),
                                              replace=False)) if keep else None
                    t0 = time.perf_counter()
                    values = self._step(R, P, hits, keep, pix)
                    with torch.profiler.record_function("portbench.sync"):
                        self.sync()
                    t1 = time.perf_counter()
                    times.append(t1 - t0)
                    if keep:
                        s = Slot(R, P, pix, values)
                        if slot < len(slots):
                            slots[slot] = s
                        else:
                            slots.append(s)
                    i += 1
                    if t1 - start >= seconds:
                        break
        peak = torch.cuda.max_memory_allocated(self.dev) \
            if self.dev.type == "cuda" else 0
        frames = i * self.frames_per_call
        w = Window(calls=i, frames=frames, call_seconds=times,
                   window_s=t1 - start,
                   rays=rays(frames, self.intr.width, self.intr.height,
                             float(hits.item()), len(self.cfg["lights"]),
                             self.ref_settings),
                   peak_bytes=int(peak), setup_s=setup_s,
                   slots=[dataclasses.replace(
                       s, values={k: v.cpu().numpy()
                                  for k, v in s.values.items()})
                       for s in slots])
        if prof is not None:
            t = time.perf_counter()
            w.trace = from_profile(prof, frames)
            print(f"trace: {len(w.trace.device)} device operations, "
                  f"{len(w.trace.harness)} of them the harness's, "
                  f"{len(w.trace.host)} host events; reduced in "
                  f"{time.perf_counter() - t} s", file=sys.stderr)
        return w

    def rays_of(self, slots, dtype):
        """The sampled pixels' camera rays, from the poses each call was
        handed -> (o, d) tuples of (N,) tensors on the device."""
        os_, ds = [], []
        HW, W = self.n_pixels, self.intr.width
        for s in slots:
            pix = torch.as_tensor(s.pix, device=self.dev)
            f, rem = pix // HW, pix % HW
            o, d = golden.camera_rays(
                self.intr, torch.as_tensor(s.R, device=self.dev),
                torch.as_tensor(s.P, device=self.dev), f, rem // W, rem % W,
                dtype)
            os_.append(o)
            ds.append(d)
        cat = lambda parts: tuple(torch.cat([p[k] for p in parts])
                                  for k in range(3))
        return cat(os_), cat(ds)

    def reference(self, slots, dtype=torch.float32) -> dict:
        """The plain reference's buffers at the sampled pixels, rendered
        in blocks of REF_BLOCK rays -> dict of numpy arrays."""
        rscene = ref_scene.scene_of(self.cfg)
        o, d = self.rays_of(slots, dtype)
        parts = []
        with torch.no_grad():
            for s in range(0, o[0].numel(), REF_BLOCK):
                sl = slice(s, s + REF_BLOCK)
                parts.append(golden.render_rays(
                    rscene, self.ref_settings, tuple(x[sl] for x in o),
                    tuple(x[sl] for x in d), dtype))
        return {k: torch.cat([p[k] for p in parts]).float().cpu().numpy()
                .reshape(-1, *(() if k in ("depth", "hit", "obj_id")
                               else (3,)))
                for k in BUFFERS}

    @staticmethod
    def program_values(slots) -> dict:
        return {k: np.concatenate([s.values[k] for s in slots]).reshape(
            -1, *(() if k in ("depth", "hit", "obj_id") else (3,)))
            for k in BUFFERS}

    def check(self, w: Window, ref: Optional[dict] = None) -> dict:
        """The sampled pixels against the reference -> {"numbers",
        "judged", "correct", "pixels", "calls"}."""
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = self.reference(w.slots) if ref is None else ref
        nums = checks.numbers(self.program_values(w.slots), ref)
        judged = checks.judge(nums, self.cell.check["limits"])
        return {"numbers": nums, "judged": judged,
                "correct": all(j["ok"] for j in judged.values()),
                "pixels": int(sum(len(s.pix) for s in w.slots)),
                "calls": len(w.slots)}
