"""Benchmark harness: the counterpart of the JAX package's `bench.py`.

    python -m surfjax_torch.bench [config] [key=value ...]

prints ONE JSON line. The metric is Mrays/s per card at 1080p (256-step
trace), frames/s including shadow rays, on the pinned workload:
configs/c3_sdf.yaml reframed to 1920x1080 at the config camera's vertical
fov, 48 camera positions each moved by 1e-4 * i on every axis (the same
workload every frame, no result reused), rendered in ONE `render_sequence`
call. Two fidelity modes are measured in every run:
  value        the config's settings (secondary-ray fractal LoD on);
  value_exact  both LoDs 0 and over_relax 1.0: full-DE secondary rays on
               the oracle trajectory, the settings of the golden parity
               tests.
The mode parameters are disclosed in the JSON. mrays_primary_shadow leaves
out the AO probes, for a look at the composition.

Method: one warm-up call (it builds or loads the kernels and gives the hits
per frame), then `repeats` timed calls, each `render_sequence`, a reduction
over the stacked buffers and `torch.cuda.synchronize()`, with the host
clock around all of it and CUDA events around the same work; the figure is
the fastest call's time over its frames. On the card the kernel paths run
(`backend="pallas"`): a mesh-free scene is one fused launch per call, a
mesh scene (or a primed one) goes in passes of whole frames through the
split path (or the priming pass and KF), each kernel launched once per
pass (render_tile.PASS_RAYS rays at most; c4's 16 frames at 1080p are one
pass). Ray accounting:
primary = H*W; shadow = one ray per (hit, light); AO = one probe ray per
(hit, probe direction).

Keys after `config` are `RenderSettings` overrides (disclosed in the JSON),
except the harness keys `repeats`, `n_frames`, `width`, `height` and
`device` (default cuda; `device=cpu` runs the plain versions on the CPU,
for a small check only).
"""

from __future__ import annotations

import json
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from surfjax_torch.api import render_sequence
from surfjax_torch.config import load_config
from surfjax_torch.pipeline.frame import _check_device
# metric_workload is defined beside the other workloads and is part of
# this module's interface, as in bench.py
from surfjax_torch.tools.workload import EXACT, gpu_line, metric_workload

METRIC = ("Mrays/sec/card at 1080p (256-step trace); "
          "frames/sec incl. shadow rays")


class Timing(NamedTuple):
    """One mode's measurement: s_per_frame is the fastest call over its
    frames; hits the warm-up call's hit count per frame (float64 numpy,
    exact); frame_times_s every timed call over its frames, host clock;
    device_frame_times_s the same calls by CUDA events (None on the
    CPU)."""
    s_per_frame: float
    hits: np.ndarray
    frame_times_s: list
    device_frame_times_s: Optional[list]


def _reduce(fb):
    # bench.py's reduction (rgb mean, depth mean, hits); the hits per
    # frame in float64, where every count is exact
    return fb.rgb.mean(), fb.depth.mean(), fb.hit.sum(dim=(1, 2),
                                                      dtype=torch.float64)


def time_mode(scene, camera, settings, poses_, repeats: int,
              device="cuda") -> Timing:
    """Time `render_sequence(scene, camera, poses_, settings)` on `device`
    -> Timing: one warm-up call, then `repeats` calls each ended by the
    reduction and a synchronisation."""
    device = _check_device(device)
    cuda = device.type == "cuda"
    n_frames = len(poses_[1])

    def call():
        return _reduce(render_sequence(scene, camera, poses_, settings,
                                       device=device))

    hits = call()[2].cpu().numpy()
    host, dev = [], []
    for _ in range(repeats):
        if cuda:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        call()
        if cuda:
            end.record()
            torch.cuda.synchronize(device)
        host.append((time.perf_counter() - t0) / n_frames)
        if cuda:
            dev.append(start.elapsed_time(end) / 1e3 / n_frames)
    return Timing(min(host), hits, host, dev if cuda else None)


def ray_counts(intr, n_hits: float, n_lights: int, settings):
    """-> (primary, shadow, AO) rays of a frame: primary = H*W; shadow =
    one ray per (hit, light); AO = one probe per (hit, probe direction)."""
    primary = float(intr.width * intr.height)
    shadow = n_hits * n_lights if settings.shadows else 0.0
    ao = n_hits * settings.ao_samples if settings.ao else 0.0
    return primary, shadow, ao


def rays_per_frame(scene, settings, intr, n_hits: float) -> float:
    """The rays of a frame of `scene` with n_hits hits (ray_counts)."""
    return sum(ray_counts(intr, n_hits, len(scene.lights), settings))


def run_bench(config: Optional[str] = None, repeats: int = 3,
              width: int = 1920, height: int = 1080, n_frames: int = 48,
              overrides: Optional[dict] = None, device="cuda") -> dict:
    """Both modes of the metric workload on `device` (the card unless the
    caller asks for "cpu") -> bench.py's dict. On the card the kernel
    paths run (backend pallas); on the CPU the config's backend, unless
    `overrides` names one."""
    device = _check_device(device)
    scene, camera, settings, R_flats, positions = metric_workload(
        config, width, height, n_frames)
    if device.type == "cuda":
        settings = settings.with_(backend="pallas")
    if overrides:
        # variant sweeps on the pinned workload, disclosed in the JSON so
        # that an overridden run is not taken for the headline
        settings = settings.with_(**overrides)
    poses_ = (R_flats, positions)
    value = time_mode(scene, camera, settings, poses_, repeats, device)
    exact = time_mode(scene, camera, settings.with_(**EXACT), poses_,
                      repeats, device)
    dt, dt_exact = value.s_per_frame, exact.s_per_frame
    n_hits = float(value.hits.sum()) / n_frames

    primary, shadow, ao = ray_counts(camera.intrinsics, n_hits,
                                     len(scene.lights), settings)
    rpf = primary + shadow + ao
    on_card = device.type == "cuda"
    return {
        "metric": METRIC,
        "value": round(rpf / dt / 1e6, 3),
        "unit": "Mrays/s/card",
        "value_exact": round(rpf / dt_exact / 1e6, 3),
        "mrays_primary_shadow": round((primary + shadow) / dt / 1e6, 3),
        "mrays_primary_shadow_exact": round(
            (primary + shadow) / dt_exact / 1e6, 3),
        "secondary_lod_iters": settings.secondary_lod_iters,
        "ao_lod_iters": settings.ao_lod_iters,
        "over_relax": settings.over_relax,
        "bulb_iter": settings.bulb_iter,
        "frames_per_sec": round(1.0 / dt, 4),
        "rays_per_frame": int(rpf),
        "primary_rays": int(primary),
        "shadow_rays": int(shadow),
        "ao_rays": int(ao),
        "frame_time_s": round(dt, 5),
        "frame_time_exact_s": round(dt_exact, 5),
        "frames_per_dispatch": n_frames,
        "backend": device.type,
        "devices": torch.cuda.device_count(),
        "settings_backend": settings.backend,
        "device": gpu_line() if on_card else "cpu",
        "repeats": repeats,
        "frame_times_s": {"value": value.frame_times_s,
                          "value_exact": exact.frame_times_s},
        # CUDA events around the same calls; none on the CPU
        "device_frame_time_s": {"value": value.device_frame_times_s,
                                "value_exact": exact.device_frame_times_s},
        **({"overrides": {k: str(v) for k, v in overrides.items()}}
           if overrides else {}),
    }


HARNESS = {"repeats": 3, "n_frames": 48, "width": 1920, "height": 1080,
           "device": "cuda"}


def parse_args(argv) -> dict:
    """[config] [key=value ...] -> run_bench's keyword arguments: the
    harness keys as they are, every other key=value a RenderSettings
    override (int, float, true/false or a string)."""
    kw = dict(HARNESS)
    config, overrides = None, {}
    for a in argv:
        if "=" not in a:
            config = a
            continue
        k, v = a.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                v = {"true": True, "false": False}.get(v.lower(), v)
        if k == "device":
            kw[k] = str(v)
        elif k in HARNESS:
            kw[k] = int(v)
        else:
            overrides[k] = v
    return dict(kw, config=config, overrides=overrides or None)


def main(argv=None) -> int:
    print(json.dumps(run_bench(**parse_args(
        sys.argv[1:] if argv is None else argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
