"""Fit-loop throughput on a CUDA GPU: the eager pipeline against the
kernel-forward hybrid (counterpart of `tools/fit_bench.py`).

    python -m surfjax_torch.tools.fit_bench [--steps 20] [--repeats 3]
        [--size 256x256]

Measures optimization steps per second of the pose fit on
configs/c5_anim.yaml (at its own 256x256, or reframed to --size): one step
is the loss and its gradient at the current pose plus one Adam update,
exactly fit_pose's step (diff/fit.fit_step), from the fixed probe pose
against a constant target image (the time does not depend on the target).
K steps are enqueued in a host loop and the device is synchronised once at
the end, so the figure includes the host's share as a real fit pays it; the
minimum over the repeats is reported, for backend "jnp" and "pallas".

Needs one CUDA card; prints the card's name and power limit first and one
JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from surfjax_torch.diff import fit
from surfjax_torch.tools.workload import fit_main_path, gpu_line, reframe

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
C5 = os.path.join(ROOT, "configs", "c5_anim.yaml")


def pose_step_fn(backend: str, steps: int, size=None, device="cuda",
                 **over):
    """-> (step, x0, state0, intrinsics): step(x, state) -> (x, state,
    loss tensor) is one pose-fit step on c5 with `backend` (and the
    settings in `over`), whose step size decays over `steps`; (x0, state0)
    the probe pose and a fresh optimizer state."""
    scene, camera, settings, cfg, _ = fit_main_path(C5)
    if size is not None:
        camera = reframe(camera, *size)
    settings = settings.with_(backend=backend, **over)
    device, static, params, intr, R0, t0 = fit._setup(scene, camera, device)
    target = torch.full((intr.height, intr.width, 3), 0.5, device=device)
    loss_fn = fit.pose_loss_fn(static, intr, settings, params, R0, t0, target)
    x0 = {"w": fit._as_f32(fit._PROBE_W, device),
          "dt": fit._as_f32(fit._PROBE_DT, device)}

    def step(x, state):
        return fit.fit_step(loss_fn, x, state, cfg["lr"], steps)
    return step, x0, fit.adam_init(x0), intr


def bench_backend(backend: str, steps: int, repeats: int, size=None,
                  device="cuda") -> dict:
    """Time `steps` pose-fit steps `repeats` times, one synchronisation at
    the end of each run -> the fastest run's ms per step."""
    if not torch.cuda.is_available():
        raise RuntimeError("fit_bench measures a CUDA card; "
                           "torch.cuda.is_available() is false")
    step, x0, state0, intr = pose_step_fn(backend, steps, size, device)
    _, _, loss = step(x0, state0)       # warm up: builds and caches
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        x, state = x0, state0
        t_start = time.perf_counter()
        for _ in range(steps):
            x, state, loss = step(x, state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t_start)
    dt = min(times) / steps
    return {"backend_setting": backend, "res": [intr.width, intr.height],
            "steps": steps, "step_ms": dt * 1e3, "steps_per_s": 1.0 / dt,
            "final_loss": float(loss)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="surfjax_torch.tools.fit_bench")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--size", type=str, default=None,
                    help="WIDTHxHEIGHT to reframe c5 to (default: its own)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fit_bench: torch.cuda.is_available() is false; "
                         "this tool measures a CUDA GPU")
    print(gpu_line(), flush=True)
    size = (tuple(int(v) for v in args.size.split("x")) if args.size
            else None)
    rows = {}
    for be in ("jnp", "pallas"):
        r = rows[be] = bench_backend(be, args.steps, args.repeats, size)
        print(f"| fit_pose {be:6s} | {r['step_ms']:9.3f} ms/step "
              f"| {r['steps_per_s']:8.2f} steps/s "
              f"| final loss {r['final_loss']:.6g} |", flush=True)
    rows["speedup_pallas_vs_jnp"] = (rows["jnp"]["step_ms"]
                                     / rows["pallas"]["step_ms"])
    print(f"speedup pallas vs jnp: {rows['speedup_pallas_vs_jnp']:.3f}x")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
