"""The general traffic generator: one traffic file's parameters -> the
calls a run makes.

A traffic file (portbench/traffic/<name>.json) holds:
    entry            "render_sequence" (frames_per_call frames a call)
    frames_per_call  frames in each call
    mode             RenderSettings overrides over the configuration's
    jitter           each frame's camera position is the configuration's,
                     moved on each axis by a number drawn uniformly from
                     [-jitter, jitter] scene units
    loop, clients    "closed", 1: one client, each call sent when the last
                     one has returned
Every call's positions are drawn from the run's seed, so the same seed
gives the same calls, and every seed gives calls of the same size.
"""

from __future__ import annotations

import numpy as np

ENTRIES = ("render_sequence",)


def check(traffic: dict) -> None:
    if traffic["entry"] not in ENTRIES:
        raise ValueError(f"entry must be one of {ENTRIES}")
    if (traffic.get("loop"), traffic.get("clients")) != ("closed", 1):
        raise ValueError("the generator drives one client in a closed loop")


def calls(traffic: dict, seed: int, R_flat, position):
    """Endless (R_flats (F, 9), positions (F, 3)) float32 pairs, the
    rotation the configuration's and each position jittered."""
    rng = np.random.default_rng([int(seed), 0])
    F = int(traffic["frames_per_call"])
    j = float(traffic["jitter"])
    R = np.repeat(np.asarray(R_flat, np.float32).reshape(1, 9), F, axis=0)
    pos = np.asarray(position, np.float64).reshape(1, 3)
    while True:
        yield R, (pos + rng.uniform(-j, j, (F, 3))).astype(np.float32)


def warmup_call(traffic: dict, R_flat, position):
    """A call of the traffic's shape at the configuration's own pose."""
    F = int(traffic["frames_per_call"])
    return (np.repeat(np.asarray(R_flat, np.float32).reshape(1, 9), F, 0),
            np.repeat(np.asarray(position, np.float32).reshape(1, 3), F, 0))
