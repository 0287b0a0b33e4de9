"""A run driven end to end on the CPU at a tiny size (the look for a card
skipped, the kernels' plain versions), with the timed path broken
underneath: each fault a cell can have (faults.py) makes `correct`
false, and the unbroken path is correct under the same limits. The same
faults at each cell's own size on the card: test_portbench_card.py.
"""

import time

import pytest

from portbench import harness, spec
from portbench.tests.faults import FAULTS, plant_fault

SIZE = (40, 24)
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _bench(name):
    c = spec.cell(name)
    c.traffic = dict(c.traffic,
                     frames_per_call=min(c.traffic["frames_per_call"], 2))
    c.check = dict(c.check, sample={"calls": 2, "pixels_per_call": 400})
    return harness.Bench(c, device="cpu", size=SIZE, warmup=1)


def _run(bench):
    w = bench.window(2024061520240615, 0.5, time.perf_counter())
    return bench.check(w)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    v = _run(_bench(name))
    assert v["correct"], v["judged"]


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS
                                        for f in FAULTS])
def test_fault_makes_correct_false(name, fault):
    bench = _bench(name)
    plant_fault(bench, fault)
    v = _run(bench)
    assert not v["correct"], v["numbers"]
