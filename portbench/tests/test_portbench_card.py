"""On the card (marked `cuda`; each skips without one): one short run of
the command, and at each cell's own size, on the pixels a run samples,
the control and each planted fault failing the cell's limits.

    python -m pytest portbench/tests -q -m cuda -s

With -s each reading is printed as a JSON line beginning `reading`.
"""

import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import calibrate, check, harness, spec
from portbench.spec import ROOT
from portbench.tests.faults import plant_fault

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEEDS = (17000000041, 4100000000003, 2300000000029)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _show(kind, name, seed, nums, judged):
    print("reading " + json.dumps({
        "kind": kind, "cell": name, "seed": seed, "numbers": nums,
        "failed": sorted(k for k, j in judged.items() if not j["ok"])}))


@pytest.mark.cuda
def test_one_short_run_prints_a_correct_result():
    _card()
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "c4.seq16.config", "--seed", "4000000000007",
                          "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu"
    assert {"mrays_per_s", "call_ms_p95", "peak_mem_gib",
            "setup_s"} <= set(res["metrics"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cells_limits(name):
    """The reference in bfloat16 in the program's place, on the pixels a
    run samples, is not correct under the cell's limits."""
    _card()
    cell = spec.cell(name)
    bench = harness.Bench(cell)
    for seed in SEEDS:
        w = bench.window(seed, 1.0, time.perf_counter())
        nums = check.numbers(calibrate.control_values(bench, w),
                             bench.reference(w.slots))
        judged = check.judge(nums, cell.check["limits"])
        _show("control", name, seed, nums, judged)
        assert not all(j["ok"] for j in judged.values()), nums


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["stale", "half"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_fails_the_cells_limits(name, fault):
    """A short window of the cell at its own size, traffic and sample,
    with the timed path broken underneath (faults.py), is not correct."""
    _card()
    bench = harness.Bench(spec.cell(name))
    plant_fault(bench, fault)
    for seed in SEEDS:
        v = bench.check(bench.window(seed, 1.0, time.perf_counter()))
        _show(fault, name, seed, v["numbers"], v["judged"])
        assert not v["correct"], v["numbers"]
