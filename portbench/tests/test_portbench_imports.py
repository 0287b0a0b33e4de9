"""The import check compares whole top-level names, and the reference
imports nothing of the program."""

import subprocess
import sys
import types

import pytest

from portbench import harness, run, spec
from portbench.spec import ROOT


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("surfjax", True), ("surfjax.kernels.render_tile",
                                              True),
    ("surfjax_torch", False), ("surfjax_torch.api", False),
    ("jaxtyping", False), ("surfjaxy", False)])
def test_forbidden_modules_compare_whole_names(monkeypatch, name, bad):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name in harness.forbidden_modules()) is bad


def test_reference_imports_nothing_of_the_program():
    """The reference, the check, the trace's reduction and every metric
    reader under metrics/ and end_to_end/ (loaded as run.py loads them)."""
    code = ("import os, sys, portbench.reference.golden, portbench.check, "
            "portbench.calibrate, portbench.trace, portbench.accounting; "
            "from portbench import spec\n"
            "for kind in ('metrics', 'end_to_end'):\n"
            "    for f in sorted(os.listdir(os.path.join(spec.PKG, kind))):\n"
            "        if f.endswith('.py'):\n"
            "            assert callable(spec.reader(f[:-3], kind).read), f\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('surfjax_torch', 'surfjax', 'jax', 'jaxlib', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench.run",
                          "--workload", "c3.seq48.value", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True)
    if "is_available() is false" not in out.stderr:
        pytest.skip("a card is present: the check for none does not apply")
    assert out.returncode != 0
    assert out.stdout == ""


def test_a_module_loaded_after_the_window_stops_the_result(monkeypatch,
                                                           capsys):
    """The last look at sys.modules comes after the readers and the
    reference: a forbidden module that the check loads leaves no result."""
    real, real_check = harness.Bench, harness.Bench.check

    def tiny(cell):
        cell.traffic = dict(cell.traffic, frames_per_call=1)
        cell.check = dict(cell.check,
                          sample={"calls": 1, "pixels_per_call": 64})
        return real(cell, device="cpu", size=(16, 8), warmup=1)

    def check_loading_jax(self, w, ref=None):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return real_check(self, w, ref)

    monkeypatch.setattr(harness, "require_cards", lambda n: None)
    monkeypatch.setattr(run, "device_line", lambda *a: {})
    monkeypatch.setattr(harness, "Bench", tiny)
    monkeypatch.setattr(real, "check", check_loading_jax)
    name = spec.benchmark()["workloads"][0]["name"]
    rc = run.main(["--workload", name, "--seed", "5", "--seconds", "0.05",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc == run.EXIT_FORBIDDEN
    assert out.out == ""
    assert "before the result: forbidden modules loaded: jax" in out.err
