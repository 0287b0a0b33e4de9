"""What a cell is, found by name: BENCHMARK.json's entries and the data
files beside them.

    BENCHMARK.json                  the cells (`workloads`), their metrics
    portbench/configs/<config>.json the scene, camera and settings run
    portbench/traffic/<traffic>.json the calls a run makes (traffic.py)
    portbench/checks/<cell>.json    the output check's sample and limits
    portbench/metrics/<metric>.py   a per-layer metric's reader (a Trace)
    portbench/end_to_end/<metric>.py an end-to-end metric's reader (a Window)

Nothing here names a cell, a configuration or a metric: a new cell is a
new `workloads` entry and new files.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict           # the configuration file's contents
    traffic: dict          # the traffic file's contents
    check: dict            # the output check's sample and limits
    end_to_end: list       # BENCHMARK.json's metric entries this cell reports
    per_layer: list


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _in_cell(metric: dict, cell: str, e2e_names=None) -> bool:
    """A metric with a `workloads` key is reported in those cells; an
    end-to-end metric without one in every cell, a per-layer metric
    without one in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def cell(name: str, root: str = ROOT) -> Cell:
    """The workload entry `name` of BENCHMARK.json with its files."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _in_cell(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _in_cell(m, name, e2e_names)]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(os.path.join(root, conf["file"])),
        traffic=load_json(os.path.join(PKG, "traffic",
                                       w["traffic"] + ".json")),
        check=load_json(os.path.join(PKG, "checks", name + ".json")),
        end_to_end=e2e, per_layer=per_layer)


def reader(metric: str, kind: str = "metrics"):
    """The module portbench/<kind>/<metric>.py (kind "metrics" for the
    per-layer metrics, "end_to_end" for the end-to-end ones), loaded by its
    path, as a metric's name may hold dots; it defines read(x) -> number
    or None."""
    path = os.path.join(PKG, kind, metric + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}." + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
