"""Every cell, configuration, traffic mix, check and metric reader loads by
name, and every cell reports what the contract asks of it."""

import json
import os

import pytest

from portbench import spec, traffic

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    c = spec.cell(name)
    traffic.check(c.traffic)
    assert set(c.check) == {"sample", "limits"}
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("kind,metric", [
    ("end_to_end", m["name"]) for m in BENCH["end_to_end"]] + [
    ("metrics", m["name"]) for m in BENCH["per_layer"]])
def test_metric_reader_loads_by_name(kind, metric):
    mod = spec.reader(metric, kind)
    assert callable(mod.read)


def test_configs_are_files_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        with open(os.path.join(spec.ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]


def test_unknown_cell_names_the_known_ones():
    with pytest.raises(KeyError, match="c3.seq48.value"):
        spec.cell("no.such.cell")
