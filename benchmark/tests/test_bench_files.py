"""Every file the benchmark finds by name parses and is found, and
`BENCHMARK.json` keeps to the shape the harness reads."""

from __future__ import annotations

import json
import re

import pytest

from small import ROOT  # noqa: F401  (puts the checkout on sys.path)

from benchmark.harness.spec import BENCH_DIR, load_cell, load_module

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all((ROOT / p).is_dir() for p in BENCH["paths"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = load_cell(cell, ROOT)
    assert c.chips == 1
    assert load_module("loops", c.traffic["loop"]).run
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer and c.limits


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    mod = load_module("metrics", metric)
    assert (mod.SOURCE, mod.UNIT, mod.MOVES) == (entry["source"], entry["unit"], entry["moves"])
    assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert set(entry["workloads"]) <= set(CELLS)


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("kind", ["configs", "traffic", "checks"])
def test_data_files_parse(kind):
    files = sorted((BENCH_DIR / kind).glob("*.json"))
    assert files
    for f in files:
        json.loads(f.read_text())


def test_config_files_are_the_named_ones():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
