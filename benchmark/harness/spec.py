"""Find a cell's pieces by name: `BENCHMARK.json` at the checkout's root,
`benchmark/configs/<config>.json` (the file `BENCHMARK.json` names),
`benchmark/traffic/<traffic>.json`, `benchmark/checks/<workload>.json`
(the limits that decide `correct`), `benchmark/loops/<loop>.py` (the
session loop a traffic names) and `benchmark/metrics/<metric>.py`."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    limits: dict  # number -> limit
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=_json(root / configs[w["config"]]["file"]),
        traffic=_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json"),
        limits=_json(root / "benchmark" / "checks" / f"{workload}.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )


def load_module(kind: str, name: str) -> ModuleType:
    """`benchmark/<kind>/<name>.py` as a module (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
