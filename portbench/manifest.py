"""BENCHMARK.json and the files it names, found by name:

  configuration  the `file` of its entry in `configs`
  traffic mix    portbench/traffic/<traffic>.json, whose `driver` names
  driver         portbench/drivers/<driver>.py (its `DRIVER` class)
  limits         portbench/limits/<cell>.json: each number the check
                 compares, with its limit
  metric         portbench/metrics/<metric>.py (its `read(record)`)

A later change adds a configuration, a mix, a cell or a metric as new
files and new entries, and edits none of these.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    cfg: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list
    seed: int = 0
    seconds: float = 10.0
    device: object = None


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether `cell` reports the metric: its `workloads` lists the cell
    (every per-layer metric lists its cells)."""
    return cell in metric["workloads"]


def cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    bench = load(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    per_layer = [m for m in bench["per_layer"] if reports(m, name)]
    here = root / "portbench"
    return Cell(
        name=name, config_name=w["config"], traffic=w["traffic"], chips=int(w["chips"]),
        cfg=_read(root / conf["file"]), mix=_read(here / "traffic" / f"{w['traffic']}.json"),
        limits=_read(here / "limits" / f"{name}.json"), end_to_end=e2e, per_layer=per_layer,
    )


def driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}").DRIVER


def metric_reader(name: str, root: Path = ROOT):
    """The `read` function of portbench/metrics/<name>.py."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + re.sub(r"\W", "_", name),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
