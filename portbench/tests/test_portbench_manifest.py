"""BENCHMARK.json against the contract's shapes, and the harness finding
each part by name."""

from __future__ import annotations

import json
import shutil

import pytest

from portbench import manifest

BENCH = manifest.load()
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def _cells_of(metric):
    return [w["name"] for w in BENCH["workloads"]
            if manifest.reports(metric, w["name"])]


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert manifest.NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert manifest.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in (BENCH["configs"], BENCH["workloads"], BENCH["end_to_end"] + BENCH["per_layer"]):
        assert len({x["name"] for x in group}) == len(group)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])


def test_entries_have_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_cell_of_a_metric_reports_what_it_moves(metric):
    m = {x["name"]: x for x in BENCH["per_layer"]}[metric]
    moved = E2E[m["moves"]]
    cells = _cells_of(m)
    assert cells, metric
    for c in cells:
        assert "workloads" not in moved or c in moved["workloads"], (metric, c)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_parts_and_reports_enough(cell):
    c = manifest.cell(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    assert manifest.driver(c.mix["driver"]) is not None
    for m in c.per_layer:
        assert callable(manifest.metric_reader(m["name"]))
    assert c.limits and all(v >= 0 for v in c.limits.values())  # 0: an exact comparison


def test_a_new_config_mix_cell_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(manifest.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    pb = root / "portbench"
    (pb / "configs" / "new-cfg.json").write_text(json.dumps({"n_embd": 7}))
    (pb / "traffic" / "new_mix.json").write_text(json.dumps({"driver": "generate", "batch": 3}))
    (pb / "limits" / "new.cell.json").write_text(json.dumps({"sample_gap": 1.0}))
    (pb / "metrics" / "new_metric.x.py").write_text("def read(rec):\n    return 42.0\n")
    bench["configs"].append({"name": "new-cfg", "source": "https://example.org/a",
                             "file": "portbench/configs/new-cfg.json", "reduced": [],
                             "why": "a new one"})
    bench["workloads"].append({"name": "new.cell", "config": "new-cfg", "traffic": "new_mix",
                               "chips": 1, "why": "a new one"})
    bench["per_layer"].append({"name": "new_metric.x", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "setup_s", "workloads": ["new.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = manifest.cell("new.cell", root=root)
    assert c.cfg == {"n_embd": 7} and c.mix["batch"] == 3 and c.limits == {"sample_gap": 1.0}
    assert [m["name"] for m in c.per_layer] == ["new_metric.x"]
    assert manifest.metric_reader("new_metric.x", root=root)({}) == 42.0
