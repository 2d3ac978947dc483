"""Cells, configurations, traffic mixes and per-layer metrics are files of
their own, found by name."""

from __future__ import annotations

import importlib
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness

REPO = Path(harness.ROOT).parent


def benchmark() -> dict:
    with open(REPO / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


@pytest.mark.parametrize("name", harness.cell_names())
def test_each_cell_file_names_its_config_traffic_and_driver(name):
    cell = harness.load_cell(name)
    assert cell.name == name and cell.chips in (1, 4)
    assert callable(importlib.import_module(f"portbench.drivers.{cell.kind}").run)
    assert cell.limits and all(isinstance(v, (int, float)) for v in cell.limits.values())


def test_benchmark_json_matches_the_files():
    spec = benchmark()
    assert {w["name"] for w in spec["workloads"]} == set(harness.cell_names())
    for w in spec["workloads"]:
        with open(harness.ROOT / "workloads" / f"{w['name']}.json", encoding="utf-8") as f:
            cell = json.load(f)
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert harness.load_cell(w["name"]).traffic["name"] == w["traffic"]
    for c in spec["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        with open(REPO / c["file"], encoding="utf-8") as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
    readers = harness.metric_readers()
    assert {m["name"] for m in spec["per_layer"]} == set(readers)
    for m in spec["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"]


@pytest.mark.parametrize("name", sorted(harness.metric_readers()))
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    reader = harness.metric_readers()[name]
    assert reader.read({}) is None
    assert reader.read({"kind": "als_train", "trace": None}) is None


def test_new_files_are_found_without_code(tmp_path, monkeypatch):
    for sub in ("configs", "workloads", "traffic/mixes", "metrics"):
        shutil.copytree(harness.ROOT / sub, tmp_path / sub)
    cell = json.loads((tmp_path / "workloads" / "als-ml25m-train.json").read_text())
    cell["name"] = "als-ml25m-other"
    (tmp_path / "workloads" / "als-ml25m-other.json").write_text(json.dumps(cell))
    (tmp_path / "metrics" / "some_count.py").write_text(
        "UNIT = 'n'\n\ndef read(art):\n    return art.get('n')\n")
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    assert "als-ml25m-other" in harness.cell_names()
    assert harness.load_cell("als-ml25m-other").kind == "als_train"
    assert harness.read_metrics({"n": 3})["some_count"] == {"value": 3.0, "unit": "n"}
    with pytest.raises(FileNotFoundError):
        harness.load_cell("no-such-cell")


NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")


def _line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and not set(text) & set("\t\r\n")


def test_benchmark_json_keeps_the_contracts_form():
    """Every key, name, unit and limit of BENCHMARK.json's form."""
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    spec = benchmark()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(spec["command"]) <= 32 and all(map(_line, spec["command"]))
    assert not any(w.startswith("/") or ".." in w for w in spec["command"])
    assert 1 <= len(spec["paths"]) <= 16
    assert all(PATH.fullmatch(p) and ".." not in p for p in spec["paths"])
    for p in spec["paths"]:
        assert all(PATH.fullmatch(f.relative_to(REPO).as_posix())
                   for f in (REPO / p).rglob("*") if f.is_file())
    rs = spec["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200

    configs, cells = spec["configs"], spec["workloads"]
    e2e, layers = spec["end_to_end"], spec["per_layer"]
    assert 1 <= len(configs) <= 24 and 1 <= len(cells) <= 24
    assert 1 <= len(e2e) <= 16 and 1 <= len(layers) <= 128
    for group in (configs, cells, e2e + layers):
        names = [x["name"] for x in group]
        assert len(set(names)) == len(names) and all(NAME.fullmatch(n) for n in names)

    for c in configs:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in spec["paths"])
        assert len(c["reduced"]) <= 16 and all(NAME.fullmatch(k) for k in c["reduced"])
    assert len({c["file"] for c in configs}) == len(configs)
    assert {c["name"] for c in configs} == {w["config"] for w in cells}

    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["traffic"]) and _line(w["why"]) and w["chips"] in (1, 4)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)

    cell_names = {w["name"] for w in cells}
    reported = {w: set() for w in cell_names}
    for m in e2e + layers:
        keys = ({"name", "unit", "better", "bound", "source"} if m in e2e
                else {"name", "unit", "better", "source", "layer", "moves"})
        assert set(m) - {"workloads"} == keys
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        where = set(m.get("workloads", cell_names))
        assert where and where <= cell_names
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        if m in e2e:
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
            for w in where:
                reported[w].add(m["name"])
    assert "setup_s" in {m["name"] for m in e2e}
    assert all("workloads" not in m for m in e2e if m["name"] == "setup_s")
    for m in layers:
        assert _line(m["layer"]) and m["moves"] in {x["name"] for x in e2e}
        assert all(m["moves"] in reported[w] for w in m.get("workloads", cell_names))
    for w in cell_names:
        assert len(reported[w]) >= 2
        assert any(w in m.get("workloads", cell_names) for m in layers)
