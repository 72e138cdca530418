"""BENCHMARK.json keeps to its contract, and every file it names is found."""
import json
import re

import pytest

from simbench import manifest
from simbench.manifest import HERE, ROOT

MAN = manifest.load()
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_keys_and_sizes():
    assert set(MAN) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(MAN["command"]) <= 32 and all(LINE.match(w) for w in MAN["command"])
    assert MAN["paths"] == ["simbench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51


def test_names_and_units():
    names = [x["name"] for g in ("configs", "workloads", "end_to_end", "per_layer") for x in MAN[g]]
    assert len(names) == len(set(names))
    assert all(manifest.NAME.match(n) for n in names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in MAN["workloads"]:
        assert manifest.NAME.match(w["config"]) and manifest.NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)


def test_metric_contract():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        for c in m["workloads"]:  # each cell it lists reports the metric it moves
            assert c in cells and c in e2e[m["moves"]].get("workloads", [c])
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in cells:  # each cell: setup_s, another end-to-end metric, a per-layer metric
        assert len(manifest.metrics(MAN, c, False)) >= 2 and manifest.metrics(MAN, c, True)


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_are_found_by_name(cell):
    spec = manifest.cell(MAN, cell)
    cfg = manifest.config(MAN, spec)
    assert cfg["name"] == spec["config"]
    assert manifest.mix_path(spec["traffic"]).is_file()
    lim = manifest.limits(cell)
    assert lim["answer_gap_mean"]["limit"] > 0 and lim["min_checked_jobs"] >= 1
    for m in manifest.metrics(MAN, cell, False) + manifest.metrics(MAN, cell, True):
        assert manifest.reader_path(m["name"]).is_file()
        assert callable(manifest.reader(m["name"]))


def test_configs_are_used_and_under_paths():
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used and c["file"].startswith("simbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"] == []


def test_files_under_paths_are_named_from_name_characters():
    for p in HERE.rglob("*"):
        rel = p.relative_to(ROOT).as_posix()
        if "__pycache__" in rel or "/.pool" in rel:
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
