"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (the manifest's ``configs[].file``), its mix
(``simbench/mixes/<traffic>.json``), its limits
(``simbench/limits/<cell>.json``) and the reader of each metric
(``simbench/metrics/<name>.py``, or ``<the name up to its first dot>.py``
where the metric has no file of its own: ``pack_ms.sweep`` reads
``pack_ms.py``, as a metric of another mix would). A later cell or metric is added
by adding files and entries."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def config(manifest: dict, cell: dict) -> dict:
    for c in manifest["configs"]:
        if c["name"] == cell["config"]:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"BENCHMARK.json has no config {cell['config']!r}")


def mix_path(traffic: str) -> Path:
    return HERE / "mixes" / f"{traffic}.json"


def limits(cell_name: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell_name}.json").read_text())


def metrics(manifest: dict, cell_name: str, traced: bool) -> list:
    """The cell's end-to-end metrics (untraced) or per-layer ones (traced):
    those that list the cell, or list no cells."""
    group = manifest["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def reader_path(metric: str) -> Path:
    own = HERE / "metrics" / f"{metric}.py"
    return own if own.is_file() else HERE / "metrics" / f"{metric.split('.')[0]}.py"


def reader(metric: str):
    """The ``read(record) -> float | None`` function of ``metric``'s file."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(f"simbench.metrics.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
