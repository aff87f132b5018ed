"""``BENCHMARK.json`` and the files it names: a cell's configuration
(``configs[].file``), its traffic mix (``traffic/<traffic>.json``) and each
metric's reader (``metrics/<metric>.py``, a function ``read(run)``), found
by name so that a cell, a configuration, a mix or a metric is added by
adding files and entries alone.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    model: dict             # the configuration file
    traffic_name: str
    traffic: dict           # the mix's parameter file
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]   # the per-layer metrics this cell reports


def load(path: Optional[Path] = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: Optional[dict] = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` (default: the checkout's
    ``BENCHMARK.json``) with its files read from under ``root``."""
    bench = bench if bench is not None else load(root / "BENCHMARK.json")
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    model = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "ragbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, int(w["chips"]), model, w["traffic"], traffic,
                [m for m in bench["end_to_end"] if _reported(m, name)],
                [m for m in bench["per_layer"] if _reported(m, name)])


def reader(metric: str, root: Path = ROOT) -> Callable:
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = root / "ragbench" / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"ragbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
