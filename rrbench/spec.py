"""``BENCHMARK.json`` and the files each of its names leads to.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
configuration's ``file`` holds its sizes, the mix is
``rrbench/traffic/<traffic>.json``, and each per-layer metric is read by
``rrbench/metrics/<metric>.py``.  Adding a cell, a configuration, a mix or
a metric adds files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
HERE = Path(__file__).resolve().parent


class SpecError(ValueError):
    """BENCHMARK.json names something that is not there."""


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def traffic_path(name: str) -> Path:
    return HERE / "traffic" / f"{name}.json"


def metric_path(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def load_reader(name: str):
    """The ``read(trace)`` function of a per-layer metric."""
    path = metric_path(name)
    loader = importlib.util.spec_from_file_location(
        f"rrbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    return module.read


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @property
    def name(self) -> str:
        return self.workload["name"]


def cell(bench: dict, root: Path, name: str) -> Cell:
    """The cell ``name`` with its configuration's file and its mix read."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    cfg = {c["name"]: c for c in bench["configs"]}.get(w["config"])
    if cfg is None:
        raise SpecError(f"no configuration {w['config']!r}")
    with open(root / cfg["file"]) as f:
        config = json.load(f)
    with open(traffic_path(w["traffic"])) as f:
        traffic = json.load(f)
    return Cell(w, config, traffic,
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)])
