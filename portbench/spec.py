"""``BENCHMARK.json`` and the files of one cell, found by name.

A cell ``<config>.<traffic>`` of ``workloads`` reads
``portbench/configs/<config>.json`` (the configuration as it is run; its
``kind`` names the plain forward ``portbench/models/<kind>.py``),
``portbench/traffic/<traffic>.json`` (the mix; its ``kind`` names the
driver ``portbench/kinds/<kind>.py``) and ``portbench/cells/<cell>.json``
(the limits of the numbers that decide ``correct``). A per-layer metric
``<name>`` is read by ``portbench/metrics/<name>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: Dict[str, float]
    end_to_end: List[dict]      # the end-to-end metrics this cell reports
    per_layer: List[dict]       # the per-layer metrics this cell reports

    @property
    def model(self):
        return importlib.import_module(f"portbench.models.{self.config['kind']}")

    @property
    def kind(self):
        return importlib.import_module(f"portbench.kinds.{self.mix['kind']}")


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, bench: dict) -> Cell:
    """The cell ``name`` of ``bench``; ``KeyError`` for a name it lacks."""
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    return Cell(name=name, chips=int(entry["chips"]),
                config=read_json(ROOT / config["file"]),
                mix=read_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                limits=read_json(HERE / "cells" / f"{name}.json")["limits"],
                end_to_end=e2e,
                per_layer=[m for m in bench["per_layer"] if _reports(m, name, names)])


def metric_reader(name: str):
    """The ``read(ctx)`` function of the per-layer metric ``name``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
