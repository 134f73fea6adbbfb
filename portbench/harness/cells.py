"""Cells found by name: ``BENCHMARK.json`` at the checkout's root names
each cell's configuration and traffic mix; each lives in a data file of
its own under ``portbench/`` (``configs/<name>.json``,
``traffic/<name>.json``, ``limits/<cell>.json``), so a later change adds a
cell by adding files and entries, not by editing code."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict  # configs/<config>.json
    traffic_name: str
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # limits/<cell>.json: number -> limit
    benchmark: dict  # the whole BENCHMARK.json

    @property
    def window(self):
        return tuple(self.config["window"])


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files; raises
    KeyError for a name it does not list."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=_read_json(os.path.join(root, cfg_entry["file"])),
        traffic_name=w["traffic"],
        traffic=_read_json(os.path.join(BENCH_DIR, "traffic",
                                        w["traffic"] + ".json")),
        limits=_read_json(os.path.join(BENCH_DIR, "limits", name + ".json")),
        benchmark=bench)


def metric_names(cell: Cell, kind: str) -> list:
    """The names of the ``kind`` ("end_to_end" or "per_layer") metrics
    that ``cell`` reports: those without a ``workloads`` key, and those
    that list it."""
    return [m["name"] for m in cell.benchmark[kind]
            if cell.name in m.get("workloads", [cell.name])]


def metric_units(cell: Cell) -> dict:
    return {m["name"]: m["unit"] for kind in ("end_to_end", "per_layer")
            for m in cell.benchmark[kind]}
