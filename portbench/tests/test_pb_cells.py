"""The benchmark's cells, configurations, traffic mixes, limits and
per-layer metrics are found by name from data files, and
``BENCHMARK.json`` keeps to its contract's shape."""

import json
import os
import re

import pytest

from conftest import ROOT
from portbench.harness import cells, metrics

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(w):
    cell = cells.find_cell(w["name"])
    assert cell.config_name == w["config"]
    assert cell.traffic_name == w["traffic"]
    assert set(cell.limits) == {"image_rel_l1", "blit_mean_abs"}
    assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["name"])
    assert cell.traffic["mode"] in ("pathtrace", "denoised")
    e2e = cells.metric_names(cell, "end_to_end")
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cells.metric_names(cell, "per_layer")


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        cells.find_cell("no-such-cell")


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    cfg = json.load(open(os.path.join(ROOT, c["file"])))
    assert c["file"].startswith("portbench/configs/")
    assert cfg["source"] == c["source"] and len(c["source"]) <= 200
    assert cfg["reduced"] == c["reduced"] == []
    from loupiote_tpu_torch.config import RenderConfig

    RenderConfig(**cfg["render"])  # every field is one of the port's


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_files(m):
    assert callable(metrics.load(m["name"]).read)
    assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    for w in m["workloads"]:
        assert m["moves"] in cells.metric_names(cells.find_cell(w),
                                                "end_to_end")
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert UNIT.match(m["unit"]) and NAME.match(m["name"])
    layers = {x["layer"] for x in BENCH["per_layer"]
              if x["layer"].split(" ")[0] == m["layer"].split(" ")[0]}
    assert len(layers) == 1


def test_end_to_end_bounds():
    by = {m["name"]: m for m in BENCH["end_to_end"]}
    assert by["setup_s"]["bound"] == 0.25
    for m in by.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
