"""A run's last line has the contract's shape; a run fails, with no
result, where there is no card or no program; no module under
``portbench/`` imports JAX or the JAX package, and the reference imports
nothing of the program."""

import ast
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from conftest import ROOT, small_cell
from portbench.harness import runner
from portbench.harness.cells import metric_names

BENCH_DIR = os.path.join(ROOT, "portbench")


def _py_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, 0
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level


def test_no_jax_anywhere():
    for path in _py_files(BENCH_DIR):
        for mod, level in _imports(path):
            top = mod.split(".")[0]
            assert level or top not in runner.FORBIDDEN, (path, mod)
        # The JAX-era records and script are not read.
        text = open(path).read()
        for name in ("BENCH" + "_r", "MULTI" + "CHIP_", "bench" + ".py"):
            assert name not in text, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in _py_files(os.path.join(BENCH_DIR, "reference")):
        for mod, level in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("loupiote_tpu_torch", "portbench"), (path, mod)
            assert level <= 1, (path, mod)  # only its own modules


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import loupiote_tpu_torch  # noqa: F401

    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert runner.forbidden_modules() == ["jax"]


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "hall260k-1080p-progressive", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=120)


def test_no_card_no_result():
    p = _run(ROOT)
    assert p.returncode == 2 and p.stdout.strip() == ""
    assert "needs 1 CUDA device" in p.stderr


def test_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    p = _run(str(tmp_path))
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("trace", [0, 1])
def test_result_shape(trace):
    cell = small_cell("viewer720p-flythrough-denoised")
    res = runner.run_cell(cell, 2**31 + 99, 0.5, bool(trace), "cpu",
                          time.monotonic())
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device", "compared"}
    assert list(res)[-1] == "compared"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    for name, c in res["compared"].items():
        assert set(c) == {"value", "limit"}
    json.dumps(res)
    d = res["device"]
    assert set(d) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(d) >= {"busy_s", "window_s"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        # The CPU runs no device work: only the host's build reads.
        assert set(res["metrics"]) == {"scene_build_s"}
    else:
        assert set(res["metrics"]) == set(
            metric_names(cell, "end_to_end")) == {"viewer_frame_p95_ms",
                                                  "setup_s"}
        for m in res["metrics"].values():
            assert m["value"] > 0
