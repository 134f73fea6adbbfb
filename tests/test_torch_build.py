"""The kernel-call layer of ``loupiote_tpu_torch/_build.py``: one call path
for every CUDA entry point (its signature declared once for each loaded
library, tensors as pointers, None as a null pointer, the current stream
inserted, the error words on a non-zero return, the launch counted), the
one ``reset_counters``, and the two lowest layers, ``_build`` and
``spans``, importing nothing above them.

The entry point is a stand-in that runs a Python body through ctypes with
the argument types the layer declares, so each argument is converted as
for a library built from ``csrc/``.
"""

import ast
import ctypes
import os
from types import SimpleNamespace

import pytest
import torch

from loupiote_tpu_torch import _build, spans
from loupiote_tpu_torch.experiments import kernel_probe  # noqa: F401
from loupiote_tpu_torch.ops import bvh2, wide  # noqa: F401
from loupiote_tpu_torch.treelet import lane_bottom, lane_top  # noqa: F401
from loupiote_tpu_torch.treelet import pipeline

PKG = os.path.dirname(_build.__file__)


class StubEntry:
    """A C entry point: counts the declarations of its signature and runs
    ``body`` through a ctypes function of the declared types."""

    def __init__(self, body):
        self.body = body
        self.restype = None
        self.declared = 0
        self._argtypes = None

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, types):
        self.declared += 1
        self._argtypes = types

    def __call__(self, *args):
        proto = ctypes.CFUNCTYPE(self.restype, *self._argtypes)
        return proto(self.body)(*args)


@pytest.fixture
def stub(monkeypatch):
    """A loaded library "stub" whose entry ``scale`` (pointer, pointer,
    int, stream, int pointer) records its arguments and returns the int
    as its error code."""
    seen = []

    def body(src, dst, code, stream, made):
        seen.append((src, dst, code, stream))
        made[0] = 3
        return code

    lib = SimpleNamespace(scale=StubEntry(body))
    monkeypatch.setitem(_build._libs, "stub", lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=4096))
    _build.reset_counters()
    yield lib, seen
    _build.reset_counters()


def test_call_path_converts_declares_once_counts_and_raises(stub,
                                                            monkeypatch):
    lib, seen = stub
    x = torch.zeros(8)
    made = ctypes.c_int(0)
    for mode in ("closest", "closest", "anyhit"):
        _build.launch("stub", "scale", "2pisn", x, None, 0,
                      ctypes.byref(made), mode=mode)
    # A tensor passes its pointer, None a null pointer, the stream goes
    # where the signature has it, a ctypes object passes unchanged.
    assert seen == [(x.data_ptr(), None, 0, 4096)] * 3
    assert made.value == 3
    assert lib.scale.declared == 1
    assert _build.launches == {("scale", "closest"): 2,
                               ("scale", "anyhit"): 1}
    with pytest.raises(RuntimeError,
                       match=r"^scale launch failed: CUDA error 7$"):
        _build.launch("stub", "scale", "2pisn", x, x, 7, ctypes.byref(made))
    with pytest.raises(RuntimeError,
                       match=r"^scale occupancy query: CUDA error 9$"):
        _build.call("stub", "scale", "2pisn", x, x, 9, ctypes.byref(made),
                    what="scale occupancy query")
    with pytest.raises(TypeError, match="arguments"):
        _build.call("stub", "scale", "2pisn", x, x, 0)
    # Failed and uncounted calls add nothing.
    assert sum(_build.launches.values()) == 3
    # A library loaded again (hot reload) has its signature declared anew.
    again = SimpleNamespace(scale=StubEntry(lib.scale.body))
    monkeypatch.setitem(_build._libs, "stub", again)
    _build.call("stub", "scale", "2pisn", x, None, 0, ctypes.byref(made))
    assert (lib.scale.declared, again.scale.declared) == (1, 1)


def test_one_reset_zeroes_launches_and_kernel_counters_not_recordings():
    """``reset_counters`` zeroes the launch registry and every kernel's
    device counter (the step-bound counters of K1, K2/K3, E6 and E7, E1's
    dropped pushes, the treelet fallback); a recording keeps its counts."""
    assert set(_build._kernel_counters) == {
        "wide_traverse.capped", "bvh2_traverse.capped", "lane_top.capped",
        "lane_bottom.capped", "kernel_probe.dropped", "treelet.fallback"}
    _build.launches["wide_traverse", "closest"] += 2
    for c in _build._kernel_counters.values():
        c.tensor("cpu").add_(5)
    assert pipeline.fallback_rays("cpu") == wide.capped_rays("cpu") == 5
    with spans.recording() as rec:
        spans.count("tlas", "visit", 2)
        rec.count_device("live", "step", torch.tensor(7))
        _build.reset_counters()
    assert rec.counts == {("tlas", "visit"): 2, ("live", "step"): 7}
    assert not _build.launches
    assert all(c.read("cpu") == 0 for c in _build._kernel_counters.values())


def _package_imports(name: str) -> set:
    """The package's modules that ``loupiote_tpu_torch/<name>.py`` imports,
    by their first name under the package."""
    with open(os.path.join(PKG, name + ".py")) as f:
        tree = ast.parse(f.read())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            found |= ({node.module.split(".")[0]} if node.module
                      else {a.name for a in node.names})
        elif isinstance(node, ast.ImportFrom) and node.module:
            parts = node.module.split(".")
            if parts[0] == "loupiote_tpu_torch":
                found.add(parts[1] if len(parts) > 1 else "")
        elif isinstance(node, ast.Import):
            for a in node.names:
                parts = a.name.split(".")
                if parts[0] == "loupiote_tpu_torch":
                    found.add(parts[1] if len(parts) > 1 else "")
    return found


@pytest.mark.parametrize("name, allowed", [("_build", set()),
                                           ("spans", {"_build"})])
def test_lowest_layers_import_nothing_above(name, allowed):
    assert _package_imports(name) <= allowed
