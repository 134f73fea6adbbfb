"""Shared set-up of the benchmark's own tests (``python -m pytest
portbench/tests``): the repository's root on ``sys.path``, the ``card``
marker, and small cells for CPU runs of the harness."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the kernels on the card")
    return torch.device("cuda")


def small_cell(name: str, triangles: int = 100_000, scale: int = 1):
    """The cell ``name`` at a CPU size: its scene's triangle budget (over
    the integrator's 16,384-node sort gate at 100,000), a window of 128 x
    64 internal pixels (8 x 128 tiles) times ``scale``, a 64 x 128 sky."""
    from portbench.harness.cells import find_cell

    cell = find_cell(name)
    cfg = cell.config
    cfg["scene"]["triangles"] = triangles
    f = cfg["render"]["downsample_factor"]
    cfg["window"] = [int(128 * scale / f), int(64 * scale / f)]
    if cfg["scene"].get("sky"):
        cfg["scene"]["sky"] = {"height": 64, "width": 128}
    return cell
