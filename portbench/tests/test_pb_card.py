"""On the card: a small run of each cell through K1 comes out correct,
and the control does not."""

import time

import pytest
import torch

from conftest import small_cell
from portbench.harness import judge, runner
from portbench.harness.control import control_readings

CELLS = ("hall260k-1080p-progressive", "viewer720p-flythrough-denoised",
         "viewer720p-flythrough-pathtrace")


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_small_run_on_the_card(card, name):
    cell = small_cell(name, scale=2)
    res = runner.run_cell(cell, 2**31 + 17, 1.0, False, card,
                          time.monotonic())
    assert res["device"]["platform"] == "gpu"
    assert res["correct"] is True, res["compared"]
    out = control_readings(cell, 2**31 + 17, card, window_frames=2,
                           lowp=torch.bfloat16)
    assert judge.verdict(out["worst"], cell.limits) is False
