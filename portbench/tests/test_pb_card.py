"""On the card: a small run of each cell through K1 comes out correct,
and the control does not; the viewer hall rendered two-level is judged
exact by the reference that follows ``render.instancing``."""

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


@pytest.mark.card
@pytest.mark.parametrize("name", ("viewer720p-flythrough-denoised",
                                  "viewer720p-flythrough-pathtrace"))
def test_two_level_viewer_hall_on_the_card(card, name):
    """The viewer hall as two-level buffers (222 instances, 24 BLASes) at
    the cell's 640 x 360: the port's frames through K2 (its warm-up frames
    and three flight frames) are judged 0.0 / 0.0 by the reference with
    ``render.instancing``, and the control on the same frames fails both
    limits. The frame times printed come from this side path, not from a
    cell."""
    from conftest import judged, two_level_cell, two_level_frames

    seed = 2**31 + 29
    cell = two_level_cell(name)
    warm, window, ms = two_level_frames(cell, seed, card, window_frames=3)
    print(f"\n{name} two-level: flight frame ms (step + blit) "
          + ", ".join(f"{v:.3f}" for v in ms))
    out = judged(cell, seed, card, warm, window)
    assert out["worst"] == {"image_rel_l1": 0.0, "blit_mean_abs": 0.0}, \
        out["frames"]
    ctl = control_readings(cell, seed, card, window_frames=3,
                           lowp=torch.bfloat16)
    print(f"{name} two-level control: {ctl['worst']}")
    for n, limit in cell.limits.items():
        assert ctl["worst"][n] > limit, (n, ctl["worst"])
