"""``correct`` comes out false when the timed path is broken underneath
(each fault a cell of one card can have) and when the control, the
reference in bfloat16, takes the program's place; it comes out true on
the sound program. The harness runs on the CPU here, past its look for a
card, at a small size."""

import time

import pytest
import torch

from conftest import small_cell
from portbench.harness import judge, runner
from portbench.harness.control import control_readings

SEED = 2**31 + 4242
CELLS = ("hall260k-1080p-progressive", "viewer720p-flythrough-denoised")


def _run(name):
    cell = small_cell(name)
    return runner.run_cell(cell, SEED, 0.3, False, "cpu", time.monotonic())


def _patch_sample(monkeypatch, fn):
    """Replace each frame's traced sample where the integrator produces
    it: ``fn(radiance (R, 3)) -> radiance``."""
    from loupiote_tpu_torch.render import renderer

    orig = renderer.trace_paths

    def broken(*a, **kw):
        rad, gb = orig(*a, **kw)
        return fn(rad.clone()), gb

    monkeypatch.setattr(renderer, "trace_paths", broken)


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct(name):
    res = _run(name)
    assert res["correct"] is True
    assert all(c["value"] == 0.0 for c in res["compared"].values())


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged(monkeypatch, name):
    from loupiote_tpu_torch.render.renderer import Renderer

    monkeypatch.setattr(Renderer, "raytrace", lambda self, view: None)
    assert _run(name)["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_half_the_pixels_left_out(monkeypatch, name):
    def half(rad):
        n = rad.shape[0] // 2
        rad[n:] = rad[:n].mean(dim=0)
        return rad

    _patch_sample(monkeypatch, half)
    assert _run(name)["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_answer_altered(monkeypatch, name):
    def altered(rad):
        rad[:1024] *= 2.0  # one 8 x 128 tile of each frame
        return rad

    _patch_sample(monkeypatch, altered)
    assert _run(name)["correct"] is False


@pytest.mark.parametrize("name", CELLS + ("viewer720p-flythrough-pathtrace",))
def test_control_is_not_correct(name):
    cell = small_cell(name)
    out = control_readings(cell, SEED, "cpu", window_frames=2,
                           lowp=torch.bfloat16)
    assert judge.verdict(out["worst"], cell.limits) is False
    assert out["worst"]["image_rel_l1"] > 10 * cell.limits["image_rel_l1"]
