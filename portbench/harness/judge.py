"""The comparison that decides a run's ``correct``.

The reference (``portbench/reference``) renders again the frames the
program rendered, from the benchmark's own inputs and the run's seed:

- the start: the warm-up frames, each from the reference's own state,
  from an empty one on, so the state carried from frame to frame (the
  running average, A-SVGF's history) is checked by itself;
- frames of the timed window (its first, one drawn from the seed, its
  last), each from the state the program left before it: the
  reference works out the frame's camera, random numbers, rays, hits,
  shading and accumulation or denoising again; only the running
  average or the denoiser's history comes from the program, as a user's
  next frame would take it.

Two numbers are compared, each the worst over the checked frames:

- ``image_rel_l1``: the sum over pixels and channels of |program -
  reference| of the displayed radiance (the running average, or the
  denoiser's output), over the sum of |reference|; for a frame that adds
  to a running average, over the sum of what the reference adds to it,
  so that a frame left out of the average reads 1;
- ``blit_mean_abs``: the mean absolute difference, in 8-bit levels, of
  the image ``blit`` returned and the reference's blit of its own frame.
"""

from __future__ import annotations

import math
from dataclasses import fields

import numpy as np
import torch

from ..reference.frame import RenderState

NUMBERS = ("image_rel_l1", "blit_mean_abs")


def _rel_l1(prog: torch.Tensor, ref: torch.Tensor, base: torch.Tensor) -> float:
    num = (prog.to(ref.device, torch.float64)
           - ref.to(torch.float64)).abs().sum().item()
    den = base.to(torch.float64).abs().sum().item()
    if not math.isfinite(num):
        return math.inf
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def _blit_mad(prog: np.ndarray, ref: np.ndarray) -> float:
    if prog.shape != ref.shape:
        return math.inf
    return float(np.abs(prog.astype(np.int16) - ref.astype(np.int16)).mean())


def as_reference_state(state) -> RenderState:
    """The program's frame state as the reference's ``RenderState``: the
    same fields, by name, the same tensors (nothing copied)."""
    return RenderState(**{f.name: getattr(state, f.name)
                          for f in fields(RenderState)})


def check_frame(ref, k: int, before_ref, after_prog, blit_prog, path):
    """(numbers, the reference's state after frame ``k``). ``before_ref``:
    the state the reference steps from: its own for the start, the
    program's for a window frame."""
    prev_cam = path.at(k - 1) if k > 1 else None
    after_ref = ref.step(before_ref, k, path.at(k), prev_cam)
    out_ref = ref.image(after_ref)
    out_prog = ref.image(after_prog)
    accumulating = (ref.mode == "pathtrace" and ref.accumulate
                    and before_ref.frame_count > 1)
    if accumulating:
        base = out_ref - ref.image(before_ref).to(out_ref.device)
    else:
        base = out_ref
    nums = {"image_rel_l1": _rel_l1(out_prog, out_ref, base),
            "blit_mean_abs": _blit_mad(blit_prog, ref.blit(after_ref))}
    return nums, after_ref


def judge(ref, warmup: list, window: list, path) -> dict:
    """Each frame's numbers and the worst of each: ``warmup`` and
    ``window`` are the program's ``Capture``s."""
    per_frame = []
    state = ref.init_state()
    for cap in warmup:
        nums, state = check_frame(ref, cap.k, state, cap.after, cap.blit,
                                  path)
        per_frame.append((cap.k, "start", nums))
    del state
    for cap in sorted(window, key=lambda c: c.k):
        nums, _ = check_frame(ref, cap.k, as_reference_state(cap.before),
                              cap.after, cap.blit, path)
        per_frame.append((cap.k, "window", nums))
    worst = {n: max((f[2][n] for f in per_frame), default=math.inf)
             for n in NUMBERS}
    return {"frames": per_frame, "worst": worst}


def verdict(worst: dict, limits: dict) -> bool:
    return all(n in worst and math.isfinite(worst[n])
               and worst[n] <= limits[n] for n in limits)
