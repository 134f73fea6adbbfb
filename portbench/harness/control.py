"""The control: the reference put in the program's place and computed in
the nearest precision below the configuration's float32, bfloat16 (its
wavefront state rounded to bfloat16 after every pass, the step a later
change might take to save bandwidth). Its frames go through the same
comparison as a run's, and must come out as not correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--frames 3] [--device cuda]

prints, for each seed, the worst of each compared number, as the upper
readings the limits are set below. The benchmark's own runs do not run
it.
"""

from __future__ import annotations

import torch

from . import inputs, judge
from .program import Capture
from .runner import make_inputs


def control_readings(cell, seed: int, device, window_frames: int = 3,
                     lowp=torch.bfloat16) -> dict:
    """The comparison's numbers for the control's frames of ``cell``:
    its warm-up frames and ``window_frames`` more, each from its own
    state, judged against the float32 reference."""
    from ..reference.session import Session

    traffic = cell.traffic
    scene, hdr = make_inputs(cell, seed)
    args = (scene, hdr, cell.config, traffic["mode"],
            bool(traffic["accumulate"]), seed, torch.device(device),
            float(traffic["dt"]))
    ref = Session(*args)
    ctl = Session(*args, lowp=lowp, tables=ref.tables)
    path = inputs.CameraPath(traffic["camera"], seed)
    warm = int(traffic["warmup_frames"])
    caps = []
    state = ctl.init_state()
    for k in range(1, warm + window_frames + 1):
        after = ctl.step(state, k, path.at(k),
                         path.at(k - 1) if k > 1 else None)
        caps.append(Capture(k, state, after, ctl.blit(after)))
        state = after
    return judge.judge(ref, caps[:warm], caps[warm:], path)
