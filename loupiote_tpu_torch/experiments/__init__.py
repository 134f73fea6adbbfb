"""The reference's probe scripts, each an entry point of its own (the
counterparts of the top-level scripts of the reference's experiment
directory, as ``treelet/`` is of its treelet subdirectory):

- ``measure_traversal.py``: the arch-260k scene and its 1080p primary and
  diffuse waves (``build``, ``make_waves``);
- ``kernel_probe.py``: E1, the sub-packet traversal step-cost probe
  (``csrc/kernel_probe.cu``) in five variants;
- ``lane_gather_bench.py``: E2, the per-lane table-walk probe
  (``csrc/lane_gather.cu``);
- ``r3_probes.py``: E3, ten op-latency probes on one (8, 128) tile
  (``csrc/r3_probes.cu``), and the plain torch sort / permutation probes;
- ``device_sort_bench.py``: E4, ``treelet/device_sort.py`` (K4's network
  over one slab spanning the array) against ``torch.sort``.

Run each with ``python -m loupiote_tpu_torch.experiments.<name>``; each
needs a card. Nothing here runs at import time.
"""

import torch


def require_card(device) -> torch.device:
    """``device`` as a CUDA device; raises where it is not one or there is
    no card: the probes time the CUDA kernels and have no CPU path."""
    d = torch.device(device)
    if d.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"this probe times a CUDA kernel and needs a "
                           f"card; got device {device!r}, CUDA available: "
                           f"{torch.cuda.is_available()}")
    return d


def time_probe(fn, reps: int, make_input=None):
    """``(best device ms, last output)`` of ``reps`` calls of ``fn`` after
    one warm-up call, each timed with CUDA events. Call ``i`` (0 the
    warm-up) gets ``*make_input(i)`` where that is given, no arguments
    otherwise."""
    args = make_input or (lambda i: ())
    out = fn(*args(0))
    best = float("inf")
    for i in range(1, reps + 1):
        a = args(i)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best, out
