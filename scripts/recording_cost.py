#!/usr/bin/env python3
"""What the program's recording (``loupiote_tpu_torch/spans.py``) costs a
frame of a benchmark cell, on the card.

    python3 scripts/recording_cost.py [CELL] [--pairs N] [--seed S]

Builds the cell's session as ``portbench/run.py`` does (its inputs from
the seed, the app's ``Driver`` through its loaders), renders its warm-up
frames, then ``N`` pairs of frames (default 150), one with no recording
on and one inside ``spans.recording()``, the order alternating from pair
to pair so that the host's drift falls on both sides alike. Each frame is
``step`` + ``blit`` timed on the host clock with the device drained after
it. Prints the medians of both sides, the ratio of their sums, and the
median and quartiles of the per-pair ratio on / off, with the card's
name and power limit. Default cell: the two-level viewer flight
(``viewer720p-instanced-flythrough-pathtrace``), whose ~430 ``blas``
spans a frame make it the recording's dearest.
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cell", nargs="?",
                    default="viewer720p-instanced-flythrough-pathtrace")
    ap.add_argument("--pairs", type=int, default=150)
    ap.add_argument("--seed", type=int, default=3000002499)
    args = ap.parse_args(argv)

    import torch

    from loupiote_tpu_torch import spans
    from portbench.harness import program, runner
    from portbench.harness.cells import find_cell

    if not torch.cuda.is_available():
        raise SystemExit("recording_cost: needs an NVIDIA GPU")
    torch.set_num_threads(1)  # as the benchmark's runs
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    cell = find_cell(args.cell)
    scene, hdr = runner.make_inputs(cell, args.seed)
    session = program.build(cell, scene, hdr, args.seed, dev)
    for _ in range(int(cell.traffic["warmup_frames"])):
        session.frame()
    torch.cuda.synchronize(dev)

    def timed(on: bool) -> float:
        t0 = time.perf_counter()
        if on:
            with spans.recording():
                session.frame()
                torch.cuda.synchronize(dev)
        else:
            session.frame()
            torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3

    off, on = [], []
    for i in range(args.pairs):
        if i % 2 == 0:
            off.append(timed(False))
            on.append(timed(True))
        else:
            on.append(timed(True))
            off.append(timed(False))
    ratios = [b / a for a, b in zip(off, on)]
    q = statistics.quantiles(ratios, n=4)
    print(f"{args.cell}, seed {args.seed} ({smi}): {args.pairs} pairs "
          f"(order alternating within pairs); frame ms median off "
          f"{statistics.median(off):.3f}, on {statistics.median(on):.3f}; "
          f"sum on / sum off {sum(on) / sum(off):.4f}; median pair ratio "
          f"{statistics.median(ratios):.4f}; quartiles of the pair ratio "
          f"[{q[0]:.4f}, {q[1]:.4f}, {q[2]:.4f}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
