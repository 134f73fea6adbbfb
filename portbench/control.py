#!/usr/bin/env python3
"""The control's readings on the card (see ``harness/control.py``).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--frames 3] [--device cuda]
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench.harness.cells import find_cell
    from portbench.harness.control import control_readings

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = find_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = control_readings(cell, seed, args.device, args.frames)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "worst": out["worst"],
                          "frames": out["frames"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
