#!/usr/bin/env python3
"""Device time of each launch of the slab sort K4's plan on one GPU.

    python3 scripts/slab_sort_steps.py

For the two shapes that run K4 (the treelet primary wave's 8,294,400
pair keys in 127 slabs of 2^16 with one payload, and E4's one slab of
2^23 keys with one payload), runs every step of
``ops/slab_sort.py::launch_plan`` alone on the matrix, in the plan's
order, and prints its best device time over ``REPS`` runs
(``experiments.time_probe``: CUDA events, after a warm-up) beside the
time one read and one write of the matrix take at 3.35 TB/s; then the
whole plan, and the sorted matrix against ``slab_sort_plain``. Needs
CUDA; fails without it.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

REPS = 10
PEAK_BYTES_S = 3.35e12


def report(ss, time_probe, name, mat, c_log):
    import torch

    from loupiote_tpu_torch import _build

    span, b = ss._shape(c_log, mat.shape[0] - 1)
    plan = ss.launch_plan(c_log, mat.shape[0] - 1)
    io_ms = 2 * mat.numel() * 4 / PEAK_BYTES_S * 1e3
    print(f"{name}: {mat.shape[1]} keys, {mat.shape[0] - 1} payload, c_log "
          f"{c_log}; clusters of {1 << (span - b)} blocks of 2^{b} keys; "
          f"{len(plan)} launches; one read and one write of the matrix "
          f"{io_ms:.4f} ms", flush=True)
    work = mat.clone()
    total = 0.0
    for step in plan:
        ms = time_probe(lambda: ss._run_plan(work, c_log, [step]), REPS)[0]
        total += ms
        print(f"  {step}: {ms:.4f} ms", flush=True)
    whole = time_probe(lambda: ss._run_plan(work, c_log, plan), REPS)[0]
    check = mat.clone()
    before = _build.launches["slab_sort", "cuda_launches"]
    ss._run_plan(check, c_log, plan)
    made = _build.launches["slab_sort", "cuda_launches"] - before
    same = bool(torch.equal(check, ss.slab_sort_plain(mat.clone(), c_log)))
    print(f"  steps summed {total:.4f} ms; the plan in one call {whole:.4f} "
          f"ms ({made} CUDA launches made); equal to slab_sort_plain "
          f"{same}", flush=True)
    if not same or made != len(plan):
        raise SystemExit("slab_sort_steps: K4 disagrees with its plain "
                         "version or skipped a launch")


def main():
    import torch

    from loupiote_tpu_torch.experiments import time_probe
    from loupiote_tpu_torch.ops import slab_sort as ss

    if not torch.cuda.is_available():
        raise SystemExit("slab_sort_steps: needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    n = 8_294_400  # the treelet primary wave's pairs: keys are subtree ids
    key = torch.randint(0, 481, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    mat, c_log = ss.pack(key, [torch.arange(n, device=dev,
                                            dtype=torch.int32)])
    report(ss, time_probe, "treelet shape", mat, c_log)
    n4 = 1 << 23  # E4: one slab of the reference's 8,388,608 keys
    key4 = torch.randint(0, 1 << 30, (n4,), generator=g, device=dev,
                         dtype=torch.int32)
    mat4, c4 = ss.pack(key4, [torch.arange(n4, device=dev,
                                            dtype=torch.int32)], slab_log=64)
    report(ss, time_probe, "E4 shape", mat4, c4)
    print(smi)


if __name__ == "__main__":
    main()
