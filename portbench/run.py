#!/usr/bin/env python3
"""The benchmark of ``loupiote_tpu_torch`` on one NVIDIA H100.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The cell, its configuration and its
traffic mix are named in ``BENCHMARK.json``. Prints, as the last line of
its standard output, one JSON object: ``correct``, ``attempted`` (frames
in the timed window), ``failed`` (checked frames over a limit),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and last
``compared``: each number of the comparison with its limit, which also
end the standard error. Exits 2 with no result where there is no card
or fewer cards than the cell asks for, 3 where JAX or the JAX package
was loaded.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(BENCH_DIR, ".cache")


def _steady_environment() -> None:
    """One thread for the host's numerical libraries (the frame loop is
    one thread issuing work to the card), and every compiler cache the
    process may use at a fixed path inside the checkout (the port's own
    kernels are built into its ``_build/`` directory, also inside it)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _steady_environment()
    sys.path.insert(0, ROOT)
    from portbench.harness.cells import find_cell
    from portbench.harness.runner import log, run_cell

    cell = find_cell(args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"cuda available: {torch.cuda.is_available()}, devices: "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import loupiote_tpu_torch  # noqa: F401  (fails where the port is absent)
    from loupiote_tpu_torch import _build

    log(f"card: {_card_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; seed {args.seed}, {args.seconds} s, trace "
        f"{args.trace}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START)
    builds = {k: round(v["seconds"], 3) for k, v in _build.build_info.items()}
    log(f"nvcc seconds by source (0 or cached: built by an earlier run): "
        f"{builds}")
    if "exit" in result:
        log(result["why"])
        return result["exit"]
    for name, c in result["compared"].items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
