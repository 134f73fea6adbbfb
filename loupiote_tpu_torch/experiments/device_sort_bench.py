"""E4's path: ``treelet/device_sort.py`` (K4's network over one slab
spanning the array) against the library sort, ``torch.sort`` plus a
``gather`` of the payload, at wave scale (counterpart of the reference's
``device_sort_bench.py``, whose yardstick was ``lax.sort``).

Run on the card: ``python -m loupiote_tpu_torch.experiments.device_sort_bench
[n]``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..treelet.device_sort import device_sort
from . import require_card, time_probe

REPS = 4  # timed calls of each sort, after one warm-up


def library_sort(keys: torch.Tensor, vals: torch.Tensor):
    """The yardstick: ``torch.sort`` of the keys, the payload gathered
    along (ties in any order)."""
    ks, idx = torch.sort(keys)
    return ks, torch.gather(vals, 0, idx)


def inputs(n: int, device):
    """The reference's inputs: ``n`` keys in [0, 2**30) from
    ``default_rng(0)``, payload ``arange(n)``; numpy and on ``device``."""
    keys = np.random.default_rng(0).integers(0, 1 << 30, n, dtype=np.int32)
    return keys, torch.from_numpy(keys).to(device), torch.arange(
        n, dtype=torch.int32, device=device)


def main(n: int = 8_388_608, device="cuda") -> dict:
    """Time ``device_sort`` and the library sort (best of ``REPS`` calls
    after a warm-up, call ``i`` on ``keys ^ i`` as the reference does) and
    check ``device_sort``'s last output: keys sorted, each payload riding
    with its key. Returns ``{name: ms}`` and ``"correct"``."""
    require_card(device)
    keys_np, keys, vals = inputs(n, device)
    out = {}
    for name, fn in (("device_sort", device_sort), ("torch.sort+gather",
                                                    library_sort)):
        best, o = time_probe(fn, REPS, lambda i: (keys ^ i, vals))
        out[name] = best
        print(f"{name} n={n}: {best:.3f} ms", flush=True)
        if name == "device_sort":
            ks, vs = o[0].cpu().numpy(), o[1].cpu().numpy()
            ref = np.sort(keys_np ^ REPS)
            ok = bool((ks == ref).all()) and bool(
                ((keys_np ^ REPS)[vs] == ks).all())
            out["correct"] = ok
            print(f"  correct={ok}", flush=True)
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8_388_608)
