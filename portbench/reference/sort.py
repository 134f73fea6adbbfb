"""Ray sort keys: a frozen copy of the port's
``loupiote_tpu_torch/ops/sort.py``.

torch has thin ``uint32`` support, so keys are int64 tensors holding the
reference's uint32 values; ``DEAD_KEY`` sorts dead rays last.
"""

from __future__ import annotations

import torch

DEAD_KEY = 0xFFFFFFFF


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """Interleave 10 bits with two zero bits each (Morton component)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton3(p: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
            bits: int = 10) -> torch.Tensor:
    """(R,3) positions -> 3*bits-bit Morton codes within [lo, hi] (int64)."""
    q = torch.clamp((p - lo) / torch.clamp_min(hi - lo, 1e-9), 0.0, 1.0)
    scale = (1 << bits) - 1
    qi = (q * scale).to(torch.int64)
    return ((_spread3(qi[:, 0]) << 2) | (_spread3(qi[:, 1]) << 1)
            | _spread3(qi[:, 2]))


def direction_octant(d: torch.Tensor) -> torch.Tensor:
    return (((d[:, 0] > 0).to(torch.int64) << 2)
            | ((d[:, 1] > 0).to(torch.int64) << 1)
            | (d[:, 2] > 0).to(torch.int64))


def ray_sort_key(ro: torch.Tensor, rd: torch.Tensor, alive: torch.Tensor,
                 lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Coherence key: direction octant major, 9-bit origin Morton minor;
    dead rays get ``DEAD_KEY``."""
    m = morton3(ro, lo, hi, bits=9) & 0x7FFFFFF
    key = (direction_octant(rd) << 27) | m
    return torch.where(alive, key, DEAD_KEY)


def sort_order(key: torch.Tensor) -> torch.Tensor:
    """Stable argsort, as ``jnp.argsort``: equal keys (shared Morton cells,
    every dead ray) keep their slot order."""
    return torch.argsort(key, stable=True)
