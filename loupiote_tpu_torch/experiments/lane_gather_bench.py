"""E2: the per-lane gather probe (``csrc/lane_gather.cu``) and its plain
torch twin (counterpart of the reference's ``lane_gather_bench.py``:
``run``, the Pallas ``_kernel``).

Each lane of an (8, 128) block walks its own node sequence over a
1,024-entry table of seven fields (min.xyz, max.xyz and a link word
``hit | miss << 16``): ``steps`` steps of a slab test whose ``tn`` it
accumulates, moving to the hit link on a hit and to the miss link
otherwise, modulo 1,024. Every lane starts at its index within its
128-lane row, so the 8 rows of a block start alike. ``inv`` keeps no
sign: ``1 / where(|d| > 1e-20, d, 1e-20)``. min and max return NaN where
an operand is NaN, as the reference's ``jnp.minimum`` / ``maximum`` do, so
a lane with a NaN slab term takes the miss link and sums NaN.

Run on the card:
``python -m loupiote_tpu_torch.experiments.lane_gather_bench``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .._build import check_args, on_card
from . import require_card, time_probe

SUB, SUBP = 8, 128
ENTRIES = SUB * SUBP
STEPS = (64, 512, 4096)
BLOCKS = 128  # the reference's grid: 128 blocks of 1,024 lanes
SEED = 3
REPS = 4  # timed calls at each step count, after one warm-up


def _inv(d: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(d.abs() > 1e-20, d, 1e-20)


def lane_gather_plain(tab, ox, oy, oz, dx, dy, dz, *, steps: int):
    """Plain torch walk, vectorised over every lane. ``tab`` (7, 8, 128)
    float32 (field 6 the link's int32 bits); rays (G, 8, 128) float32.
    Returns the (G, 8, 128) float32 accumulated ``tn``."""
    shape = ox.shape
    flat = tab.reshape(7, ENTRIES)
    link = flat[6].view(torch.int32)
    o = [x.reshape(-1) for x in (ox, oy, oz)]
    inv = [_inv(x.reshape(-1)) for x in (dx, dy, dz)]
    lane = torch.arange(o[0].numel(), device=ox.device) % SUBP
    cur = lane
    acc = torch.zeros_like(o[0])
    for _ in range(steps):
        t1 = [(flat[a, cur] - o[a]) * inv[a] for a in range(3)]
        t2 = [(flat[a + 3, cur] - o[a]) * inv[a] for a in range(3)]
        tn = torch.maximum(torch.maximum(torch.minimum(t1[0], t2[0]),
                                         torch.minimum(t1[1], t2[1])),
                           torch.minimum(t1[2], t2[2]))
        tf = torch.minimum(torch.minimum(torch.maximum(t1[0], t2[0]),
                                         torch.maximum(t1[1], t2[1])),
                           torch.maximum(t1[2], t2[2]))
        ln = link[cur]
        hit = tf >= torch.clamp_min(tn, 0.0)
        nxt = torch.where(hit, ln & 0xFFFF, (ln >> 16) & 0xFFFF)
        cur = (nxt & (ENTRIES - 1)).to(torch.int64)
        acc = acc + tn
    return acc.view(shape)


def _launch(tab, ox, oy, oz, dx, dy, dz, *, steps: int):
    dev = ox.device
    shape = tuple(ox.shape)
    if len(shape) != 3 or shape[1:] != (SUB, SUBP):
        raise ValueError(f"lane_gather: rays must be (G, 8, 128), got {shape}")
    check_args(dev, [("tab", tab, torch.float32, (7, SUB, SUBP))]
               + [(nm, x, torch.float32, shape) for nm, x in
                  (("ox", ox), ("oy", oy), ("oz", oz), ("dx", dx), ("dy", dy),
                   ("dz", dz))])
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    _build.launch("lane_gather", "lane_gather", "8p2is", tab, ox, oy, oz, dx,
                  dy, dz, out, shape[0], int(steps))
    return out


def run(tab, ox, oy, oz, dx, dy, dz, *, steps: int):
    """E2 on CUDA tensors, the plain twin on CPU tensors."""
    fn = _launch if on_card(ox) else lane_gather_plain
    return fn(tab, ox, oy, oz, dx, dy, dz, steps=steps)


def inputs(G: int = BLOCKS, *, high_links: bool = False,
           nonfinite: bool = False):
    """The reference's numpy inputs (``default_rng(SEED)``, drawn in its
    order): the (7, 8, 128) table with random links and (G, 8, 128)
    origins in [0, 1) and directions in [-0.5, 0.5).

    Edge cases, drawn after those from ``default_rng(SEED + 1)``:
    ``high_links`` gives every link half random bits above 1,023 (the walk
    keeps ``& 1023`` of each); ``nonfinite`` sets about one lane in eight
    of each origin component to +inf, -inf or NaN and of each direction
    component to +inf, -inf, -0, 1e-30 or -1e-30."""
    rng = np.random.default_rng(SEED)
    tab = rng.random((7, SUB, SUBP), np.float32)
    links = (rng.integers(0, 1024, (SUB, SUBP)).astype(np.uint32)
             | (rng.integers(0, 1024, (SUB, SUBP)).astype(np.uint32) << 16))
    tab[6] = links.view(np.float32)
    shp = (G, SUB, SUBP)
    ox, oy, oz = (rng.random(shp, np.float32) for _ in range(3))
    dx, dy, dz = (rng.random(shp, np.float32) - 0.5 for _ in range(3))
    edge = np.random.default_rng(SEED + 1)
    if high_links:
        hi = edge.integers(1, 64, (2, SUB, SUBP)).astype(np.uint32) << 10
        tab[6] = (links | hi[0] | (hi[1] << 16)).view(np.float32)
    if nonfinite:
        origins = np.array([np.inf, -np.inf, np.nan], np.float32)
        dirs = np.array([np.inf, -np.inf, -0.0, 1e-30, -1e-30], np.float32)
        for arr, vals in ((ox, origins), (oy, origins), (oz, origins),
                          (dx, dirs), (dy, dirs), (dz, dirs)):
            pick = edge.random(shp) < 0.125
            arr[pick] = edge.choice(vals, int(pick.sum()))
    return tab, ox, oy, oz, dx, dy, dz


def main(device="cuda") -> dict:
    """Time the kernel on ``BLOCKS`` blocks at 64, 512 and 4,096 steps
    (best of ``REPS`` calls after a warm-up, CUDA events) and print the
    per-step slope. Returns ``{"ms": {steps: ms}, "per_step_ns",
    "ref_per_block_ns", "per_visit_ns"}``."""
    require_card(device)
    args = [torch.from_numpy(a).to(device) for a in inputs()]
    times = {}
    for steps in STEPS:
        best, out = time_probe(lambda: run(*args, steps=steps), REPS)
        times[steps] = best
        print(f"steps={steps}: {best:.4f} ms total  (checksum "
              f"{float(out.sum()):.4e})", flush=True)
    # The slope removes launch overhead: one step of every lane of every
    # block, which all run at once on the card.
    per_step_ns = (times[4096] - times[512]) * 1e6 / (4096 - 512)
    # The reference divides by its grid, whose cells ran one after another
    # on the TPU: kept under its own name, to set beside the TPU's.
    ref_per_block_ns = per_step_ns / BLOCKS
    per_visit_ns = ref_per_block_ns / ENTRIES
    print(f"step of all {BLOCKS} x {ENTRIES} lanes (7-field gather + slab + "
          f"control): {per_step_ns:.3f} ns", flush=True)
    print(f"the reference's per-block figure (slope / {BLOCKS}): "
          f"{ref_per_block_ns:.3f} ns", flush=True)
    print(f"=> per ray-visit: {per_visit_ns:.5f} ns", flush=True)
    return {"ms": times, "per_step_ns": per_step_ns,
            "ref_per_block_ns": ref_per_block_ns,
            "per_visit_ns": per_visit_ns}


if __name__ == "__main__":
    main()
