"""Intersection contract and dispatch (counterpart of
``loupiote_tpu/ops/intersect.py``).

Every scene the port builds carries the wide table, and every closest-hit
and shadow wave goes to the wide traversal (``ops/wide.py``): kernel K1 on
CUDA, its plain twin on CPU. That includes scenes under
``_WIDE_MIN_NODES`` BVH2 nodes, which the reference sends to its BVH2
kernels; those kernels are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

T_MIN = 1e-4
T_FAR = 1e30

# The reference's node count below which its BVH2 kernels beat the wide
# kernel on a TPU. The port routes those scenes to K1 until the BVH2
# kernels are ported; this threshold is to be re-measured on the H100 then.
_WIDE_MIN_NODES = 8192


class Hit(NamedTuple):
    """Per-ray intersection record."""

    t: torch.Tensor  # (R,) float32, tmax or T_FAR on a miss
    tri: torch.Tensor  # (R,) int32, -1 on a miss
    u: torch.Tensor  # (R,) float32 barycentric
    v: torch.Tensor  # (R,) float32 barycentric


def moller_trumbore(o, d, tri9):
    """Moller-Trumbore on broadcastable component tensors.

    ``o``, ``d``: (x, y, z) of the ray; ``tri9``: (p0x, p0y, p0z, e1x, ...,
    e2z). Every product is taken in the reference's order. Returns
    (u, v, t); t is 0 for a degenerate triangle (|det| <= 1e-12).
    """
    ox, oy, oz = o
    dx, dy, dz = d
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = tri9
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, 0.0)
    tvx = ox - p0x
    tvy = oy - p0y
    tvz = oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    return u, v, t


def recompute_uv(scene, ro, rd, tri):
    """Barycentrics of the winning triangle, recomputed once per ray (the
    traversal tracks only t and the triangle); 0 on a miss."""
    trow = scene.tri_pack[torch.clamp_min(tri, 0).to(torch.int64)]
    u, v, _ = moller_trumbore((ro[:, 0], ro[:, 1], ro[:, 2]),
                              (rd[:, 0], rd[:, 1], rd[:, 2]),
                              tuple(trow[:, j] for j in range(9)))
    miss = tri < 0
    return torch.where(miss, 0.0, u), torch.where(miss, 0.0, v)


def intersect_any(scene, ro, rd, tmax=None, active=None,
                  any_hit: bool = False) -> Hit:
    """Trace (R,) rays against the scene; ``active`` False rays miss."""
    from .wide import intersect_wide

    return intersect_wide(scene, ro, rd, tmax=tmax, active=active,
                          any_hit=any_hit)


def occluded(scene, ro, rd, dist, active=None) -> torch.Tensor:
    """Shadow query: True where the segment [T_MIN, dist) is blocked."""
    from .wide import occluded_wide

    return occluded_wide(scene, ro, rd, dist * (1.0 - 1e-3), active=active)
