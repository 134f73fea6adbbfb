"""Intersection contract and dispatch (counterpart of
``loupiote_tpu/ops/intersect.py``).

Scenes under ``_WIDE_MIN_NODES`` BVH2 nodes go to the BVH2 kernels
(``ops/bvh2.py``): K2 for closest-hit and any-hit waves, K3 for shadow
waves. Larger scenes go to the wide traversal (``ops/wide.py``, K1). Each
runs its CUDA kernel on CUDA tensors and its plain twin on CPU tensors,
for any ray count: the reference's padding to 1024-ray packets, its SIMT
path for tiny batches and its ``_WIDE_MAX_BYTES`` VMEM ceiling are TPU
matters and are not ported. A scene that carries treelet tables
(``SceneBuffers.treelet``) sends ``intersect_any`` to the treelet
traversal; ``occluded`` does not take it, as in the reference. A
two-level instanced scene (``SceneBuffers.inst_w2o``) sends both to the
instance loop (``scene/instanced.py``), which walks the meshes this
dispatch sends to K2 inside its own kernel and the others through K1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

T_MIN = 1e-4
T_FAR = 1e30

# The reference's node count below which its BVH2 kernels beat the wide
# kernel on a TPU. Kept as it is; chip_smoke.py times K1 against K2/K3 on
# the same arch-40k waves so that the threshold can be re-measured.
_WIDE_MIN_NODES = 8192


class Hit(NamedTuple):
    """Per-ray intersection record."""

    t: torch.Tensor  # (R,) float32, tmax or T_FAR on a miss
    tri: torch.Tensor  # (R,) int32, -1 on a miss
    u: torch.Tensor  # (R,) float32 barycentric
    v: torch.Tensor  # (R,) float32 barycentric
    # (R,) int32 instance of the hit, -1 on a miss: instanced scenes only.
    inst: Optional[torch.Tensor] = None


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


def ray_args(ro, rd, tmax, active):
    """Contiguous (ro, rd, tmax, active) with the defaults filled in:
    tmax T_FAR, every ray active."""
    R = ro.shape[0]
    t0 = (torch.full((R,), T_FAR, dtype=torch.float32, device=ro.device)
          if tmax is None else tmax.contiguous())
    act = (torch.ones(R, dtype=torch.bool, device=ro.device)
           if active is None else active.contiguous())
    return ro.contiguous(), rd.contiguous(), t0, act


def uses_bvh2(scene) -> bool:
    """True where the dispatch sends ``scene`` to the BVH2 kernels (K2 /
    K3), False where to the wide one (K1)."""
    return scene.num_nodes < _WIDE_MIN_NODES


def _instanced(scene) -> bool:
    return getattr(scene, "inst_w2o", None) is not None


def path_libraries(scene) -> list:
    """The ``csrc/`` libraries that ``intersect_any`` and ``occluded`` load
    for ``scene`` on the card, as this dispatch picks them (an instanced
    scene: the two-level kernel for its BLASes on K2, K1 for the
    others)."""
    if _instanced(scene):
        libs = ["tlas_traverse" if uses_bvh2(b) else "wide_traverse"
                for b in scene.blas]
        return list(dict.fromkeys(libs))
    libs = ["bvh2_traverse" if uses_bvh2(scene) else "wide_traverse"]
    if scene.treelet is not None:
        from ..treelet.pipeline import LIBRARIES

        libs += list(LIBRARIES)
    return libs


def intersect_any(scene, ro, rd, tmax=None, active=None,
                  any_hit: bool = False) -> Hit:
    """Trace (R,) rays against the scene; ``active`` False rays miss.
    Instanced scenes take the instance loop; scenes built with
    ``treelets=True`` the treelet traversal in both modes
    (``treelet/pipeline.py``)."""
    if _instanced(scene):
        from ..scene.instanced import intersect_instanced

        return intersect_instanced(scene, ro, rd, tmax=tmax, active=active,
                                   any_hit=any_hit)
    if scene.treelet is not None:
        from ..treelet.pipeline import treelet_intersect

        return treelet_intersect(scene, ro, rd, tmax=tmax, active=active,
                                 any_hit=any_hit)
    if uses_bvh2(scene):
        from .bvh2 import intersect_bvh2

        return intersect_bvh2(scene, ro, rd, tmax=tmax, active=active,
                              any_hit=any_hit)
    from .wide import intersect_wide

    return intersect_wide(scene, ro, rd, tmax=tmax, active=active,
                          any_hit=any_hit)


def occluded(scene, ro, rd, dist, active=None) -> torch.Tensor:
    """Shadow query: True where the segment [T_MIN, dist) is blocked."""
    if _instanced(scene):
        from ..scene.instanced import occluded_instanced

        return occluded_instanced(scene, ro, rd, dist, active=active)
    tmax = dist * (1.0 - 1e-3)
    if uses_bvh2(scene):
        from .bvh2 import occluded_bvh2

        return occluded_bvh2(scene, ro, rd, tmax, active=active)
    from .wide import occluded_wide

    return occluded_wide(scene, ro, rd, tmax, active=active)
