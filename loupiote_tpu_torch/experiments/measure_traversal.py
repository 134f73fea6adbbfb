"""The arch-260k scene and its 1080p waves, the inputs of the traversal
probes (counterpart of the reference's ``measure_traversal.py``; only
``build`` and ``make_waves`` are ported, which are what ``kernel_probe``
needs).

The reference draws the jitter and the diffuse directions with
``jax.random``; the port draws them from seeded ``torch.Generator``s. The
bits differ, the construction does not.
"""

from __future__ import annotations

import torch

from ..ops.intersect import intersect_any
from ..ops.raygen import generate_rays
from ..ops.sampling import (cosine_sample_hemisphere, orthonormal_basis,
                            to_world)
from ..render.integrator import to_tile_order
from ..scene.buffers import build_scene_buffers
from ..scene.procedural import arch_camera, build_arch_scene

VFOV = 0.785  # the reference's field of view for these waves, in radians


def build(device="cuda", triangles: int = 260_000):
    """``(SceneBuffers, camera (4, 4) float32)`` of the arch scene on
    ``device``: arch-260k by default, as the reference builds it."""
    bufs = build_scene_buffers(build_arch_scene(triangles), device=device)
    cam = torch.from_numpy(arch_camera()).to(bufs.device)
    return bufs, cam


def make_waves(bufs, cam, W: int = 1920, H: int = 1080, seed: int = 0):
    """The primary wave in tile order and its cosine-diffuse continuation.

    Returns ``(ro, rd, dro, drd, alive)``: (R, 3) float32 primary origins
    and directions, (R, 3) diffuse origins (the hit point offset by 1e-3
    along the face-forward geometric normal) and directions, and (R,) bool
    ``alive`` (the primary ray hit). ``W`` a multiple of 128, ``H`` of 8.
    """
    dev = cam.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    jitter = torch.rand(W * H, 2, generator=g, device=dev)
    ro, rd = generate_rays(cam, W, H, VFOV, jitter)
    ro = to_tile_order(ro, W, H).contiguous()
    rd = to_tile_order(rd, W, H).contiguous()
    hit = intersect_any(bufs, ro, rd)

    gn = bufs.tri_shade[hit.tri.clamp_min(0).long(), 17:20]
    d = (gn * rd).sum(dim=1, keepdim=True)
    gn = torch.where(d > 0, -gn, gn)  # face forward
    pos = ro + hit.t[:, None] * rd + gn * 1e-3
    g.manual_seed(seed + 1)
    u = torch.rand(W * H, 2, generator=g, device=dev)
    local = cosine_sample_hemisphere(u[:, 0], u[:, 1])
    t_, bt = orthonormal_basis(gn)
    nd = to_world(gn, t_, bt, local)
    return ro, rd, pos.contiguous(), nd.contiguous(), hit.tri >= 0
