"""Lightmap baking (counterpart of ``loupiote_tpu/ops/lightmap.py``):
per-vertex irradiance, the cosine-weighted incident radiance integrated
over the hemisphere, traced with the frame's own traversal and shading
(``intersect_any``, ``shade_step``), so it runs K1, or K2 / K3, as a frame
does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .intersect import intersect_any
from .sampling import (cosine_sample_hemisphere, draw_uniforms,
                       orthonormal_basis, to_world)
from .shade import EPS_OFFSET, BounceState, shade_step


def bake_vertex_irradiance(scene, positions: torch.Tensor,
                           normals: torch.Tensor,
                           generator: Optional[torch.Generator],
                           samples: int = 16, bounces: int = 2,
                           uniforms=None) -> torch.Tensor:
    """Irradiance at (V, 3) surface points with (V, 3) unit normals, on the
    scene's device: (V, 3) linear irradiance, what a white Lambertian
    surface would reflect times pi.

    Each sample draws its direction (two uniforms), then each bounce's six
    (eight with a probe) from ``generator``, on the generator's own device
    (a CPU generator gives a bake on the card the CPU bake's numbers).
    ``uniforms``: a sample's draws given instead, one ``FrameUniforms`` a
    sample (``jitter`` the direction pair), as the tests replay the
    reference's ``jax.random`` streams.
    """
    dev = scene.device
    positions = positions.to(dev, torch.float32)
    normals = normals.to(dev, torch.float32)
    V = positions.shape[0]
    t, bt = orthonormal_basis(normals)
    total = torch.zeros((V, 3), device=dev)
    for s in range(samples):
        u = (uniforms[s] if uniforms is not None else draw_uniforms(
            V, bounces, generator, generator.device,
            env=scene.has_probe)).to(dev)
        wi = to_world(normals, t, bt,
                      cosine_sample_hemisphere(u.jitter[:, 0],
                                               u.jitter[:, 1]))
        state = BounceState(
            ro=positions + normals * EPS_OFFSET, rd=wi,
            throughput=torch.ones((V, 3), device=dev),
            radiance=torch.zeros((V, 3), device=dev),
            alive=torch.ones(V, dtype=torch.bool, device=dev),
            bsdf_pdf=torch.zeros(V, device=dev),
            use_mis=torch.zeros(V, dtype=torch.bool, device=dev))
        for b in u.bounces:
            hit = intersect_any(scene, state.ro, state.rd, active=state.alive)
            # As the reference: no bounce is the path's last (no final
            # gather).
            state = shade_step(scene, state, hit, u_sel=b.u_sel, u1_l=b.u1_l,
                               u2_l=b.u2_l, u_lobe=b.u_lobe, u1=b.u1,
                               u2=b.u2, u1_e=b.u1_e, u2_e=b.u2_e, nee=True)
        # Cosine-weighted sampling: E ~= pi * mean(L_i).
        total = total + state.radiance
    return total * (math.pi / samples)
