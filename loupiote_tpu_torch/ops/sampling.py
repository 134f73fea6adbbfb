"""Sampling math (counterpart of ``loupiote_tpu/ops/sampling.py``):
orthonormal bases, cosine hemisphere, GGX microfacets. Batched over the
leading ray dimension. ``FrameUniforms`` holds every pseudo-random draw
of a frame (or of a bake's sample), ``draw_uniforms`` draws them from a
``torch.Generator``."""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import List, Optional

import torch

from .raygen import norm3

INV_PI = 1.0 / math.pi


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(R,3) x (R,3) -> (R,) dot product, summed in x, y, z order."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise cross product of (R,3) tensors (broadcasting allowed)."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def orthonormal_basis(n: torch.Tensor):
    """Branchless ONB from unit normals (Duff et al. 2017). n: (R,3)."""
    s = torch.where(n[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = torch.stack([1.0 + s * n[:, 0] * n[:, 0] * a, s * b, -s * n[:, 0]],
                    dim=1)
    bt = torch.stack([b, s + n[:, 1] * n[:, 1] * a, -n[:, 1]], dim=1)
    return t, bt


def to_world(n, t, bt, local):
    """Local (x,y,z) -> world given basis (t, bt, n)."""
    return t * local[:, 0:1] + bt * local[:, 1:2] + n * local[:, 2:3]


def cosine_sample_hemisphere(u1, u2):
    """Cosine-weighted local direction; pdf = cos/pi. Returns (R,3)."""
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    return torch.stack([x, y, z], dim=1)


def ggx_d(n_dot_h, alpha):
    a2 = alpha * alpha
    d = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp_min(math.pi * d * d, 1e-12)


def smith_g1(n_dot_v, alpha):
    a2 = alpha * alpha
    nv = torch.clamp_min(n_dot_v, 1e-6)
    return 2.0 * nv / (nv + torch.sqrt(a2 + (1.0 - a2) * nv * nv))


def smith_g2(n_dot_v, n_dot_l, alpha):
    return smith_g1(n_dot_v, alpha) * smith_g1(n_dot_l, alpha)


def fresnel_schlick(cos_theta, f0):
    """f0: (R,3); cos_theta: (R,)."""
    m = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    m2 = m * m
    return f0 + (1.0 - f0) * (m2 * m2 * m)[:, None]


def sample_ggx_vndf(wo_local, alpha, u1, u2):
    """Sample the GGX visible-normal distribution (Heitz 2018).

    wo_local: (R,3) view dir in tangent space, z up. Returns half vectors.
    """
    v = torch.stack([wo_local[:, 0] * alpha, wo_local[:, 1] * alpha,
                     wo_local[:, 2]], dim=1)
    v = v / norm3(v)[:, None]
    lensq = v[:, 0] ** 2 + v[:, 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp_min(lensq, 1e-20))
    t1_alt = torch.zeros_like(v)
    t1_alt[:, 0] = 1.0
    t1 = torch.where((lensq > 1e-12)[:, None],
                     torch.stack([-v[:, 1] * inv, v[:, 0] * inv,
                                  torch.zeros_like(inv)], dim=1),
                     t1_alt)
    t2 = cross3(v, t1)
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + v[:, 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp_min(1.0 - p1 * p1, 0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp_min(1.0 - p1 * p1 - p2 * p2, 0.0))
    nh = t1 * p1[:, None] + t2 * p2[:, None] + v * p3[:, None]
    h = torch.stack([alpha * nh[:, 0], alpha * nh[:, 1],
                     torch.clamp_min(nh[:, 2], 1e-6)], dim=1)
    return h / norm3(h)[:, None]


def reflect(d, n):
    """Reflect direction d about normal n (both (R,3))."""
    return d - 2.0 * dot3(d, n)[:, None] * n


def luminance(rgb):
    return 0.2126 * rgb[:, 0] + 0.7152 * rgb[:, 1] + 0.0722 * rgb[:, 2]


def power_heuristic(pdf_a, pdf_b):
    """Power heuristic (beta=2) MIS weight for strategy a."""
    a2 = pdf_a * pdf_a
    return a2 / torch.clamp_min(a2 + pdf_b * pdf_b, 1e-20)


@dataclass
class BounceUniforms:
    """One bounce's draws, (N,) each, in the bounce's slot order."""

    u_sel: torch.Tensor  # light selection
    u1_l: torch.Tensor  # point on the light
    u2_l: torch.Tensor
    u_lobe: torch.Tensor  # BSDF lobe selection
    u1: torch.Tensor  # BSDF sample
    u2: torch.Tensor
    u1_e: Optional[torch.Tensor] = None  # environment sample (a probe)
    u2_e: Optional[torch.Tensor] = None


@dataclass
class FrameUniforms:
    """Every random number of one frame."""

    jitter: torch.Tensor  # (N, 2) sub-pixel offsets, pixel order
    bounces: List[BounceUniforms]

    def to(self, device) -> "FrameUniforms":
        def move(x):
            return None if x is None else x.to(device)

        return FrameUniforms(self.jitter.to(device), [
            BounceUniforms(*(move(getattr(b, f.name)) for f in fields(b)))
            for b in self.bounces])


def draw_uniforms(n: int, bounces: int, generator: torch.Generator,
                  device, env: bool = False) -> FrameUniforms:
    """Draw a frame's uniforms in [0, 1) from ``generator``; ``env``:
    each bounce's environment pair too (a scene with a probe)."""
    def u(*shape):
        return torch.rand(*shape, generator=generator, device=device)

    jitter = u(n, 2)
    return FrameUniforms(jitter, [
        BounceUniforms(u(n), u(n), u(n), u(n), u(n), u(n),
                       *((u(n), u(n)) if env else ()))
        for _ in range(bounces)])
