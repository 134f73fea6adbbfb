"""Tonemapping: a frozen copy of the port's
``loupiote_tpu_torch/ops/tonemap.py``.
"""

from __future__ import annotations

import torch


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.pow(torch.clamp_min(c, 1e-8), 1.0 / 2.4)
                       - 0.055)


def tonemap_aces(c: torch.Tensor) -> torch.Tensor:
    a, b, c2, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    x = torch.clamp_min(c, 0.0)
    return torch.clamp((x * (a * x + b)) / (x * (c2 * x + d) + e), 0.0, 1.0)


def tonemap_reinhard(c: torch.Tensor) -> torch.Tensor:
    x = torch.clamp_min(c, 0.0)
    return x / (1.0 + x)


_CURVES = {
    "linear": lambda c: torch.clamp(c, 0.0, 1.0),
    "reinhard": tonemap_reinhard,
    "aces": tonemap_aces,
}


def to_display(hdr: torch.Tensor, curve: str = "aces") -> torch.Tensor:
    """HDR (..., 3) linear -> (..., 3) uint8 sRGB."""
    ldr = linear_to_srgb(_CURVES[curve](hdr))
    return (ldr * 255.0 + 0.5).to(torch.uint8)
