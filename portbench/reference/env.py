"""Environment probe lookups and sampling: a frozen copy of the port's
``loupiote_tpu_torch/ops/env.py``.

The probe is pre-decoded float32 radiance (``scene/hdr.py``) with CDF
tables on a coarse grid. Direction convention: equirect with +Y up,
u = 0.5 + atan2(d.x, -d.z) / 2pi, v = acos(clamp(d.y)) / pi.
"""

from __future__ import annotations

import math

import torch


def dir_to_equirect(d: torch.Tensor):
    """(R,3) unit dirs -> (u, v) in [0,1)^2."""
    u = 0.5 + torch.atan2(d[:, 0], -d[:, 2]) / (2.0 * math.pi)
    v = torch.acos(torch.clamp(d[:, 1], -1.0, 1.0)) / math.pi
    return u, v


def equirect_to_dir(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    theta = v * math.pi
    phi = (u - 0.5) * 2.0 * math.pi
    sin_t = torch.sin(theta)
    return torch.stack([sin_t * torch.sin(phi), torch.cos(theta),
                        -sin_t * torch.cos(phi)], dim=1)


def eval_env(scene, d: torch.Tensor) -> torch.Tensor:
    """Bilinear probe radiance for directions d: (R,3) -> (R,3). Columns
    wrap with a floor modulo (``torch.remainder``, as ``jnp.mod``); rows
    clamp."""
    h, w = scene.probe.shape[0], scene.probe.shape[1]
    u, v = dir_to_equirect(d)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    flat = scene.probe.reshape(-1, 3)
    c00 = flat[y0i * w + x0i]
    c10 = flat[y0i * w + x1i]
    c01 = flat[y1i * w + x0i]
    c11 = flat[y1i * w + x1i]
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def env_pdf(scene, d: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of sampling direction d from the probe CDFs."""
    hp, wp = scene.probe_pdf.shape
    u, v = dir_to_equirect(d)
    xi = torch.clamp((u * wp).to(torch.int64), 0, wp - 1)
    yi = torch.clamp((v * hp).to(torch.int64), 0, hp - 1)
    return scene.probe_pdf.reshape(-1)[yi * wp + xi]


def sample_env(scene, u1: torch.Tensor, u2: torch.Tensor):
    """Importance-sample the probe. Returns (dir (R,3), pdf (R,)).

    The row comes from the marginal CDF, the column from the row's
    conditional CDF (the first entry >= u, as ``searchsorted`` with
    ``side="left"``); the pdf is exact for that coarse distribution.
    """
    hp, wp = scene.probe_pdf.shape
    row = torch.clamp(torch.searchsorted(scene.probe_cdf_marg,
                                         u1.contiguous(), right=False),
                      0, hp - 1)
    col = torch.clamp(_bisect_rows(scene.probe_cdf_cond, row, u2), 0, wp - 1)
    u = (col.to(torch.float32) + 0.5) / wp
    v = (row.to(torch.float32) + 0.5) / hp
    d = equirect_to_dir(u, v)
    pdf = scene.probe_pdf.reshape(-1)[row * wp + col]
    return d, pdf


def _bisect_rows(cdf_cond: torch.Tensor, row: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
    """First index i per ray with cdf_cond[row, i] >= u, by ceil(log2 W)
    halvings of [0, W)."""
    h, w = cdf_cond.shape
    flat = cdf_cond.reshape(-1)
    base = row * w
    lo = torch.zeros_like(row)
    hi = torch.full_like(row, w)
    for _ in range(max(1, math.ceil(math.log2(max(w, 2))))):
        mid = (lo + hi) // 2
        go_right = flat[base + torch.clamp_max(mid, w - 1)] < u
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo
