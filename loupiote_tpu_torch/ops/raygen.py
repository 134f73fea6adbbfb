"""Camera ray generation (counterpart of ``loupiote_tpu/ops/raygen.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from .. import spans


def generate_rays(cam_to_world: torch.Tensor, width: int, height: int,
                  vfov: float, jitter: torch.Tensor, row_offset: int = 0,
                  rows: Optional[int] = None):
    """Returns (ro, rd): ((R,3), (R,3)) with R = rows * width.

    ``cam_to_world``: (4, 4) float32 on the rays' device; columns are
    right, up, forward, origin. Pixel (0, 0) is the top-left corner and
    rows are raveled row-major. ``jitter``: (R, 2) in [0,1) sub-pixel
    offsets. The camera basis products are written elementwise, so no
    matrix-product (TF32) path is involved.
    ``row_offset`` / ``rows``: only the row slab [row_offset, row_offset +
    rows) of the height-row image (``rows`` None: every row), the unit of
    tile parallelism (``parallel/tiles.py``); a slab's rays equal those
    rows of the whole image's.
    """
    dev = jitter.device
    right = cam_to_world[:3, 0]
    up = cam_to_world[:3, 1]
    forward = cam_to_world[:3, 2]
    origin = cam_to_world[:3, 3]

    if rows is None:
        rows = height
    aspect = width / height
    # tan in float32, as the reference computes it.
    with spans.sync("vfov"):
        half = torch.tensor(vfov / 2.0, dtype=torch.float32, device=dev)
    tan_half = torch.tan(half)

    yy, xx = torch.meshgrid(torch.arange(rows, dtype=torch.float32,
                                         device=dev),
                            torch.arange(width, dtype=torch.float32,
                                         device=dev), indexing="ij")
    px = xx.reshape(-1) + jitter[:, 0]
    py = yy.reshape(-1) + row_offset + jitter[:, 1]

    # NDC in [-1, 1]; image y grows down, camera up grows up.
    ndc_x = (px / width) * 2.0 - 1.0
    ndc_y = 1.0 - (py / height) * 2.0

    d = (right[None, :] * (ndc_x * tan_half * aspect)[:, None]
         + up[None, :] * (ndc_y * tan_half)[:, None]
         + forward[None, :])
    d = d / norm3(d)[:, None]
    o = origin.expand_as(d)
    return o, d


def norm3(x: torch.Tensor) -> torch.Tensor:
    """(R,3) -> (R,) Euclidean norm, summed in x, y, z order."""
    return torch.sqrt(x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]
                      + x[:, 2] * x[:, 2])
