"""Texture-atlas sampling: a frozen copy of the port's
``loupiote_tpu_torch/ops/texture.py``.

The atlas is a (layers, S, S, 4) uint8 tensor on the device and each
texture a block of it (``scene/atlas.py``); a lookup is four texel
gathers and a bilinear blend, with repeat addressing inside the block.
"""

from __future__ import annotations

import torch


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92,
                       ((c + 0.055) / 1.055) ** 2.4)


def sample_atlas(scene, tex_id: torch.Tensor, uv: torch.Tensor,
                 srgb: bool = False) -> torch.Tensor:
    """Bilinear RGBA fetch. tex_id: (R,) int32 (<0 -> white), uv: (R,2).

    UVs wrap (repeat addressing, the glTF default); ``torch.remainder``
    is a floor modulo, as the reference's ``jnp.mod``.
    """
    s = scene.atlas.shape[1]
    blk = scene.atlas_blocks[torch.clamp_min(tex_id, 0).to(torch.int64)]
    bx, by = blk[:, 0].to(torch.int64), blk[:, 1].to(torch.int64)
    layer = blk[:, 2].to(torch.int64)
    bw = torch.clamp_min(blk[:, 3].to(torch.float32), 1.0)
    bh = torch.clamp_min(blk[:, 4].to(torch.float32), 1.0)

    uu = uv[:, 0] - torch.floor(uv[:, 0])
    vv = uv[:, 1] - torch.floor(uv[:, 1])
    x = uu * bw - 0.5
    y = vv * bh - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    flat = scene.atlas.reshape(-1, 4)

    def fetch(xi, yi):
        # Wrap within the block, then offset into the atlas page.
        xi = torch.remainder(xi, bw).to(torch.int64) + bx
        yi = torch.remainder(yi, bh).to(torch.int64) + by
        return flat[(layer * s + yi) * s + xi].to(torch.float32) * (
            1.0 / 255.0)

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    rgba = ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)
    if srgb:
        rgba = torch.cat([srgb_to_linear(rgba[:, :3]), rgba[:, 3:]], dim=1)
    return torch.where((tex_id >= 0)[:, None], rgba, 1.0)
