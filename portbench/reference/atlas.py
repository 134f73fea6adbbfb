"""The texture atlas: a frozen copy of the port's
``loupiote_tpu_torch/scene/atlas.py``.

``ops/texture.py::sample_atlas`` reads a texture through its block
(x, y, layer, w, h).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from .scene_types import ImageData


@dataclass
class Atlas:
    texture: np.ndarray  # (layers, S, S, 4) uint8
    blocks: np.ndarray  # (K, 5) int32: x, y, layer, w, h

    @property
    def layer_count(self) -> int:
        return self.texture.shape[0]

    @property
    def size(self) -> int:
        return self.texture.shape[1]


def pack_atlas(images: List[ImageData], size: int = 2048) -> Atlas:
    """Shelf-pack ``images`` into square layers of ``size``."""
    if not images:
        return Atlas(
            texture=np.zeros((1, 1, 1, 4), np.uint8),
            blocks=np.zeros((1, 5), np.int32),
        )
    for img in images:
        if img.width > size or img.height > size:
            raise ValueError(
                f"image {img.width}x{img.height} exceeds atlas size {size}")

    blocks = np.zeros((len(images), 5), np.int32)
    layers: List[np.ndarray] = [np.zeros((size, size, 4), np.uint8)]
    x = y = shelf_h = 0
    layer = 0
    # Tallest first for better shelf use; blocks keep the original ids.
    order = sorted(range(len(images)), key=lambda i: -images[i].height)
    for i in order:
        img = images[i]
        w, h = img.width, img.height
        if x + w > size:
            x = 0
            y += shelf_h
            shelf_h = 0
        if y + h > size:
            layers.append(np.zeros((size, size, 4), np.uint8))
            layer += 1
            x = y = shelf_h = 0
        layers[layer][y:y + h, x:x + w] = img.data
        blocks[i] = (x, y, layer, w, h)
        x += w
        shelf_h = max(shelf_h, h)

    return Atlas(texture=np.stack(layers, axis=0), blocks=blocks)
