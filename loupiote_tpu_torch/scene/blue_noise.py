"""Blue-noise texture by void-and-cluster (copy of
``loupiote_tpu/scene/blue_noise.py::generate_blue_noise``).

``Renderer.upload_noise_texture`` takes its first two channels as the
per-pixel noise of every blue-noise dimension. Loading the texture from
a PNG (the reference's ``load_noise_png``) needs an image decoder, which
the card's host does not have; it is not copied.
"""

from __future__ import annotations

import numpy as np


def generate_blue_noise(size: int = 64, channels: int = 4,
                        seed: int = 7, sigma: float = 1.9) -> np.ndarray:
    """(size, size, channels) uint8 blue-noise via void-and-cluster."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    out = np.empty((size, size, channels), np.uint8)
    n = size * size

    for c in range(channels):
        # Initial binary pattern with ~10% ones, then tighten clusters.
        pattern = (rng.random((size, size)) < 0.1).astype(np.float64)

        def energy(p):
            return gaussian_filter(p, sigma, mode="wrap")

        for _ in range(2 * int(pattern.sum())):
            e = energy(pattern)
            cluster = np.unravel_index(
                np.argmax(np.where(pattern > 0, e, -np.inf)), e.shape)
            pattern[cluster] = 0
            e = energy(pattern)
            void = np.unravel_index(
                np.argmin(np.where(pattern == 0, e, np.inf)), e.shape)
            if void == cluster:
                pattern[cluster] = 1
                break
            pattern[void] = 1

        rank = np.full((size, size), -1, np.int64)
        ones = int(pattern.sum())
        # Phase 1: remove tightest cluster repeatedly, rank downwards.
        work = pattern.copy()
        for r in range(ones - 1, -1, -1):
            e = energy(work)
            i = np.unravel_index(np.argmax(np.where(work > 0, e, -np.inf)),
                                 e.shape)
            work[i] = 0
            rank[i] = r
        # Phase 2: fill largest void repeatedly, rank upwards.
        work = pattern.copy()
        for r in range(ones, n):
            e = energy(work)
            i = np.unravel_index(np.argmin(np.where(work == 0, e, np.inf)),
                                 e.shape)
            work[i] = 1
            rank[i] = r

        out[..., c] = (rank.astype(np.float64) * 256.0 / n).clip(
            0, 255).astype(np.uint8)
    return out
