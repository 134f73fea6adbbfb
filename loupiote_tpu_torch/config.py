"""Render configuration (counterpart of ``loupiote_tpu/config.py``).

Pure Python; the fields and their defaults are the reference's, so a
``RenderConfig`` means the same frame in both packages. One field is the
port's own: ``instancing``, the scene layout ``Driver.upload_scene``
builds. The JAX ``RenderConfig`` has no such field (its app always
flattens); at the field's default the port renders what the JAX
package renders.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class BlitMode(enum.Enum):
    """Display mode switch."""

    PATHTRACE = "pathtrace"
    DENOISED_PATHTRACE = "denoised_pathtrace"
    TEMPORAL = "temporal"
    GBUFFER = "gbuffer"
    MOTION_VECTOR = "motion_vector"


@dataclass(frozen=True)
class RenderConfig:
    """Static render parameters."""

    downsample_factor: float = 0.5  # render at half window resolution
    bounces_static: int = 3
    bounces_moving: int = 3
    vfov_deg: float = 45.0
    near: float = 0.01
    far: float = 100.0
    nee: bool = True
    tonemap: str = "aces"
    atlas_size: int = 2048
    # Pixels are clamped so per-pixel state stays within this many bytes.
    max_buffer_bytes: int = 256 * 1024 * 1024
    bytes_per_pixel: int = 48
    atrous_iterations: int = 4
    denoise: bool = True
    samples_per_frame: int = 1
    # Upstream's two-level layout: one BLAS a mesh under an instance table
    # (scene/instanced.py), instead of every instance flattened into one
    # BVH.
    instancing: bool = False

    @property
    def max_pixels(self) -> int:
        return self.max_buffer_bytes // self.bytes_per_pixel


@dataclass
class Settings:
    """Runtime-mutable settings; the app starts in DENOISED_PATHTRACE."""

    accumulate: bool = False
    use_blue_noise: bool = False
    blit_mode: BlitMode = BlitMode.PATHTRACE


def clamp_size(width: int, height: int, cfg: RenderConfig) -> tuple:
    """Clamp the pixel count to the buffer budget."""
    target = width * height
    if target <= cfg.max_pixels:
        return width, height
    ratio = cfg.max_pixels / target
    return max(int(width * ratio), 1), max(int(height * ratio), 1)


def downsampled_size(width: int, height: int, factor: float) -> tuple:
    """Internal render size for a window size (truncating cast)."""
    return int(width * factor), int(height * factor)
