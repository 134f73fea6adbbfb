"""A-SVGF denoiser."""

from .asvgf import denoise

__all__ = ["denoise"]
