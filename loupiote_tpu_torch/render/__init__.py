"""Integrator and renderer."""

from .integrator import accumulate, trace_paths
from .renderer import Renderer, render_frame

__all__ = ["accumulate", "trace_paths", "Renderer", "render_frame"]
