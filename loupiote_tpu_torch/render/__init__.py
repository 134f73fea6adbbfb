"""Integrator, camera and renderer."""

from .camera import Camera
from .integrator import accumulate, trace_paths
from .renderer import Renderer, render_frame

__all__ = ["Camera", "accumulate", "trace_paths", "Renderer",
           "render_frame"]
