"""Integrator, camera and renderer."""

from .camera import Camera, CameraController, CameraMoveCommand
from .integrator import GBuffer, accumulate, trace_paths
from .renderer import Renderer, RenderState, render_frame

__all__ = ["Camera", "CameraController", "CameraMoveCommand", "GBuffer",
           "accumulate", "trace_paths", "Renderer", "RenderState",
           "render_frame"]
