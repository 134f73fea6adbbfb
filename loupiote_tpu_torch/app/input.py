"""Input mapping (counterpart of ``loupiote_tpu/app/input.py``): Space
toggles accumulation, WASD / arrows drive the camera, a drag rotates it,
and user events carry screenshot, load and reload requests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..render.camera import CameraMoveCommand
from .driver import EditorCommand

KEY_BINDINGS = {
    "w": CameraMoveCommand.FORWARD,
    "s": CameraMoveCommand.BACKWARD,
    "a": CameraMoveCommand.LEFT,
    "d": CameraMoveCommand.RIGHT,
    "up": CameraMoveCommand.FORWARD,
    "down": CameraMoveCommand.BACKWARD,
    "left": CameraMoveCommand.LEFT,
    "right": CameraMoveCommand.RIGHT,
}


@dataclass
class Event:
    """User events."""

    kind: str  # "save_screenshot" | "load_gltf" | "load_env" | "reload"
    payload: Optional[object] = None


class InputManager:
    """Key -> editor command mapping."""

    def handle_key(self, driver, key: str, pressed: bool) -> None:
        if key == " " and pressed:
            driver.run_command(EditorCommand.TOGGLE_ACCUMULATION)
            return
        cmd = KEY_BINDINGS.get(key)
        if cmd is not None:
            if pressed:
                driver.camera_controller.set_command(cmd)
            else:
                driver.camera_controller.unset_command(cmd)

    def handle_mouse_drag(self, driver, dx: float, dy: float) -> None:
        driver.camera_controller.rotate(dx, dy)

    def handle_event(self, driver, event: Event) -> None:
        if event.kind == "save_screenshot":
            driver.save_screenshot(event.payload)
        elif event.kind == "load_gltf":
            driver.load_gltf_path(event.payload)
            driver.upload_scene()
        elif event.kind == "load_env":
            driver.load_env_path(event.payload)
            driver.upload_scene()
        elif event.kind == "reload":
            driver.renderer.reload_shaders()
