"""Status and inspection surface, headless (counterpart of
``loupiote_tpu/app/gui.py``): a scene-info window (adapter, meshes, BVH
nodes), a performance window (frame time, FPS, per-pass times), a modal
error window and the rendering toolbar's state, as dicts, and a terminal
status block drawn from them.
"""

from __future__ import annotations

from typing import Optional

from ..config import BlitMode

BLIT_MODES = list(BlitMode)  # the toolbar's blit-mode entries


def scene_info_window(driver) -> dict:
    """Adapter and scene stats."""
    from ..device import Device

    info = {"adapter": Device(device=driver.renderer.device).adapter_info()}
    info.update(getattr(driver, "stats", {}))
    return info


def performance_window(driver) -> dict:
    """Frame time, FPS and per-pass times.

    ``frame_ms`` / ``fps`` time the frame the user runs. ``passes`` come
    from Renderer.measure_passes: method "trace" (the card) means device
    times of one profiled frame; "replay" means the stages ran one at a
    time and were rescaled to sum to the frame, so the per-pass shares
    are estimates, which the flag makes explicit."""
    q = driver.queries
    method = getattr(driver, "last_pass_method", "replay")
    return {
        "frame_ms": q.frame_ms,
        "fps": driver.fps,
        "passes": dict(zip(q.labels(), q.values())),
        "pass_timing_method": method,
        "pass_shares_estimated_from_unfused_replay": method == "replay",
    }


def error_window(error: Optional[Exception]) -> dict:
    """The modal error window."""
    return {"error": None if error is None else f"{type(error).__name__}: {error}"}


def toolbar_state(settings) -> dict:
    """The rendering toolbar."""
    return {
        "accumulate": settings.accumulate,
        "use_blue_noise": settings.use_blue_noise,
        "blit_mode": settings.blit_mode.value,
        "blit_modes": [m.value for m in BLIT_MODES],
    }


def render_status(driver, error: Optional[Exception] = None) -> str:
    """One-call terminal status block (the whole GUI, textually)."""
    perf = performance_window(driver)
    scene = scene_info_window(driver)
    tb = toolbar_state(driver.settings)
    lines = [
        f"loupiote_tpu_torch  |  {perf['fps']:.1f} fps  "
        f"{perf['frame_ms']:.1f} ms",
        f"mode={tb['blit_mode']} accumulate={tb['accumulate']} "
        f"blue_noise={tb['use_blue_noise']}",
        "passes: " + "  ".join(f"{k}={v:.1f}ms" for k, v in perf["passes"].items()),
        f"scene: {scene.get('meshes', 0)} meshes, "
        f"{scene.get('triangles', 0)} tris, "
        f"{scene.get('bvh_nodes', 0)} BVH nodes, "
        f"{scene.get('instances', 0)} instances",
    ]
    err = error_window(error)["error"]
    if err:
        lines.append(f"ERROR: {err}")
    return "\n".join(lines)
