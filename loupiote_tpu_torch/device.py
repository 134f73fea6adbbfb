"""Device wrapper (counterpart of ``loupiote_tpu/device.py``): the card's
adapter info and memory, and the 1x1 placeholder textures a pass binds
when no probe, noise texture or atlas content is bound.

``Device(index)`` is CUDA card ``index`` and raises where there is no
such card; ``device=`` names another torch device (the CPU tests pass
``"cpu"``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch


@dataclass
class DefaultTextures:
    """1x1 placeholder textures."""

    filterable_2d: np.ndarray = field(
        default_factory=lambda: np.ones((1, 1, 3), np.float32))
    noise: np.ndarray = field(
        default_factory=lambda: np.full((1, 1, 4), 127, np.uint8))


class Device:
    """Adapter info + defaults."""

    def __init__(self, index: int = 0, device: Optional[str] = None):
        # An empty tensor names the device in full and raises at once
        # where there is no such device.
        self._device = torch.empty(
            0, device=device if device is not None else f"cuda:{index}"
        ).device
        self.default_textures = DefaultTextures()

    @property
    def platform(self) -> str:
        return "gpu" if self._device.type == "cuda" else self._device.type

    @property
    def kind(self) -> str:
        if self._device.type == "cuda":
            return torch.cuda.get_device_name(self._device)
        return self._device.type

    def adapter_info(self) -> dict:
        """Adapter info for the scene-info window."""
        d = self._device
        info = {"name": str(d), "platform": self.platform,
                "kind": self.kind, "id": d.index or 0,
                "memory_stats": self.memory_stats()}
        if d.type == "cuda":
            p = torch.cuda.get_device_properties(d)
            info.update(compute_capability=f"{p.major}.{p.minor}",
                        multiprocessors=p.multi_processor_count,
                        total_memory=p.total_memory)
        return info

    def memory_stats(self) -> dict:
        """bytes_in_use (this process's tensors) and bytes_limit (the
        card's memory); {} off the card."""
        if self._device.type != "cuda":
            return {}
        free, total = torch.cuda.mem_get_info(self._device)
        return {"bytes_in_use": torch.cuda.memory_allocated(self._device),
                "bytes_limit": total, "bytes_free": free}

    def unwrap(self) -> torch.device:
        return self._device
