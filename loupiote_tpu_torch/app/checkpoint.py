"""Checkpoint and resume of a render session (counterpart of
``loupiote_tpu/app/checkpoint.py``).

``save_session`` / ``load_session`` keep the reference's layout: a
directory with ``manifest.json`` (version 1: size, accumulate, mode,
use_noise) and ``state.npz``, one array a frame-state field. A checkpoint
written by either package loads in the other for every field both have:
the reference's PRNG key (and its completion probe) are fields the port
has no use for and skips; the port's RNG, a ``torch.Generator``, is saved
apart, in ``rng.npz`` under ``torch_generator``, so ``state.npz`` holds no
field the reference's loader would refuse.

``save_session_torch`` / ``load_session_torch`` take the place of the
reference's orbax pair: the same manifest, and the state tensors and the
generator's state in one ``torch.save`` file.
"""

from __future__ import annotations

import json
import os
from dataclasses import fields, replace
from typing import Tuple

import numpy as np
import torch

from ..config import BlitMode
from ..render.renderer import Renderer, RenderState

_MANIFEST = "manifest.json"
_RNG = "rng.npz"
_TORCH = "state.pt"
# Fields of the reference's frame state that the port does not keep.
_REFERENCE_ONLY = ("key", "probe")


def _manifest(renderer: Renderer, **extra) -> dict:
    return {"size": list(renderer.size), "accumulate": renderer.accumulate,
            "mode": renderer.mode.value, "use_noise": renderer.use_noise,
            "version": 1, **extra}


def _state_arrays(renderer: Renderer) -> dict:
    st = renderer.state
    out = {}
    for f in fields(st):
        v = getattr(st, f.name)
        out[f.name] = (v.cpu().numpy() if isinstance(v, torch.Tensor)
                       else np.asarray(v, np.int32))
    return out


def _read_manifest(path: str, renderer: Renderer) -> dict:
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    version = manifest.get("version")
    if version != 1:
        raise ValueError(f"unsupported checkpoint version {version!r} "
                         f"(this build reads version 1)")
    size = tuple(manifest["size"])
    if tuple(renderer.size) != size:
        raise ValueError(
            f"checkpoint size {size} != renderer size {renderer.size}")
    return manifest


def _restore(renderer: Renderer, manifest: dict, names, arrays) -> None:
    """``names``: every field of the checkpoint; ``arrays``: name -> array
    of those this layout keeps."""
    known = {f.name for f in fields(RenderState)}
    unknown = sorted(set(names) - known - set(_REFERENCE_ONLY))
    if unknown:
        raise ValueError(
            f"checkpoint has fields unknown to this RenderState layout: "
            f"{unknown} (written by a newer build?)")
    new = {}
    for name in known & set(names):
        v = arrays[name]
        if name == "frame_count":
            new[name] = int(np.asarray(v))
        else:
            new[name] = torch.as_tensor(np.asarray(v)).to(renderer.device)
    # Fields the checkpoint lacks keep the renderer's current values.
    renderer.state = replace(renderer.state, **new)
    renderer.accumulate = bool(manifest["accumulate"])
    renderer.mode = BlitMode(manifest["mode"])
    renderer.use_noise = bool(manifest["use_noise"])


def save_session(path: str, renderer: Renderer) -> None:
    """Write the renderer's frame state and settings to ``path`` (a
    directory)."""
    os.makedirs(path, exist_ok=True)
    np.savez_compressed(os.path.join(path, "state.npz"),
                        **_state_arrays(renderer))
    np.savez(os.path.join(path, _RNG),
             torch_generator=renderer.generator.get_state().numpy())
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(_manifest(renderer), f)


def load_session(path: str, renderer: Renderer) -> None:
    """Restore a ``save_session`` checkpoint of either package into
    ``renderer`` (sizes must match; resize first if needed). The
    generator's state is restored where the checkpoint has the port's."""
    manifest = _read_manifest(path, renderer)
    with np.load(os.path.join(path, "state.npz")) as data:
        _restore(renderer, manifest, data.files,
                 {k: data[k] for k in data.files
                  if k not in _REFERENCE_ONLY})
    rng = os.path.join(path, _RNG)
    if os.path.exists(rng):
        with np.load(rng) as data:
            renderer.generator.set_state(
                torch.from_numpy(data["torch_generator"]))


def save_session_torch(path: str, renderer: Renderer) -> None:
    """``torch.save`` of the state tensors and the generator's state,
    beside the same manifest."""
    os.makedirs(path, exist_ok=True)
    st = renderer.state
    tree = {f.name: (getattr(st, f.name).cpu()
                     if isinstance(getattr(st, f.name), torch.Tensor)
                     else getattr(st, f.name)) for f in fields(st)}
    torch.save({"state": tree,
                "generator": renderer.generator.get_state()},
               os.path.join(path, _TORCH))
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(_manifest(renderer, frame_count=int(st.frame_count),
                            backend="torch"), f)


def load_session_torch(path: str, renderer: Renderer) -> None:
    """Restore a ``save_session_torch`` checkpoint (the npz loader's
    checks)."""
    manifest = _read_manifest(path, renderer)
    blob = torch.load(os.path.join(path, _TORCH), weights_only=True)
    _restore(renderer, manifest, blob["state"], {
        k: (v.numpy() if isinstance(v, torch.Tensor) else v)
        for k, v in blob["state"].items()})
    renderer.generator.set_state(blob["generator"])


def checkpoint_info(path: str) -> Tuple[dict, int]:
    """(manifest, frame_count) of either format."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if "frame_count" in manifest:
        return manifest, int(manifest["frame_count"])
    with np.load(os.path.join(path, "state.npz")) as data:
        return manifest, int(data["frame_count"])
