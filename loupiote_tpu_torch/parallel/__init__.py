"""Tile-parallel frames over a grid of devices (``tiles.py``)."""

from .tiles import make_mesh, replicate_scene, trace_paths_sharded

__all__ = ["make_mesh", "replicate_scene", "trace_paths_sharded"]
