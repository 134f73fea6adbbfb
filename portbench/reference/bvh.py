"""The reference's BVH2: the frozen C++ builder beside this file
(``bvh_builder.cpp``, the port's binned-SAH builder with its insertion
optimizer), built with g++ into a fixed directory of the checkout and
called through ctypes, as the port's ``accel/native.py`` calls its own.
The reference needs the tree the program builds, not only a valid one:
two triangles at one ``t`` (where faces meet) are told apart by the
traversal's visit order, and a different winner turns a bounce, which
the bounce sort then spreads to other pixels' random numbers.

Layout: internal node ``n``'s left child is
``n + 1`` and ``miss[n]`` jumps over its subtree; ``right[n]`` is the
right child. ``accel/wide.py`` collapses this tree into the 8-wide table
the traversal kernel reads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Max triangles per leaf: one 128-float leaf row holds 14 x 9 floats.
LEAF_MAX = 14


class AccelBuild(ValueError):
    """The BVH cannot be built from the given triangles."""


@dataclass
class FlatBVH:
    """Flat threaded BVH arrays (all leading dim = node count N).

    ``first``: leaf -> first triangle in the *reordered* triangle array;
               internal -> left child index (== self + 1).
    ``count``: 0 for internal nodes, triangle count for leaves.
    ``miss``:  skip link; ``len(nodes)`` terminates traversal.
    ``tri_order``: permutation applied to input triangles.
    """

    node_min: np.ndarray  # (N, 3) float32
    node_max: np.ndarray  # (N, 3) float32
    first: np.ndarray  # (N,) int32
    count: np.ndarray  # (N,) int32
    miss: np.ndarray  # (N,) int32
    right: np.ndarray  # (N,) int32 right child (-1 for leaves)
    axis: np.ndarray  # (N,) int32 split axis (-1 for leaves)
    tri_order: np.ndarray  # (T,) int32

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]


import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "bvh_builder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".cache", "reference")
OPT_ROUNDS = 50  # insertion-optimizer rounds, as the port runs them

_lock = threading.Lock()
_lib = None


def _library() -> ctypes.CDLL:
    """The builder, compiled on first use into ``BUILD_DIR`` under the
    hash of its source (a fixed path: the next run finds it)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with open(SOURCE, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:12]
        path = os.path.join(BUILD_DIR, f"libbvh_{digest}.so")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", SOURCE,
                     "-o", tmp], capture_output=True, text=True, timeout=300)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed: {proc.stderr}")
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(path)
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        lib.bvh_build_opt.restype = ctypes.c_void_p
        lib.bvh_build_opt.argtypes = [fp] * 3 + [ctypes.c_int32] * 3 + [
            ctypes.c_float]
        lib.bvh_num_nodes.restype = ctypes.c_int32
        lib.bvh_num_nodes.argtypes = [ctypes.c_void_p]
        lib.bvh_export.restype = None
        lib.bvh_export.argtypes = [ctypes.c_void_p, fp, fp] + [ip] * 6
        lib.bvh_free.restype = None
        lib.bvh_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              leaf_max: int = LEAF_MAX) -> FlatBVH:
    """Binned-SAH build of triangles (v0, v1, v2), (T, 3) float32, plus
    ``OPT_ROUNDS`` rounds of insertion-based optimization."""
    t = v0.shape[0]
    if t == 0:
        raise AccelBuild("cannot build a BVH over zero triangles")
    if not (np.isfinite(v0).all() and np.isfinite(v1).all()
            and np.isfinite(v2).all()):
        raise AccelBuild("non-finite vertex positions in BVH input")
    lib = _library()
    a, b, c = (np.ascontiguousarray(x, np.float32) for x in (v0, v1, v2))
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    handle = lib.bvh_build_opt(a.ctypes.data_as(fp), b.ctypes.data_as(fp),
                               c.ctypes.data_as(fp), t, leaf_max, OPT_ROUNDS,
                               1.0)
    if not handle:
        raise RuntimeError("the BVH build returned no tree")
    try:
        n = lib.bvh_num_nodes(handle)
        node_min = np.empty((n, 3), np.float32)
        node_max = np.empty((n, 3), np.float32)
        first, count, miss, right, axis = (np.empty(n, np.int32)
                                           for _ in range(5))
        order = np.empty(t, np.int32)
        lib.bvh_export(handle, node_min.ctypes.data_as(fp),
                       node_max.ctypes.data_as(fp),
                       first.ctypes.data_as(ip), count.ctypes.data_as(ip),
                       miss.ctypes.data_as(ip), right.ctypes.data_as(ip),
                       axis.ctypes.data_as(ip), order.ctypes.data_as(ip))
    finally:
        lib.bvh_free(handle)
    return FlatBVH(node_min=node_min, node_max=node_max, first=first,
                   count=count, miss=miss, right=right, axis=axis,
                   tri_order=order)
