"""ctypes bridge to the C++ binned-SAH builder.

The source is the port's own copy,
``loupiote_tpu_torch/csrc/bvh_builder.cpp`` (a test holds it byte-equal
to the reference package's builder). It is
compiled with ``g++ -O3 -shared -fPIC`` (no ``-march=native``, so the
library runs on any x86-64 host) into the port's build directory,
``loupiote_tpu_torch/_build/``.
A failed compile or load raises: the numpy builder gives a different tree,
so the port never swaps one for the other silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

from .bvh import FlatBVH

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "bvh_builder.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
# Insertion-optimizer rounds: the reference's shipped default.
OPT_ROUNDS = 50

_lock = threading.Lock()
_lib = None


def _compile() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    lib_path = os.path.join(BUILD_DIR, f"libbvh_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Compile to a private name, then rename: concurrent builders (test
    # workers) never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", SOURCE,
             "-o", tmp],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed building {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_compile())
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


def build_bvh_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                     leaf_max: int) -> FlatBVH:
    """Native binned-SAH build plus ``OPT_ROUNDS`` rounds of insertion-based
    optimization."""
    lib = _load()
    t = v0.shape[0]
    a = np.ascontiguousarray(v0, np.float32)
    b = np.ascontiguousarray(v1, np.float32)
    c = np.ascontiguousarray(v2, np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    handle = lib.bvh_build_opt(a.ctypes.data_as(fp), b.ctypes.data_as(fp),
                               c.ctypes.data_as(fp), t, leaf_max, OPT_ROUNDS,
                               1.0)
    if not handle:
        raise RuntimeError("native BVH build returned no tree")
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
