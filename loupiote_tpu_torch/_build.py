"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
first use into ``loupiote_tpu_torch/_build/lib<name>_<hash>.so`` (the
hash is of the source, the shared ``csrc/*.cuh`` headers and the flags,
so an edit rebuilds). ``gxx`` builds the host C++ sources the same way
with g++. Nothing here
runs at import time: the CPU tests import every module, on hosts that
have no nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

# --fmad=false: no contracted multiply-adds, so t and every edge decision
# agree with the reference's separately rounded products.
NVCC_FLAGS = ("-O3", "-std=c++17", "--fmad=false",
              "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_name_locks: dict = {}  # one lock per source: builds of two run in parallel
_libs: dict = {}
# name -> {"seconds": float, "log": str}: how long the build took and
# what ptxas said (registers, spills), for chip_smoke.py to print.
build_info: dict = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; raises on failure.
    Threads that load different sources build them at the same time."""
    with _lock:
        lock = _name_locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_compile(name))
            _libs[name] = lib
        return lib


def _compile(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # The source and the shared headers it may include.
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")
    if os.path.exists(out):
        build_info.setdefault(name, {"seconds": 0.0, "log": "(cached)"})
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, src, "-o", tmp],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {src}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_info[name] = {"seconds": time.perf_counter() - t0,
                        "log": (proc.stdout + proc.stderr).strip()}
    return out


def gxx(source: str, prefix: str) -> str:
    """Compile the host C++ file ``source`` with ``g++ -O3 -shared -fPIC``
    (no ``-march=native``: the library runs on any x86-64 host) into
    ``BUILD_DIR/<prefix>_<hash of the source>.so`` unless it is there;
    returns the library's path and raises if g++ fails."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    lib_path = os.path.join(BUILD_DIR, f"{prefix}_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Compile to a private name, then rename: concurrent builders (test
    # workers) never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", source,
             "-o", tmp],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed building {source}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path
