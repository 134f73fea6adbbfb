"""Builds the port's CUDA kernels with nvcc, loads them with ctypes and
calls them: the layer below every module that launches a kernel.

Each ``csrc/<name>.cu`` exposes plain C entry points and is compiled on
first use into ``loupiote_tpu_torch/_build/lib<name>_<hash>.so`` (the
hash is of the source, the shared ``csrc/*.cuh`` headers and the flags,
so an edit rebuilds). ``gxx`` builds the host C++ sources the same way
with g++. Nothing here
runs at import time: the CPU tests import every module, on hosts that
have no nvcc.

``launch`` calls an entry point (``call`` without counting it) and counts
it in ``launches`` by ``(entry, mode)``; ``kernel_counter`` gives the
device counters the kernels add to (rays stopped by a step bound and the
like). ``reset_counters`` zeroes both. ``on_card``, ``full_device``,
``check_args`` and ``DeviceCounter`` are the device rule, the argument
checks and the per-device counts every launching module shares.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time

import torch

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
    lib = _libs.get(name)  # a loaded library needs no lock
    if lib is not None:
        return lib
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


# -- the call layer ------------------------------------------------------

# Launches since the last reset_counters(), by (entry point, mode): mode
# None for an entry point with one, else e.g. "closest" / "anyhit", or
# ("per_ray", "anyhit") for E7. ("slab_sort", "cuda_launches") and
# ("regroup_blocks", "cuda_launches") add the CUDA launches those entry
# points report through their out-parameter.
launches: collections.Counter = collections.Counter()
_kernel_counters: dict = {}  # name -> DeviceCounter

# A signature's codes: "p" a pointer, "i" an int, "q" a long long, "n" an
# int pointer, "s" the CUDA stream.
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_longlong,
           "n": ctypes.POINTER(ctypes.c_int), "s": ctypes.c_void_p}


@functools.cache
def _signature(sig: str) -> tuple:
    """("11p3is") -> (the argtypes, the stream's position or -1)."""
    codes = "".join(c * int(n or 1)
                    for n, c in re.findall(r"(\d*)([a-z])", sig))
    return [_CTYPES[c] for c in codes], codes.find("s")


def call(lib: str, entry: str, sig: str, *args, what: str = "") -> None:
    """Call the C entry point ``entry`` of ``csrc/<lib>.cu`` (loaded, and
    built if need be), which returns a CUDA error code.

    ``sig`` is its C signature in ``struct``'s style, a count before a
    code repeating it: ``p`` a pointer (a tensor passes its
    ``data_ptr()``, None a null pointer), ``i`` an int, ``q`` a long
    long, ``n`` an int pointer (a ctypes array or ``byref``), ``s`` the
    current stream of the first tensor argument's device, which the
    caller does not pass. ctypes objects pass unchanged. The signature is
    declared once for each loaded library. Raises ``RuntimeError("<what>:
    CUDA error <n>")`` on a non-zero return, ``what`` by default
    ``"<entry> launch failed"``."""
    fn = getattr(load(lib), entry)
    types, stream = _signature(sig)
    if getattr(fn, "argtypes", None) is None:
        fn.restype = ctypes.c_int
        fn.argtypes = types
    vals = []
    dev = None
    for a in args:
        if isinstance(a, torch.Tensor):
            if dev is None:
                dev = a.device
            a = a.data_ptr()
        vals.append(a)
    if stream >= 0:
        vals.insert(stream, torch.cuda.current_stream(dev).cuda_stream)
    if len(vals) != len(types):
        raise TypeError(f"{entry}: {len(vals)} arguments for a signature of "
                        f"{len(types)}")
    err = fn(*vals)
    if err != 0:
        raise RuntimeError(f"{what or entry + ' launch failed'}: CUDA error "
                           f"{err}")


def launch(lib: str, entry: str, sig: str, *args, mode=None) -> None:
    """``call``, counted under ``(entry, mode)`` in ``launches``."""
    call(lib, entry, sig, *args)
    launches[entry, mode] += 1


def kernel_counter(name: str, dtype=torch.int32) -> "DeviceCounter":
    """The process's device counter ``name`` that kernels (and their
    twins) add to, made at first use; ``reset_counters`` zeroes it."""
    c = _kernel_counters.get(name)
    if c is None:
        c = _kernel_counters[name] = DeviceCounter(dtype)
    return c


def reset_counters() -> None:
    """Zero ``launches`` and every ``kernel_counter``. A recording's counts
    (``spans``) are its own and stay."""
    launches.clear()
    for c in _kernel_counters.values():
        c.reset()


def on_card(x: torch.Tensor, what: str = "traversal") -> bool:
    """True where a wrapper launches its CUDA kernel (a CUDA tensor), False
    where it runs its plain twin (a CPU tensor); raises ``no <what> for
    device ...`` for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no {what} for device {x.device}")
    return True


def full_device(device) -> torch.device:
    """The device with its index: "cuda" is the current card, as
    ``tensor.device`` names it ("cuda:0")."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class DeviceCounter:
    """A count kept as a one-element tensor on each device, so kernels
    (``atomicAdd``) and tensor code add to it without a host sync. "cuda"
    and "cuda:0" name the same card, hence the same counter."""

    def __init__(self, dtype=torch.int32):
        self.dtype = dtype
        self._by_device: dict = {}

    def tensor(self, device) -> torch.Tensor:
        d = full_device(device)
        if d not in self._by_device:
            self._by_device[d] = torch.zeros(1, dtype=self.dtype, device=d)
        return self._by_device[d]

    def read(self, device) -> int:
        return int(self.tensor(device).item())

    def total(self) -> int:
        """The counts of every device summed (one read each)."""
        return sum(int(c.item()) for c in self._by_device.values())

    def reset(self) -> None:
        for c in self._by_device.values():
            c.zero_()


def check_args(dev, specs) -> None:
    """Raise unless each (name, tensor, dtype, shape or None) is a
    contiguous tensor of that dtype and shape on ``dev``: what a kernel
    launch reads through raw pointers."""
    for name, x, dtype, shape in specs:
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dtype} tensor on "
                             f"{dev}, got {x.dtype} on {x.device}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name}: need shape {shape}, got "
                             f"{tuple(x.shape)}")
