"""Build and bind the port's CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc into a shared library with a plain C
interface, at first use, into `build/kernels/` at the repository root
(listed in .gitignore). The library name carries a hash of the source,
the headers beside it (csrc/*.cuh) and the flags, so an edited kernel is
rebuilt and a stale one is never loaded. The libraries are bound with
ctypes: every pointer and the stream travel as c_void_p, every int as
c_int. A launch entry returns cudaGetLastError(), which `check` turns
into an exception.

Nothing here runs at import time: the CPU tests import every module of
the port on machines with no nvcc and no GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..utils import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# name -> (argtypes of <name>_launch); every launch entry returns int
_SIGNATURES = {
    "staircase_fill": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
    "walk_backtrack": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "editdp_fill": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
    + [ctypes.c_void_p] * 5,
    "editdp_walk": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    "maxcorr_tile": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
    "exact_fill": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    "exact_walk": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    "resolver_pairs": [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
}

_libs: dict = {}
_lock = threading.Lock()
# per kernel: (seconds spent compiling in this process, nvcc's output)
build_info: dict = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                       "PATH to build the CUDA kernels")


def _paths(name: str) -> tuple[str, str]:
    """(source, library) of a kernel; the library's name carries the
    hash of the source, the headers and the flags."""
    src = os.path.join(CSRC, name + ".cu")
    h = hashlib.sha1()
    for path in [src] + sorted(os.path.join(CSRC, f) for f in
                               os.listdir(CSRC) if f.endswith(".cuh")):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _start_build(name: str):
    """Start nvcc on csrc/<name>.cu unless its library is there; returns
    (process or None, temporary output, library, start time)."""
    src, so = _paths(name)
    if os.path.exists(so):
        return None, None, so, 0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, so, time.perf_counter_ns()


def _finish_build(name: str, proc, tmp, so, t0) -> str:
    if proc is not None:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{out}")
        os.replace(tmp, so)
        t1 = time.perf_counter_ns()
        build_info[name] = ((t1 - t0) / 1e9, out.strip())
    return so


def _builds(started) -> None:
    """Wait for the builds `_start_build` started together, each
    (name, process or None, temporary output, library, start time); the
    span `kernel.build` covers those that ran nvcc, from the first start
    to the last end."""
    ran = [b for b in started if b[1] is not None]
    for b in started:
        _finish_build(*b)
    if ran:
        trace.record("kernel.build", min(b[4] for b in ran),
                     time.perf_counter_ns(), {"kernels": [b[0] for b in ran]})
        trace.count("kernel.builds", len(ran))


def prebuild(names) -> None:
    """Compile several kernels at once: one nvcc per source, all started
    together."""
    with _lock:
        _builds([(n, *_start_build(n)) for n in names if n not in _libs])


def load(name: str) -> ctypes.CDLL:
    """The compiled library of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        started = (name, *_start_build(name))
        _builds([started])
        lib = ctypes.CDLL(started[3])
        launch = getattr(lib, name + "_launch")
        launch.argtypes = _SIGNATURES[name]
        launch.restype = ctypes.c_int
        err_str = getattr(lib, name + "_error_string")
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


# Set to a dict to time kernel launches: each wrapper then records a
# pair of CUDA events around its launch under its kernel's name. The
# events are read by whoever set the dict, after a sync of their own, so
# the wrappers never wait. None (the default) records nothing.
kernel_events: dict | None = None


def launch_events(name: str):
    """(start, end) CUDA events to record around a launch of `name`, or
    None when launches are not being timed."""
    if kernel_events is None:
        return None
    import torch
    pair = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    kernel_events.setdefault(name, []).append(pair)
    return pair


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch entry reported a CUDA error."""
    if err != 0:
        msg = getattr(lib, name + "_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
