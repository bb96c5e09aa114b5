"""Host allocator tuning for VMs with slow anonymous-page provisioning.

Copied from repeatresolver_tpu/utils/hostmem.py.

On a VM with transparent huge pages set to enabled=madvise,
defrag=madvise, numpy madvises MADV_HUGEPAGE on every allocation of
4 MB or more, and each hugepage fault then performs synchronous memory
compaction: the first touch of a large buffer becomes orders of
magnitude slower than a warm copy. `tune_allocator` switches numpy's
madvise off.

Two further mitigations stay on: raising M_MMAP_THRESHOLD /
M_TRIM_THRESHOLD keeps buffers up to 1 GB on the reusable (warm) heap,
and callers reuse big buffers where practical (larger arrays exceed the
mallopt int range and always round-trip through fresh mmaps).

The reference sidesteps this class of problem by allocating linked-list
nodes incrementally (PW_ReAligner.c malloc-per-column); a dense-array
engine must manage its big-buffer lifecycle instead: this is that
subsystem.
"""
from __future__ import annotations

import ctypes
import sys

_M_MMAP_THRESHOLD = -3
_M_TRIM_THRESHOLD = -1

_done = False


def _disable_numpy_hugepage_madvise() -> None:
    # runtime equivalent of NUMPY_MADVISE_HUGEPAGE=0 (which only works
    # if set before numpy import)
    try:
        from numpy._core import multiarray as _ma
    except ImportError:     # numpy < 2
        from numpy.core import multiarray as _ma  # type: ignore
    _ma._set_madvise_hugepage(False)


def tune_allocator() -> bool:
    """Idempotent; safe no-op off Linux/glibc. Returns True if the
    allocator is (now) tuned."""
    global _done
    if _done:
        return True
    if not sys.platform.startswith("linux"):
        return False
    try:
        _disable_numpy_hugepage_madvise()
    except Exception:
        pass
    try:
        libc = ctypes.CDLL("libc.so.6")
        ok1 = libc.mallopt(_M_MMAP_THRESHOLD, 1 << 30)
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, 1 << 30)
        _done = bool(ok1 and ok2)
    except Exception:
        return False
    return _done
