"""The port's ctypes binding of its native host library.

Copied from repeatresolver_tpu/utils/native.py (same entry points, same
arguments, same results), with its own build: the library is compiled
from the port's copy of the host source, `csrc/host_ops.cpp` (a copy of
native/host_ops.cpp), with g++ at first use into `build/host/` at the
repository root (listed in .gitignore). The file name carries a hash of
the source and the flags, as ops/_build.py does for the CUDA kernels,
so an edited source is rebuilt and a stale library is never loaded; the
compiler writes to a temporary name that is renamed into place, so
several processes may build at once. `native/libhostops.so` is never
read, written or rebuilt.

Where g++ is missing or the build fails, `get_lib` raises: no caller
carries on without the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "host_ops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "host")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
_lib = None
_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """The host library is not there and could not be built (no compiler,
    or the compiler failed on the source)."""


def _build() -> str:
    """Path of the compiled library, built first if it is not there."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(
            f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libhostops_{digest}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        try:
            res = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, SOURCE],
                                 capture_output=True, text=True)
        except OSError as e:
            raise NativeBuildError(f"native host library: cannot run "
                                   f"{CXX} ({e})") from e
        if res.returncode != 0:
            raise NativeBuildError(f"native host library: {CXX} failed on "
                                   f"{SOURCE}:\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, so)
    return so


def get_lib():
    """The bound library; built on first use, raises if that fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        i64 = ctypes.c_int64
        lib.kmeans_top5_centroids.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, i64, i64, ctypes.c_void_p]
        lib.kmeans_assign_dissolve.argtypes = [
            ctypes.c_void_p, i64, i64, ctypes.c_void_p, ctypes.c_void_p]
        lib.editdp_backtrack.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            i64, i64, i64, ctypes.c_void_p]
        lib.realign_block_native.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, i64, i64, i64, i64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, i64]
        lib.splice_cols_native.argtypes = [
            ctypes.c_void_p, i64, i64, ctypes.c_void_p,
            ctypes.c_void_p, i64, ctypes.c_void_p]
        lib.occurrence_rows_native.argtypes = [
            ctypes.c_void_p, i64, ctypes.c_void_p, ctypes.c_void_p,
            i64, i64, ctypes.c_void_p]
        lib.initial_align_native.argtypes = [
            ctypes.c_void_p, i64, ctypes.c_void_p, ctypes.c_void_p,
            i64, i64, ctypes.c_void_p, ctypes.c_void_p]
        lib.initial_align_banded_native.argtypes = [
            ctypes.c_void_p, i64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, i64, i64, i64, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.realign_backtrack.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, i64, i64, i64, i64,
            ctypes.c_void_p, i64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, i64]
        lib.realign_backtrack.restype = i64
        lib.maxcorr_build.argtypes = [
            ctypes.c_void_p, i64, i64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.maxcorr_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            i64, i64, i64, i64, i64, i64, i64, i64, i64, i64,
            ctypes.c_void_p]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def kmeans_top5_centroids(scores: np.ndarray,
                          varsigs: np.ndarray) -> np.ndarray:
    lib = get_lib()
    n = scores.shape[0]
    v = varsigs.shape[1]
    scores = np.ascontiguousarray(scores, np.int64)
    vs = np.ascontiguousarray(varsigs, np.uint8)
    cent = np.zeros((n, v), np.uint8)
    lib.kmeans_top5_centroids(_ptr(scores), _ptr(vs), n, v, _ptr(cent))
    return cent


def kmeans_assign_dissolve(cent_scores: np.ndarray,
                           mingroup: int) -> np.ndarray:
    lib = get_lib()
    n = cent_scores.shape[0]
    cs = np.ascontiguousarray(cent_scores, np.int64)
    out = np.zeros(n, np.int32)
    size = np.zeros(n, np.int64)
    lib.kmeans_assign_dissolve(_ptr(cs), n, mingroup, _ptr(out),
                               _ptr(size))
    return out


def editdp_backtrack(codes: np.ndarray, qlens: np.ndarray,
                     entries: np.ndarray) -> np.ndarray:
    lib = get_lib()
    b, lq, lt = codes.shape
    codes = np.ascontiguousarray(codes, np.int8)
    ql = np.ascontiguousarray(qlens, np.int32)
    en = np.ascontiguousarray(entries, np.int64)
    out = np.zeros((b, lq), np.int32)
    lib.editdp_backtrack(_ptr(codes), _ptr(ql), _ptr(en), b, lq, lt,
                         _ptr(out))
    return out


def realign_block(counts, rows_old, seqs, ways, lengths, bandwidth,
                  ins_cap=512):
    """Fused native banded fill + backtrack for a block. Returns
    (new_rows int8 [B, C] with 5 default, best int64 [B],
    ins_y [B, K], ins_base [B, K], ins_n [B])."""
    lib = get_lib()
    counts = np.ascontiguousarray(counts, np.int32)
    rows_old = np.ascontiguousarray(rows_old, np.int8)
    seqs = np.ascontiguousarray(seqs, np.int8)
    ways = np.ascontiguousarray(ways, np.int32)
    lengths = np.ascontiguousarray(lengths, np.int32)
    b, c = rows_old.shape
    l = seqs.shape[1]
    new_rows = np.full((b, c), 5, np.int8)
    best = np.zeros(b, np.int64)
    iy = np.zeros((b, ins_cap), np.int32)
    ib = np.zeros((b, ins_cap), np.int8)
    inn = np.zeros(b, np.int32)
    lib.realign_block_native(_ptr(counts), _ptr(rows_old), _ptr(seqs),
                             _ptr(ways), _ptr(lengths), b, c, l,
                             bandwidth, _ptr(new_rows), _ptr(best),
                             _ptr(iy), _ptr(ib), _ptr(inn), ins_cap)
    return new_rows, best, iy, ib, inn


def splice_cols(arr, positions, cols):
    """np.insert(arr, positions, cols, axis=1) for int8 arrays with
    ascending pre-insertion positions, as one row-major native merge
    pass. cols: [N, R]. Returns the new array."""
    lib = get_lib()
    arr = np.ascontiguousarray(arr, np.int8)
    pos = np.ascontiguousarray(positions, np.int64)
    cols_t = np.ascontiguousarray(np.asarray(cols, np.int8).T)
    r, c = arr.shape
    n = len(pos)
    out = np.empty((r, c + n), np.int8)
    lib.splice_cols_native(_ptr(arr), r, c, _ptr(pos), _ptr(cols_t),
                           n, _ptr(out))
    return out


def initial_align(template, seqs_padded, lengths):
    """Native glocal full-DP alignment batch. Returns (alignments
    int32 [B, Lmax] (-1 padded), errors float64 [B])."""
    lib = get_lib()
    template = np.ascontiguousarray(template, np.int8)
    seqs_padded = np.ascontiguousarray(seqs_padded, np.int8)
    lengths = np.ascontiguousarray(lengths, np.int32)
    b, lmax = seqs_padded.shape
    out = np.zeros((b, lmax), np.int32)
    err = np.zeros(b, np.float64)
    lib.initial_align_native(_ptr(template), len(template),
                             _ptr(seqs_padded), _ptr(lengths), b, lmax,
                             _ptr(out), _ptr(err))
    return out, err


def initial_align_banded(template, seqs_padded, lengths, centers, band):
    """Banded glocal alignment around precomputed center paths.
    Returns (alignments int32 [B, Lmax], errors float64 [B])."""
    lib = get_lib()
    template = np.ascontiguousarray(template, np.int8)
    seqs_padded = np.ascontiguousarray(seqs_padded, np.int8)
    lengths = np.ascontiguousarray(lengths, np.int32)
    centers = np.ascontiguousarray(centers, np.int32)
    b, lmax = seqs_padded.shape
    out = np.zeros((b, lmax), np.int32)
    err = np.zeros(b, np.float64)
    lib.initial_align_banded_native(_ptr(template), len(template),
                                    _ptr(seqs_padded), _ptr(lengths),
                                    _ptr(centers), b, lmax, band,
                                    _ptr(out), _ptr(err))
    return out, err


def occurrence_rows(part, reads_padded, rlens):
    """Native last-DP-rows of a template part vs padded reads.
    Returns int32 [B, Lmax]."""
    lib = get_lib()
    part = np.ascontiguousarray(part, np.int8)
    reads_padded = np.ascontiguousarray(reads_padded, np.int8)
    rlens = np.ascontiguousarray(rlens, np.int32)
    b, lmax = reads_padded.shape
    out = np.zeros((b, lmax), np.int32)
    lib.occurrence_rows_native(_ptr(part), len(part),
                               _ptr(reads_padded), _ptr(rlens), b, lmax,
                               _ptr(out))
    return out


class MaxCorrBitsets:
    """Banded bitset state for the native MaxCorrs scan.

    Rows are sorted by coverage start before bit-packing (per-column
    MaxCorrs are row-order invariant) so each column's coverage spans a
    narrow word band; the scan intersects only overlapping bands."""

    def __init__(self, msa: np.ndarray):
        lib = get_lib()
        self.lib = lib
        msa = np.asarray(msa, np.int8)
        r, c = msa.shape
        starts = np.argmax(msa < 5, axis=1)
        order = np.argsort(starts, kind="stable")
        msa_t = np.ascontiguousarray(msa[order].T)       # [C, R]
        self.r, self.c = r, c
        self.w = (r + 63) // 64
        self.cov_bits = np.zeros((c, self.w), np.uint64)
        self.grp_bits = np.zeros((c, 5, self.w), np.uint64)
        self.sizes = np.zeros((c, 5), np.int32)
        self.covcnt = np.zeros(c, np.int32)
        self.wlo = np.zeros(c, np.int32)
        self.whi = np.zeros(c, np.int32)
        lib.maxcorr_build(_ptr(msa_t), c, r, _ptr(self.cov_bits),
                          _ptr(self.grp_bits), _ptr(self.sizes),
                          _ptr(self.covcnt), _ptr(self.wlo),
                          _ptr(self.whi))

    def scan(self, maxcorrs: np.ndarray, s0: int, s1: int,
             mincov: int, gap: int, maxgroup: int, majority: bool,
             fast: bool, threads: int) -> None:
        """Scan seed columns [s0, s1), max-accumulating into maxcorrs
        (float64 [C*5], in/out — prior values both persist and prune)."""
        assert maxcorrs.dtype == np.float64 and maxcorrs.flags.c_contiguous
        self.lib.maxcorr_scan(
            _ptr(self.cov_bits), _ptr(self.grp_bits), _ptr(self.sizes),
            _ptr(self.covcnt), _ptr(self.wlo), _ptr(self.whi),
            self.c, self.r, s0, s1, mincov, gap, maxgroup,
            1 if majority else 0, 1 if fast else 0, threads,
            _ptr(maxcorrs))
