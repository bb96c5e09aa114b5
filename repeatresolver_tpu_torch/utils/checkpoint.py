"""Checkpoint / resume.

Copied from repeatresolver_tpu/utils/checkpoint.py (same functions, same bytes
written and read).

The reference's recovery story is file-level and deliberate: the best
MSA is rewritten after every improving round (PW_ReAligner.c:1741,
blessed by README.md:71 — partial results are usable while refinement
continues), and MaxCorrs are computed once and cached on disk
(MaxCorrelation.c:1014). This module formalizes both:

  * RealignCheckpoint: MSA + round + best score pair + config, written
    atomically per improving round; `resume()` restarts the round loop
    from the stored state.
  * cached(): compute-once-reuse for array-valued stages (MaxCorrs).
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass

import numpy as np


def _atomic_write(path: str, write_fn) -> None:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".ckpt_")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


@dataclass
class RealignCheckpoint:
    msa: np.ndarray
    round: int
    best_mille: int
    best_uno: int
    bandwidth: int
    # engine state for restart-proof long runs (optional; 0/None on
    # legacy checkpoints): the realign loop's current block size (the
    # anneal position) and the device engine's learned per-block drift
    # ladder — a resumed run dispatches at the learned slack instead of
    # relearning from the configured worst case
    block_rows: int = 0
    widen_bs: int = 0
    widen: np.ndarray | None = None
    exact_blocks: np.ndarray | None = None

    def save(self, path: str) -> None:
        # two symbols (0..5) per byte, uncompressed: zlib on a paper-
        # scale MSA costs minutes per improving round; packing halves
        # the disk bytes at memcpy speed
        msa = self.msa
        r, c = msa.shape
        if c % 2:
            msa = np.concatenate(
                [msa, np.full((r, 1), 5, np.int8)], axis=1)
        packed = (msa[:, ::2].astype(np.uint8) << 4) | msa[:, 1::2]
        extra = {}
        if self.widen is not None:
            extra["widen"] = np.asarray(self.widen, np.int32)
            extra["exact_blocks"] = np.asarray(
                self.exact_blocks if self.exact_blocks is not None
                else [], np.int64)

        def w(f):
            np.savez(f, packed=packed,
                     meta=np.array([self.round, self.best_mille,
                                    self.best_uno, self.bandwidth,
                                    r, c], np.int64),
                     meta2=np.array([self.block_rows, self.widen_bs],
                                    np.int64),
                     **extra)
        _atomic_write(path, w)

    @classmethod
    def load(cls, path: str) -> "RealignCheckpoint":
        block_rows = widen_bs = 0
        widen = exact = None
        with np.load(path) as z:
            if "msa" in z:          # legacy compressed format
                msa = z["msa"]
                rnd, bm, bu, bw = (int(v) for v in z["meta"][:4])
            else:
                meta = z["meta"]
                rnd, bm, bu, bw, r, c = (int(v) for v in meta)
                packed = z["packed"]
                msa = np.empty((r, packed.shape[1] * 2), np.int8)
                msa[:, ::2] = packed >> 4
                msa[:, 1::2] = packed & 0x0F
                msa = np.ascontiguousarray(msa[:, :c])
            if "meta2" in z:
                block_rows, widen_bs = (int(v) for v in z["meta2"])
            if "widen" in z:
                widen = z["widen"]
                exact = z["exact_blocks"]
        return cls(msa=msa, round=rnd, best_mille=bm, best_uno=bu,
                   bandwidth=bw, block_rows=block_rows,
                   widen_bs=widen_bs, widen=widen, exact_blocks=exact)


def cached(path: str, compute, save, load):
    """Compute-once semantics (the MaxCorrs pattern): if `path` exists,
    load it; otherwise compute, save, return."""
    if os.path.exists(path):
        return load(path)
    value = compute()
    save(path, value)
    return value
