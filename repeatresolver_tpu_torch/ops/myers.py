"""Myers bit-parallel edit distance (numpy; copied from
repeatresolver_tpu/ops/myers.py, same arithmetic).

The reference carries an unused Myers aligner as a "speed up
possibility for a future version" (ReadCutter.c:196-349). This is the
working equivalent: banded-free edit distance of a short pattern
(<= 64 bases) against a long text in O(text) word operations,
vectorized over a batch of texts with numpy uint64 — a genuinely fast
host-side path for short-part occurrence scans.

last_rows_short(pattern, texts) returns the same final DP rows as
ops/editdp.last_rows for patterns up to 64 bases (tested), so it can
serve as a drop-in for ReadCutter-style occurrence scans with small
template parts.
"""
from __future__ import annotations

import numpy as np


def last_row(pattern: np.ndarray, text: np.ndarray) -> np.ndarray:
    """Final glocal DP row: score[j] = min edit distance of pattern vs
    any substring of text ending at j (free start). len(pattern) <= 64.
    """
    m = len(pattern)
    assert 0 < m <= 64
    peq = np.zeros(4, np.uint64)
    for i, ch in enumerate(np.asarray(pattern, np.int64)):
        peq[ch] |= np.uint64(1) << np.uint64(i)
    mask = np.uint64(1) << np.uint64(m - 1)
    ones = (np.uint64(0xFFFFFFFFFFFFFFFF) >> np.uint64(64 - m))

    vp = ones
    vn = np.uint64(0)
    score = m
    out = np.empty(len(text), np.int32)
    text = np.asarray(text, np.int64)
    for j in range(len(text)):
        eq = peq[text[j]] if 0 <= text[j] < 4 else np.uint64(0)
        x = eq | vn
        d0 = (((x & vp) + vp) ^ vp) | x
        hp = vn | ~(d0 | vp)
        hn = vp & d0
        if hp & mask:
            score += 1
        elif hn & mask:
            score -= 1
        # free text start: horizontal boundary carry is 0 (the |1 of
        # the textbook formulation encodes a GLOBAL top row)
        hp = np.uint64((int(hp) << 1) & int(ones))
        hn = np.uint64((int(hn) << 1) & int(ones))
        vp = (hn | ~(d0 | hp)) & ones
        vn = (hp & d0) & ones
        out[j] = score
    return out


def last_rows_batch(pattern: np.ndarray,
                    texts: np.ndarray,
                    lengths: np.ndarray | None = None) -> np.ndarray:
    """Vectorized over a batch of equal-padded texts [B, Lt] (int codes;
    pad with a non-base value). Returns int32 [B, Lt]."""
    texts = np.asarray(texts, np.int64)
    b, lt = texts.shape
    m = len(pattern)
    assert 0 < m <= 64
    peq = np.zeros(5, np.uint64)
    for i, ch in enumerate(np.asarray(pattern, np.int64)):
        peq[ch] |= np.uint64(1) << np.uint64(i)
    tex = np.where((texts >= 0) & (texts < 4), texts, 4)
    mask = np.uint64(1) << np.uint64(m - 1)
    ones = (np.uint64(0xFFFFFFFFFFFFFFFF) >> np.uint64(64 - m))

    vp = np.full(b, ones, np.uint64)
    vn = np.zeros(b, np.uint64)
    score = np.full(b, m, np.int32)
    out = np.empty((b, lt), np.int32)
    one = np.uint64(1)
    for j in range(lt):
        eq = peq[tex[:, j]]
        x = eq | vn
        d0 = (((x & vp) + vp) ^ vp) | x
        hp = vn | ~(d0 | vp)
        hn = vp & d0
        score += ((hp & mask) != 0).astype(np.int32)
        score -= ((hn & mask) != 0).astype(np.int32)
        hp = (hp << one) & ones        # free-start: no boundary carry
        hn = (hn << one) & ones
        vp = (hn | ~(d0 | hp)) & ones
        vn = (hp & d0) & ones
        out[:, j] = score
    return out
