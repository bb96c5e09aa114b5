"""Batched glocal edit-distance DP, on the card through kernels C and D.

Counterpart of repeatresolver_tpu/ops/editdp.py, the compute core of
ReadCutter's Occurrence (ReadCutter.c:489-568) and InitialAligner's
IntoAligner (InitialAligner.c:282-453). The recurrence (query char x vs
target char y, the target consumed for free at both ends):

    M[-1][y] = 0,  M[x][-1] = x + 1
    M[x][y]  = min(M[x-1][y-1] + (q[x] != t[y]),   # diagonal
                   M[x-1][y]   + 1,                # consume query ('d')
                   M[x][y-1]   + 1)                # consume target ('i')

Move codes keep the reference's tie priority (InitialAligner.c:294-324):
diagonal wins ties, then 'i' (left), then 'd' (up); codes 0=sub 3=match
1='i' 2='d'.

`last_rows`, `align_with_codes` and `align_on_device` route by the
queries' device: CUDA tensors go to kernel C (the fill) and kernel D
(the entry scan and the walk) through ops/cuda_editdp.py, CPU tensors to
the plain version, a Python loop of torch ops over DP rows
(`forward_plain`, which resolves the in-row dependency M[x][y-1] with
one cummin a row: with A[y] = min(diag, up), M[x][y] = y + cummin_y(A[y]
- y, boundary x+2 at y=-1)) and over walk steps (`walk_plain`). Both
give the same bits.

`last_rows.calls` and `align_on_device.calls` count calls;
`forward_plain.calls` and `walk_plain.calls` count runs of the plain
loop.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import native
from . import cuda_editdp

BIG = np.int32(1 << 29)
# backtrack steps between host reads of the "any walk alive" flag
CHECK_EVERY = 64


def forward_plain(queries, qlens, targets, codes=None):
    """The plain version of kernel C: the DP rows x = 0 .. Lq-1 against
    targets [B, Lt] (a shared target expanded is fine): the final rows
    M[qlen-1][:] (rows of qlen 0 stay 0), and, when codes (int8
    [Lq, B, Lt]) is given, every row's move codes written into it.

    The row is kept with its left boundary in column 0 (M[x][-1] = x+1),
    so the diagonal, up and left neighbours are views, not copies."""
    b, lq = queries.shape
    lt = targets.shape[1]
    dev = queries.device
    q_t = queries.t().contiguous()                  # [Lq, B]
    iota = torch.arange(lt, dtype=torch.int32, device=dev)[None, :]
    m_prev = torch.zeros((b, lt + 1), dtype=torch.int32, device=dev)
    m_next = torch.empty_like(m_prev)
    shifted = torch.empty_like(m_prev)
    fr = torch.zeros((b, lt), dtype=torch.int32, device=dev)
    # rows whose last query position is x, per x (host-side lengths)
    last_x = (qlens.to("cpu", torch.int64) - 1).tolist()
    ends: dict[int, list[int]] = {}
    for r, xl in enumerate(last_x):
        if xl >= 0:
            ends.setdefault(xl, []).append(r)
    for x in range(lq):
        m_prev[:, 0] = x                            # M[x-1][-1]
        mism = q_t[x][:, None] != targets
        # diag M[x-1][y-1] + mismatch, up M[x-1][y] + 1
        diag = m_prev[:, :-1] + mism
        up = m_prev[:, 1:] + 1
        # boundary M[x][-1] = x+1 participates as (x+1) - (-1) = x+2
        shifted[:, 0] = x + 2
        torch.sub(torch.minimum(diag, up), iota, out=shifted[:, 1:])
        m_next[:, 0] = x + 1                        # M[x][-1]
        torch.add(torch.cummin(shifted, dim=1).values[:, 1:], iota,
                  out=m_next[:, 1:])
        if codes is not None:
            # tie priority: diag, then left ('i', 1), then up ('d', 2)
            left1 = m_next[:, :-1] + 1
            c_left = left1 < diag
            c_up = up < torch.where(c_left, left1, diag)
            code = torch.where(c_left, 1, torch.where(mism, 0, 3))
            codes[x] = torch.where(c_up, 2, code)
        rows = ends.get(x)
        if rows:
            idx = torch.tensor(rows, device=dev)
            fr[idx] = m_next[idx, 1:]
        m_prev, m_next = m_next, m_prev
    forward_plain.calls += 1
    return fr


forward_plain.calls = 0


def _qlens32(qlens, dev):
    if qlens.device != dev:
        qlens = qlens.to(dev)
    return qlens.to(torch.int32).contiguous()


def last_rows(queries: torch.Tensor, qlens: torch.Tensor,
              targets: torch.Tensor) -> torch.Tensor:
    """Final DP rows M[qlen-1][:] for a batch.

    queries [B, Lq] integer (pad arbitrary; int16 on the card), qlens
    [B], targets [B, Lt] or [Lt] (broadcast), all on one device; any
    strides. Returns int32 [B, Lt]; columns beyond a target's real
    length are garbage for the caller to mask, and rows of qlen 0 stay
    0."""
    if targets.dim() == 1:
        targets = targets[None, :].expand(queries.shape[0], -1)
    if queries.device.type == "cuda":
        fr, _ = cuda_editdp.editdp_fill(
            queries, _qlens32(qlens, queries.device), targets)
    else:
        fr = forward_plain(queries, qlens, targets)
    last_rows.calls += 1
    return fr


last_rows.calls = 0


def _codes_and_rows(queries, qlens, target):
    b, lq = queries.shape
    codes = torch.empty((lq, b, target.shape[0]), dtype=torch.int8,
                        device=queries.device)
    fr = forward_plain(queries, qlens, target[None, :].expand(b, -1), codes)
    return codes, fr


def align_with_codes(queries: torch.Tensor, qlens: torch.Tensor,
                     target: torch.Tensor):
    """Full DP with move codes against one shared target.

    queries [B, Lq], qlens [B], target [Lt]. Returns (codes int8
    [B, Lq, Lt], final rows int32 [B, Lt]); the codes cover every row,
    past a query's length included."""
    if queries.device.type == "cuda":
        fr, codes = cuda_editdp.editdp_fill(
            queries, _qlens32(qlens, queries.device), target, codes="int8")
    else:
        codes, fr = _codes_and_rows(queries, qlens, target)
    return codes.permute(1, 0, 2), fr


def walk_plain(codes, qlens, fr):
    """The plain version of kernel D: the entry scan and the lockstep
    backtrack over codes int8 [Lq, B, Lt] (forward_plain's layout) with
    the final rows fr [B, Lt]. Returns alignments int32 [B, Lq]."""
    lq, b, lt = codes.shape
    dev = codes.device
    # entry scan: min over columns [1, lt-1], ties -> the largest column
    # (argmin returns the first minimum of the reversed row)
    entries = lt - 1 - torch.argmin(fr[:, 1:].flip(1), dim=1)

    codes_flat = codes.view(-1)
    row_code = torch.arange(b, device=dev) * lt     # codes[x, r, y] at
    row_out = torch.arange(b, device=dev) * lq      # x*b*lt + r*lt + y
    x = qlens.to(device=dev, dtype=torch.int64) - 1
    y = entries.to(torch.int64)
    # one spare slot at the end takes the writes of rows that place no
    # base this step
    out = torch.full((b * lq + 1,), -1, dtype=torch.int32, device=dev)
    spare = torch.full((b,), b * lq, dtype=torch.int64, device=dev)
    # The JAX loop runs while any walk is alive, at most lq + lt + 4
    # steps. A step after every walk has ended changes nothing (no row
    # is active), so the alive flag is read every CHECK_EVERY steps
    # without changing a bit.
    limit = lq + lt + 4
    it = 0
    while it < limit:
        for _ in range(min(CHECK_EVERY, limit - it)):
            active = torch.minimum(x, y) >= 0
            xs = x.clamp(min=0)
            code = codes_flat[xs * (b * lt) + row_code + y.clamp(min=0)]
            # 0 sub / 3 match: diagonal; 1 'i': left; 2 'd': up
            dx = (code != 1) & active
            dy = (code != 2) & active
            placed = dx & dy
            out[torch.where(placed, row_out + xs, spare)] = \
                y.to(torch.int32)
            x = x - dx.to(torch.int64)
            y = y - dy.to(torch.int64)
            it += 1
        if not bool((torch.minimum(x, y) >= 0).any()):
            break
    walk_plain.calls += 1
    return out[:b * lq].view(b, lq)


walk_plain.calls = 0


def align_on_device(queries: torch.Tensor, qlens: torch.Tensor,
                    target: torch.Tensor):
    """Full alignment with the backtrack on the device: only the
    per-base alignments and the final rows leave it (the move codes
    stay; on the card two bits a code). Returns (alignments int32
    [B, Lq], final rows); alignments[b, i] is the target column of query
    base i, or -1, the semantics of backtrack_batch. The target needs at
    least 2 columns (the entry scan never examines column 0)."""
    if target.shape[0] < 2:
        raise ValueError("align_on_device: the entry scan needs a target "
                         f"of at least 2 columns, got {target.shape[0]}")
    if queries.device.type == "cuda":
        ql = _qlens32(qlens, queries.device)
        fr, packed = cuda_editdp.editdp_fill(queries, ql, target,
                                             codes="packed")
        out = cuda_editdp.editdp_walk(packed, ql, fr)
    else:
        codes, fr = _codes_and_rows(queries, qlens, target)
        out = walk_plain(codes, qlens, fr)
    align_on_device.calls += 1
    return out, fr


align_on_device.calls = 0


def code_bytes_per_row(lq: int, lt: int, device) -> int:
    """Device bytes of one batch row's move codes in align_on_device: two
    bits a code in kernel C's packed layout on the card, a byte a code in
    the plain version's."""
    if torch.device(device).type == "cuda":
        return cuda_editdp.packed_bytes_per_row(lq, lt)
    return lq * lt


def entry_column(final_row: np.ndarray) -> int:
    """The reference entry scan (InitialAligner.c:336-346 /
    ReadCutter.c:398-408): minimum over columns [1, Lt-1] scanned
    descending with strict '<'; ties pick the LARGEST column; column 0
    is never examined."""
    fr = np.asarray(final_row)
    lt = fr.shape[0]
    rev = fr[1:][::-1]
    return int(lt - 1 - int(np.argmin(rev)))


def backtrack_batch(codes: np.ndarray, qlens: np.ndarray,
                    entries: np.ndarray,
                    use_native: bool = True) -> np.ndarray:
    """Host backtracking for a batch (the native C++ per-row walk, or
    with use_native=False a lockstep numpy walk).

    codes [B, Lq, Lt] int8 (align_with_codes, on the host), qlens [B],
    entries [B]. Returns alignments [B, Lq] int32: the target column of
    each query base, or -1 (InitialAligner.c:413-445); rows of qlen 0
    are all -1."""
    codes = np.asarray(codes)
    if use_native:
        return native.editdp_backtrack(codes, np.asarray(qlens),
                                       np.asarray(entries))
    b, lq, lt = codes.shape
    x = np.asarray(qlens, np.int64) - 1
    y = np.asarray(entries, np.int64).copy()
    out = np.full((b, lq), -1, np.int32)
    active = (x >= 0) & (y >= 0)
    while active.any():
        bi = np.nonzero(active)[0]
        code = codes[bi, x[bi], y[bi]]
        is_diag = (code == 0) | (code == 3)
        is_left = code == 1
        is_up = code == 2
        di = bi[is_diag]
        out[di, x[di]] = y[di]
        x[di] -= 1
        y[di] -= 1
        y[bi[is_left]] -= 1
        # 'd': a query base between template bases stays -1
        x[bi[is_up]] -= 1
        active = (x >= 0) & (y >= 0)
    # the remaining x > -1 bases are leading 'd's: already -1
    return out
