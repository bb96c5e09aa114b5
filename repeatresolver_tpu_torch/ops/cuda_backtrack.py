"""Kernel B's wrapper: the backtrack walk, and the backtrack around it.

Counterpart of repeatresolver_tpu/ops/pallas_backtrack.py:

  * `backtrack_moves`: for CUDA tensors it launches
    csrc/walk_backtrack.cu, for CPU tensors it runs `walk_plain`; both
    turn the packed staircase codes into one move record per (row, x),
    y_at << 2 | move (1 diagonal, 2 insert) or -1. The walk runs in
    descending x; per x one search finds the largest window lane
    <= y - a with a nonzero code, which is where the reference
    backtracker's gap run ends and its x-move fires (PW_ReAligner.c
    :1375-1410). Lanes above the window are forced gaps (the band-jump
    rule, :285-295). `backtrack_moves.launches` counts kernel launches.
  * `moves_to_outputs`: rebuilds the rewritten rows and the insert
    lists from the move records (torch ops).
  * `entry_and_backtrack`: entry scan + walk + rebuild, the port of
    entry_and_backtrack_pallas.
"""
from __future__ import annotations

import torch

from . import _build
from .banded_realign import BIG, MAX_INSERTS, entry_scan
from .cuda_realign import _check


def walk_plain(codes, wayin, aint, lengths, *, chunk: int):
    """Plain torch walk: codes int32 [NW, B, W2] packed time-major,
    wayin int32 [B], aint int32 [B, NC] window start per chunk, lengths
    int32 [B] -> moves int32 [NW, B, 16]."""
    nw, b, w2 = codes.shape
    dev = codes.device
    lane = torch.arange(w2, dtype=torch.int32, device=dev)[None, :]
    moves = torch.empty((nw, b, 16), dtype=torch.int32, device=dev)
    y = wayin.to(torch.int32).clone()
    for x in range(nw * 16 - 1, -1, -1):
        active = (x < lengths) & (y > -1)
        a = aint[:, x // chunk]
        j = y - a
        code = (codes[x >> 4] >> (2 * (x & 15))) & 3
        cand = (code != 0) & (lane <= j[:, None]) & active[:, None]
        pm = torch.where(cand, (lane << 2) | code, -1).max(dim=1).values
        found = pm >= 0
        y_at = a + (pm >> 2)
        mv = pm & 3
        moves[x >> 4, :, x & 15] = torch.where(
            active & found, (y_at << 2) | mv, -1)
        y = torch.where(active,
                        torch.where(found,
                                    torch.where(mv == 2, y_at, y_at - 1),
                                    -1),
                        y)
    return moves


def backtrack_moves(codes, wayin, aint, lengths, *, chunk: int):
    """The walk: kernel B for CUDA tensors, `walk_plain` for CPU ones."""
    dev = codes.device
    _check("codes", codes, torch.int32, 3, dev)
    _check("wayin", wayin, torch.int32, 1, dev)
    _check("aint", aint, torch.int32, 2, dev)
    _check("lengths", lengths, torch.int32, 1, dev)
    nw, b, w2 = codes.shape
    if wayin.shape != (b,) or lengths.shape != (b,) \
            or aint.shape[0] != b or aint.shape[1] * chunk < nw * 16:
        raise ValueError("backtrack_moves: inconsistent shapes codes "
                         f"{tuple(codes.shape)} wayin "
                         f"{tuple(wayin.shape)} aint {tuple(aint.shape)}"
                         f" lengths {tuple(lengths.shape)}")
    if chunk % 16 or chunk < 16:
        raise ValueError(f"backtrack_moves: unsupported chunk {chunk}")
    if dev.type == "cpu":
        return walk_plain(codes, wayin, aint, lengths, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"backtrack_moves: unsupported device {dev}")
    lib = _build.load("walk_backtrack")
    moves = torch.empty((nw, b, 16), dtype=torch.int32, device=dev)
    p = _build.ptr
    ev = _build.launch_events("walk_backtrack")
    if ev:
        ev[0].record()
    err = lib.walk_backtrack_launch(
        p(codes), p(wayin), p(aint), p(lengths), p(moves), b, w2, chunk,
        nw, aint.shape[1], _build.stream_ptr(dev))
    if ev:
        ev[1].record()
    _build.check(lib, "walk_backtrack", err)
    backtrack_moves.launches += 1
    return moves


backtrack_moves.launches = 0


def moves_to_outputs(moves, seqs, lengths, best, *, cpad: int,
                     ins_cap: int = MAX_INSERTS):
    """Rows and insert lists from the per-x move records.

    moves int32 [NW, B, 16]; seqs int8 [B, NW*16]; returns (new_rows
    int8 [B, cpad] (4 for a gap, the base for a diagonal, 5 elsewhere),
    best int32 [B], ins_y int32 [B, ins_cap], ins_base int8
    [B, ins_cap], ins_n int32 [B]). Inserts are listed in discovery
    order (descending x); the lists of a row with more than ins_cap
    inserts are not valid (callers check ins_n against the width).
    Scatters that the JAX version dropped out of
    range land in one sentinel column, sliced off afterwards."""
    nw, b, _ = moves.shape
    dev = moves.device
    lpad = nw * 16
    m = moves.permute(1, 0, 2).reshape(b, lpad)
    xs = torch.arange(lpad, dtype=torch.int32, device=dev)[None, :]
    inlen = xs < lengths[:, None]
    valid = inlen & (m >= 0)
    y_at = m >> 2
    code = m & 3
    diag = valid & (code == 1)
    ins = valid & (code == 2)
    # a valid x without a move record: the walk died there (y hit -1),
    # so every column below was consumed
    dead = (inlen & (m < 0)).any(dim=1)
    # final y: after the last executed move; monotone along the walk
    y_after = torch.where(valid, y_at - (code == 1).to(torch.int32), BIG)
    y_fin = torch.where(dead, -1, y_after.min(dim=1).values)
    y_fin = torch.where(lengths > 0, y_fin, -1)
    # highest written column: the first x-move's (the trailing gap run
    # above it lies at x = len-1 and writes nothing)
    m_last = torch.gather(m, 1, (lengths - 1).clamp(min=0).long()[:, None])
    m_last = m_last[:, 0]
    yh = torch.where((lengths > 0) & (m_last >= 0), m_last >> 2, -1)
    ycols = torch.arange(cpad, dtype=torch.int32, device=dev)[None, :]
    out = torch.full((b, cpad + 1), 5, dtype=torch.int8, device=dev)
    out[:, :cpad] = torch.where(
        (ycols > y_fin[:, None]) & (ycols <= yh[:, None]), 4, 5).to(
        torch.int8)
    out.scatter_(1, torch.where(diag, y_at, cpad).long(),
                 seqs.to(torch.int8))
    # the insert at x gets slot = number of inserts at lanes > x
    o = torch.flip(torch.cumsum(torch.flip(ins, [1]).to(torch.int32), 1,
                                dtype=torch.int32), [1])
    inn = o[:, 0].contiguous()
    slot = (o - 1).clamp(0, ins_cap - 1)
    iyb = torch.zeros((b, ins_cap + 1), dtype=torch.int32, device=dev)
    iyb.scatter_(1, torch.where(ins, slot, ins_cap).long(),
                 (y_at << 2) | seqs.to(torch.int32))
    iyb = iyb[:, :ins_cap]
    return (out[:, :cpad].contiguous(), best, iyb >> 2,
            (iyb & 3).to(torch.int8), inn)


def entry_and_backtrack(codes, final_band, final_anf, seqs, anf_full,
                        entry_bound, lengths, ncols: int, *, cpad: int,
                        bandwidth: int, chunk: int):
    """Entry scan + walk + rebuild on the packed staircase codes; the
    port of entry_and_backtrack_pallas (same outputs, bit for bit).

    codes int32 [Lpad/16, B, W2] from the staircase fill; bandwidth is
    the code row width W2 = band + widen*chunk; anf_full int32 [B, L]
    the per-position window starts (constant per chunk)."""
    wayin, best = entry_scan(final_band, final_anf, entry_bound, ncols,
                             cpad=cpad, bandwidth=bandwidth)
    aint = anf_full[:, ::chunk].to(torch.int32).contiguous()
    nw = codes.shape[0]
    b, l = seqs.shape
    if nw * 16 != l:
        seqs = torch.nn.functional.pad(seqs, (0, nw * 16 - l))
    moves = backtrack_moves(codes, wayin, aint, lengths.to(torch.int32),
                            chunk=chunk)
    return moves_to_outputs(moves, seqs, lengths, best, cpad=cpad)
