"""Banded realignment DP (PW_ReAligner.c:1493-1513): the exact band.

Counterpart of repeatresolver_tpu/ops/banded_realign.py, for a block of
rows at once, each against the shared column histogram with its own
contribution removed. Per sequence position x, all rows fill their
bandwidth-W window:

    A[y]   = min( M[x-1,y-1] + Score(y, base_x),
                  M[x-1,y]   + max(Score(y,5), Score(y-1,5)) )   0<y<C-1
    M[x,y] = min_{j<=y} A[j] + sum_{t=j+1..y} Score(t,4)
           = Gy[y] + cummin( A - Gy )

Reads of the previous row above its band pay the per-column gap cost
(the reference's MatrixOut jump rule, :285-295) through the gap-cost
prefix sums. Move codes carry the backtracker's priority (gap, then
diagonal, then insert, :1375-1410).

`banded_fill` and `entry_and_backtrack` are torch ops driven by a host
loop, one iteration per sequence position and per backtrack move. They
are the oracle of the staircase band (bit-equal for any covering slack),
the exact band of CPU tensors and the plain versions of kernels F and G
(ops/cuda_exact.py), which run the exact band on CUDA tensors.
`banded_fill.calls` counts runs of the loop: on the card it stays 0.

All DP values are int32 and every sum wraps modulo 2**32, as XLA's
int32 arithmetic does: `BIG + cost` ties decide move codes, so the
sentinel and its dtype are part of the contract.
"""
from __future__ import annotations

import torch

BIG = 1 << 30
MAX_INSERTS = 2048


def row_costs(counts: torch.Tensor, rows_old: torch.Tensor):
    """Per-row cost arrays with the row's own contribution removed.

    counts int32 [C, 6]; rows_old int8 [B, C]. Returns ns, gapcost,
    inscost int32 [B, C] and the gap-cost prefix g int32 [B, C+1]
    (g[:, y] = sum of gapcost[:, :y])."""
    counts = counts.to(torch.int32)
    own = rows_old.to(torch.int32)
    ns_all = counts[:, 0:5].sum(dim=1, dtype=torch.int32)
    ns = ns_all[None, :] - (own < 5).to(torch.int32)
    gapcost = ns - (counts[None, :, 4] - (own == 4).to(torch.int32))
    inscost = torch.maximum(ns, torch.cat([ns[:, :1], ns[:, :-1]], dim=1))
    b = rows_old.shape[0]
    g = torch.cat([torch.zeros((b, 1), dtype=torch.int32,
                               device=rows_old.device),
                   torch.cumsum(gapcost, dim=1, dtype=torch.int32)], dim=1)
    return ns, gapcost, inscost, g


def entry_scan(final_band: torch.Tensor, final_anf: torch.Tensor,
               entry_bound: torch.Tensor, ncols: int, *, cpad: int,
               bandwidth: int):
    """Entry-column scan over M[L-1, y] for y in (bound, ncols-1]
    (PW_ReAligner.c:1353-1360): returns (wayin, best) int32 [B].

    Ties go to the largest y, and `best` is seeded at y = ncols-1
    whatever the bound (reference semantics). Columns above the band
    read the band's top lane (the last row's flat-space rule)."""
    w = bandwidth
    dev = final_band.device
    ycols = torch.arange(cpad, dtype=torch.int32, device=dev)[None, :]
    j = ycols - final_anf.to(torch.int32)[:, None]
    band = final_band.to(torch.int32)
    vals = torch.gather(band, 1, j.clamp(0, w - 1).long())
    vals = torch.where((j >= 0) & (j < w), vals, BIG)
    vals = torch.where(j >= w, band[:, w - 1:w], vals)
    vals = torch.where(ycols < ncols, vals, BIG)
    scan_ok = (ycols > entry_bound.to(torch.int32)[:, None]) \
        & (ycols < ncols)
    scan_vals = torch.where(scan_ok, vals, BIG)
    scan_vals = torch.where(ycols == ncols - 1, vals, scan_vals)
    best = scan_vals.min(dim=1).values
    wayin = torch.where(scan_vals == best[:, None], ycols,
                        -1).max(dim=1).values
    return wayin.to(torch.int32), best.to(torch.int32)


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [B, N] read at idx [B, ...] along dim 1 (one gather)."""
    b = arr.shape[0]
    return torch.gather(arr, 1, idx.reshape(b, -1).long()).reshape(idx.shape)


def banded_fill(counts, rows_old, seqs, ways, lengths, ncols, *,
                bandwidth: int, chunk: int = 256):
    """Exact-band DP fill for a block.

    counts int32 [Cp, 6]; rows_old int8 [B, Cp]; seqs int8 [B, L]; ways
    int32 [B, L]; lengths int32 [B]; ncols the real column count (the
    arrays may be padded beyond it with symbol 5 and zero counts).
    Returns (codes uint8 [B, L, W], final_band int32 [B, W], final_anf
    int32 [B]); codes is a [B, L, W] view of time-major storage.

    An outer loop over chunks of `chunk` positions gathers every banded
    cost window of the chunk in one pass ([B, T, W] tensors); the inner
    loop over the chunk's positions then reads the previous band shifted
    by the band's advance and takes one prefix-min."""
    w = bandwidth
    bh = w // 2
    dev = rows_old.device
    b = rows_old.shape[0]
    l = seqs.shape[1]
    t = chunk
    nchunks = -(-l // t)
    lpad = nchunks * t
    ncols = int(ncols)
    i32 = torch.int32
    seqs = seqs.to(i32)
    ways = ways.to(i32)
    lengths = lengths.to(i32)
    if lpad != l:
        seqs = torch.nn.functional.pad(seqs, (0, lpad - l))
        ways = torch.cat([ways, ways[:, -1:].expand(b, lpad - l)], dim=1)

    ns, gapcost, inscost, g = row_costs(counts, rows_old)
    own = rows_old.to(i32)
    pad = w + 1
    gapp = torch.nn.functional.pad(gapcost, (0, pad))
    insp = torch.nn.functional.pad(inscost, (0, pad))
    nsp = torch.nn.functional.pad(ns, (0, pad))
    gp = torch.cat([g, g[:, -1:].expand(b, pad)], dim=1)   # [B, C+1+pad]
    ownp = torch.nn.functional.pad(own, (0, pad), value=5)
    # counts of the symbols 0..3, flattened for a one-gather lookup
    counts4 = torch.nn.functional.pad(counts.to(i32)[:, 0:4],
                                      (0, 0, 0, pad)).reshape(1, -1)

    anf_all = (ways - bh).clamp(min=0)                     # [B, Lp]
    arange_w = torch.arange(w, dtype=i32, device=dev)
    shift_idx = torch.arange(w + 1, dtype=torch.int64, device=dev)[None, :]
    big_col = torch.full((b, 1), BIG, dtype=i32, device=dev)
    big_tail = torch.full((b, w + 2), BIG, dtype=i32, device=dev)
    codes = torch.empty((lpad, b, w), dtype=torch.uint8, device=dev)
    band = torch.zeros((b, w), dtype=i32, device=dev)
    anf_prev = torch.zeros((b,), dtype=i32, device=dev)
    for ci in range(nchunks):
        x0 = ci * t
        anf_c = anf_all[:, x0:x0 + t]                      # [B, T]
        seq_c = seqs[:, x0:x0 + t]
        ys = anf_c[:, :, None] + arange_w[None, None, :]   # [B, T, W]
        gap_w = _take(gapp, ys)
        ins_w = _take(insp, ys)
        gy1_w = _take(gp, ys + 1)
        gp_anf = _take(gp, anf_c)                          # [B, T]
        cnt_w = _take(counts4.expand(b, -1), ys * 4 + seq_c[:, :, None])
        sub_w = _take(nsp, ys) - (cnt_w - (_take(ownp, ys)
                                           == seq_c[:, :, None]).to(i32))
        # gp[ys]: gp[ys + 1] shifted by one lane, gp[anf] at lane 0
        gy0_w = torch.cat([gp_anf[:, :, None], gy1_w[:, :, :-1]], dim=2)
        # the jump rule's base, gp[anf(x-1) + W]
        anf_prev_c = torch.cat([anf_prev[:, None], anf_c[:, :-1]], dim=1)
        gtop_c = _take(gp, anf_prev_c + w)                 # [B, T]
        ok_w = (ys > 0) & (ys < ncols - 1)
        valid_w = ys < ncols
        for tt in range(t):
            x = x0 + tt
            anf = anf_c[:, tt]
            gy1 = gy1_w[:, tt]
            if x == 0:
                # MatrixOut(-1, .) = 0 for every y (PW_ReAligner.c:256)
                diag_prev = up_prev = torch.zeros_like(band)
            else:
                d = anf - anf_prev                         # band advance
                # the previous band shifted by d: lane i reads j = i+d-1
                # (diagonal) and j = i+d (insert)
                ext = torch.cat([big_col, band, big_tail], dim=1)
                sl = torch.gather(
                    ext, 1, d.clamp(0, w + 1).long()[:, None] + shift_idx)
                j0 = arange_w[None, :] + d[:, None]
                top = band[:, w - 1:w] - gtop_c[:, tt:tt + 1]
                diag_prev = torch.where(
                    j0 - 1 >= w, top + gy0_w[:, tt],
                    torch.where(j0 - 1 >= 0, sl[:, :w], BIG))
                up_prev = torch.where(
                    j0 >= w, top + gy1,
                    torch.where(j0 >= 0, sl[:, 1:], BIG))
            diag = diag_prev + sub_w[:, tt]
            a = torch.minimum(diag, torch.where(ok_w[:, tt],
                                                up_prev + ins_w[:, tt], BIG))
            a = torch.where(valid_w[:, tt], a, BIG)
            m = torch.cummin(a - gy1, dim=1).values + gy1
            left = torch.cat([big_col, m[:, :-1]], dim=1)
            # backtracker priority (PW_ReAligner.c:1375-1410): gap, the
            # x == L-1 flat-space arm (M == left), diagonal, insert
            is_last = (lengths == x + 1)[:, None]
            gap_hit = (m == left + gap_w[:, tt]) | (is_last & (m == left))
            codes[x] = torch.where(gap_hit, 0, torch.where(m == diag, 1, 2))
            active = lengths > x
            band = torch.where(active[:, None], m, band)
            anf_prev = torch.where(active, anf, anf_prev)
    banded_fill.calls += 1
    return codes[:l].permute(1, 0, 2), band, anf_prev


banded_fill.calls = 0


def entry_and_backtrack(codes, final_band, final_anf, seqs, anf_full,
                        entry_bound, lengths, ncols, *, cpad: int,
                        bandwidth: int, time_major: bool = False):
    """Entry-column scan and lockstep backtrack over unpacked move codes.

    codes uint8 [B, Lc, W] (or [Lc, B, W] with time_major; Lc may exceed
    L, reads are bounded by lengths <= L); anf_full int32 [B, L] the
    band start of every position (exact band: max(0, way - W//2);
    staircase: the chunk's window start); entry_bound int32 [B] the
    lowest-exclusive column of the entry scan (max(-1, way[len-1] -
    W//2)); bandwidth the width of the code rows. Returns (new_rows int8
    [B, cpad]: 4 for a gap, the base for a diagonal, 5 elsewhere; best
    int32 [B]; ins_y int32 [B, MAX_INSERTS]; ins_base int8
    [B, MAX_INSERTS]; ins_n int32 [B]).

    Every row makes one move per iteration of a host loop: a gap or a
    diagonal consumes a column, a diagonal or an insert a position. The
    state stays on the device; the host reads the stop flag every 64
    moves. Writes of rows that have stopped land in a sentinel column
    and a sentinel slot, sliced off at the end."""
    w = bandwidth
    dev = seqs.device
    b, l = seqs.shape
    ncols = int(ncols)
    i32 = torch.int32
    lengths = lengths.to(i32)
    wayin, best = entry_scan(final_band, final_anf, entry_bound, ncols,
                             cpad=cpad, bandwidth=w)
    seqs8 = seqs.to(torch.int8)
    anf_full = anf_full.to(i32)
    bidx = torch.arange(b, device=dev)
    last_x = lengths - 1
    out = torch.full((b, cpad + 1), 5, dtype=torch.int8, device=dev)
    iy = torch.zeros((b, MAX_INSERTS + 1), dtype=i32, device=dev)
    ib = torch.zeros((b, MAX_INSERTS + 1), dtype=torch.int8, device=dev)
    inn = torch.zeros((b,), dtype=i32, device=dev)
    x = last_x.clone()
    y = wayin.clone()
    gap_sym = torch.full((b,), 4, dtype=torch.int8, device=dev)
    for it in range(cpad + l + w + 8):
        active = (x > -1) & (y > -1)
        if it % 64 == 0 and not bool(active.any()):
            break
        xc = x.clamp(min=0).long()
        anf = anf_full[bidx, xc]
        sx = seqs8[bidx, xc]
        off = (y - anf).clamp(0, w - 1).long()
        code = codes[xc, bidx, off] if time_major else codes[bidx, xc, off]
        above = y > anf + (w - 1)
        gap_move = active & (above | (code == 0))
        x_move = active & ~above
        diag_move = x_move & (code == 1)
        ins_move = x_move & (code == 2)
        # a gap at the row's last position is trailing space: no write
        do_write = (gap_move & (x != last_x)) | diag_move
        out[bidx, torch.where(do_write, y, cpad).long()] = \
            torch.where(diag_move, sx, gap_sym)
        slot = torch.where(ins_move, inn.clamp(0, MAX_INSERTS - 1),
                           MAX_INSERTS).long()
        iy[bidx, slot] = y
        ib[bidx, slot] = sx
        inn = inn + ins_move.to(i32)
        y = y - (gap_move | diag_move).to(i32)
        x = x - (diag_move | ins_move).to(i32)
    return (out[:, :cpad].contiguous(), best, iy[:, :MAX_INSERTS].contiguous(),
            ib[:, :MAX_INSERTS].contiguous(), inn)
