"""Kernels F and G's wrappers: the exact band on the card.

Counterpart of the XLA exact band of repeatresolver_tpu/ops/
banded_realign.py (`banded_fill`, `entry_scan`, `entry_and_backtrack`):

  * `exact_fill`: for CUDA tensors it launches csrc/exact_fill.cu
    (kernel F), for CPU tensors it runs `exact_fill_plain` (the torch
    exact band, ops/banded_realign.banded_fill, its codes packed). Both
    return codes int32 [ceil(L/16), B, W] in kernel B's packed
    time-major layout (16 two-bit codes a word, position x at bits
    2*(x % 16), 0 past L), the final band int32 [B, W] and its band
    start int32 [B].
  * `exact_walk`: csrc/exact_walk.cu (kernel G) or `exact_walk_plain`:
    the entry scan and the walk over those codes, one move record a
    position (y_at << 2 | move, or -1) in kernel B's layout
    [ceil(L/16), B, 16], and the entry column and best value a row.
  * `entry_and_backtrack`: the walk, then the rows and insert lists
    (cuda_backtrack.moves_to_outputs), the lists as wide as the walk's
    largest insert count (at least MAX_INSERTS; or a bound the caller
    gives): any count is listed, as the host native engine lists it.

The walk is the lockstep walk of banded_realign.entry_and_backtrack,
one x-move a position: below the band (reachable only by a diagonal from
lane 0 when the band did not move) it reads lane 0's code at its own
column, as the lockstep walk clamps it; kernel B's walk would end there.

The wrappers check their tensors and raise on what the kernels do not
take; on a CUDA tensor they launch or raise, never fall back.
`exact_fill.launches` and `exact_walk.launches` count launches.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import trace
from . import _build
from . import banded_realign as br
from .cuda_backtrack import moves_to_outputs
from .cuda_realign import _check

# kernel F's layouts (csrc/exact_fill.cu; the C side checks what it is
# given). The clustered layout: FILL_LANES band lanes a thread, at most
# FILL_THREADS threads a CTA and a cluster of FILL_CLUSTERS CTAs a row, so
# a band of at most MAX_W lanes; a chunk is at most FILL_TMAX positions
# whose bands stay within FILL_SLACK columns of its first band, the span
# of its staged cost window. The wide layout, for wider bands: a cluster
# of WIDE_CTAS CTAs of FILL_THREADS threads, each CTA `groups` groups of
# FILL_THREADS * FILL_LANES lanes, the band in device memory
FILL_LANES = 4
FILL_THREADS = 512
FILL_CLUSTERS = (1, 2, 4, 8)
FILL_TMAX = 128
FILL_SLACK = 512
MAX_W = FILL_CLUSTERS[-1] * FILL_THREADS * FILL_LANES
WIDE_CTAS = 8


class FillGeometry(NamedTuple):
    cs: int          # CTAs a row (one cluster)
    threads: int     # threads a CTA
    lanes_cta: int   # band lanes a CTA
    span: int        # band lanes a warp: the next CTA's strip, and the
    #                  largest shift a step inside a chunk takes (0 in the
    #                  wide layout, where every step takes any shift)
    groups: int = 0  # the wide layout's lane groups a CTA (0: clustered)


def fill_geometry(w: int, cs: int | None = None,
                  wide: bool | None = None) -> FillGeometry:
    """Kernel F's layout for band w. The clustered layout (up to MAX_W
    lanes): the fewest CTAs a row (a cluster of 1, 2, 4 or 8) whose 512
    threads hold the band, so one CTA up to 2,048 lanes and eight up to
    MAX_W. At band 1,000 one CTA a row beat two and four: the CTA
    border's hand-offs cost more than the SMs gain (chip_smoke.py phase
    9, PERF.md §6). The wide layout, which the program takes past MAX_W
    (it takes any band): WIDE_CTAS CTAs a row, each as many groups of
    2,048 lanes as the band needs. `cs` and `wide` are hooks for tests
    and chip_smoke.py, which no caller in the program sets: `cs` asks for
    another number of CTAs a row, to compare layouts (the top CTA must
    hold a lane); `wide=True` takes the wide layout at a band the
    clustered layout holds, to check it at small bands."""
    if w <= 0:
        raise ValueError(f"exact_fill: unsupported band {w}")
    per_row = FILL_THREADS * FILL_LANES
    if wide is None:
        wide = w > MAX_W
    if wide:
        if cs not in (None, WIDE_CTAS):
            raise ValueError(f"exact_fill: {cs} CTAs a row in the wide "
                             "layout")
        groups = -(-w // (WIDE_CTAS * per_row))
        return FillGeometry(WIDE_CTAS, FILL_THREADS, groups * per_row, 0,
                            groups)
    if w > MAX_W:
        raise ValueError(f"exact_fill: band {w} is past the clustered "
                         f"layout's {MAX_W} lanes")
    if cs is None:
        cs = next(n for n in FILL_CLUSTERS if n * per_row >= w)
    if cs not in FILL_CLUSTERS:
        raise ValueError(f"exact_fill: {cs} CTAs a row")
    per_cta = -(-w // cs)
    threads = -(-(-(-per_cta // FILL_LANES)) // 32) * 32
    lc = threads * FILL_LANES
    if threads > FILL_THREADS or (cs - 1) * lc >= w:
        raise ValueError(f"exact_fill: {cs} CTAs a row cannot hold band "
                         f"{w}")
    return FillGeometry(cs, threads, lc, 32 * FILL_LANES)


def codes_bytes(length: int, bandwidth: int) -> int:
    """Bytes of kernel F's packed codes for one row of `length`
    positions: ceil(length / 16) words of 16 two-bit codes a lane."""
    return -(-length // 16) * bandwidth * 4


def rows_within(budget: int, length: int, bandwidth: int) -> int:
    """How many rows of `length` positions at `bandwidth` lanes kernel
    F's codes hold within `budget` bytes; raises ValueError when not one
    row does. On a CUDA device every exact-band block runs on kernels F
    and G: device memory, not lanes, bounds the band."""
    need = codes_bytes(length, bandwidth)
    if need > budget:
        raise ValueError(
            f"band {bandwidth}: one row of {length} positions needs "
            f"{need:,} bytes of kernel F's codes, past the device memory "
            f"budget of {budget:,} bytes (RR_DEVICE_HBM_BUDGET, "
            "models/realigner.py::device_memory_budget)")
    return budget // need


def plane_columns(cp: int, geo: FillGeometry) -> int:
    """Columns a row of kernel F's cost planes holds (column y at index
    y + 4): every staged window of a band whose ways lie below cp."""
    return (cp + geo.cs * geo.lanes_cta + FILL_SLACK + 16 + 3) // 4 * 4


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """uint8 codes [B, L, W] -> int32 [ceil(L/16), B, W], 16 two-bit
    codes a word, position x at bits 2*(x % 16), zeros past L."""
    b, l, w = codes.shape
    nw = -(-l // 16)
    c = codes.permute(1, 0, 2)
    if nw * 16 != l:
        c = torch.nn.functional.pad(c, (0, 0, 0, 0, 0, nw * 16 - l))
    c = c.reshape(nw, 16, b, w)
    packed = torch.zeros((nw, b, w), dtype=torch.int32, device=codes.device)
    for k in range(16):
        packed |= c[:, k].to(torch.int32) << (2 * k)
    return packed


def exact_fill_plain(counts, rows_old, seqs, ways, lengths, ncols: int, *,
                     bandwidth: int):
    """Kernel F's plain version: the torch exact band, codes packed."""
    codes, band, anf = br.banded_fill(counts, rows_old, seqs, ways, lengths,
                                      ncols, bandwidth=bandwidth)
    return pack_codes(codes), band, anf


def exact_fill(counts, rows_old, seqs, ways, lengths, ncols: int, *,
               bandwidth: int, ctas: int | None = None,
               wide: bool | None = None):
    """Exact-band fill of a block. counts int32 [C, 6]; rows_old int8
    [B, C] (columns >= ncols: symbol 5, zero counts); seqs int8 [B, L]
    (bases 0-3); ways int32 [B, L] (each base's column below C,
    edge-padded past the row's length); lengths int32 [B], all on one
    device. `ctas` and `wide` are fill_geometry's test hooks for kernel
    F's layout (the same result at any layout); the program leaves them
    at None."""
    dev = rows_old.device
    _check("rows_old", rows_old, torch.int8, 2, dev)
    b, c = rows_old.shape
    _check("counts", counts, torch.int32, 2, dev)
    _check("seqs", seqs, torch.int8, 2, dev)
    _check("ways", ways, torch.int32, 2, dev)
    _check("lengths", lengths, torch.int32, 1, dev)
    l = seqs.shape[1]
    if counts.shape != (c, 6) or ways.shape != (b, l) \
            or seqs.shape[0] != b or lengths.shape != (b,) or l < 1:
        raise ValueError("exact_fill: inconsistent shapes "
                         f"counts {tuple(counts.shape)} rows {(b, c)} "
                         f"seqs {tuple(seqs.shape)} ways {tuple(ways.shape)}"
                         f" lengths {tuple(lengths.shape)}")
    if bandwidth <= 0 or not 0 < ncols <= c:
        raise ValueError(f"exact_fill: unsupported band {bandwidth} or "
                         f"ncols {ncols}")
    if dev.type == "cpu":
        return exact_fill_plain(counts, rows_old, seqs, ways, lengths,
                                ncols, bandwidth=bandwidth)
    if dev.type != "cuda":
        raise ValueError(f"exact_fill: unsupported device {dev}")
    geo = fill_geometry(bandwidth, ctas, wide)
    lib = _build.load("exact_fill")
    codes = torch.empty((-(-l // 16), b, bandwidth), dtype=torch.int32,
                        device=dev)
    band = torch.empty((b, bandwidth), dtype=torch.int32, device=dev)
    anf = torch.empty((b,), dtype=torch.int32, device=dev)
    # the kernel's scratch: each row's six cost planes
    cps = plane_columns(c, geo)
    planes = torch.empty((b, 6, cps), dtype=torch.int32, device=dev)
    # the wide layout's band of x-1 and of x, a row
    wband = torch.empty((b, 2, bandwidth) if geo.groups else (0,),
                        dtype=torch.int32, device=dev)
    p = _build.ptr
    ev = _build.launch_events("exact_fill")
    if ev:
        ev[0].record()
    err = lib.exact_fill_launch(
        p(counts), p(rows_old), p(seqs), p(ways), p(lengths), p(planes),
        p(codes), p(band), p(anf), b, c, l, int(ncols), bandwidth, geo.cs,
        geo.threads, cps, p(wband), geo.groups, _build.stream_ptr(dev))
    if ev:
        ev[1].record()
    _build.check(lib, "exact_fill", err)
    exact_fill.launches += 1
    return codes, band, anf


exact_fill.launches = 0


def exact_walk_plain(codes, final_band, final_anf, entry_bound, anf_full,
                     lengths, ncols: int, *, cpad: int):
    """Kernel G's plain version: banded_realign.entry_scan, then the
    walk in torch ops, one position a step. Returns (moves int32
    [NW, B, 16], wayin int32 [B], best int32 [B])."""
    nw, b, w = codes.shape
    dev = codes.device
    l = anf_full.shape[1]
    wayin, best = br.entry_scan(final_band, final_anf, entry_bound, ncols,
                                cpad=cpad, bandwidth=w)
    lane = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    moves = torch.empty((nw, b, 16), dtype=torch.int32, device=dev)
    y = wayin.clone()
    for x in range(nw * 16 - 1, -1, -1):
        active = (x < lengths) & (y > -1)
        a = anf_full[:, min(x, l - 1)]
        j = y - a
        code = (codes[x >> 4] >> (2 * (x & 15))) & 3
        cand = (code != 0) & (lane <= j[:, None]) & active[:, None]
        pm = torch.where(cand, (lane << 2) | code, -1).max(dim=1).values
        found, y_at, mv = pm >= 0, a + (pm >> 2), pm & 3
        # below the band: the lockstep walk reads lane 0 at column y
        below = j < 0
        found = torch.where(below, code[:, 0] != 0, found)
        y_at = torch.where(below, y, y_at)
        mv = torch.where(below, code[:, 0], mv)
        moves[x >> 4, :, x & 15] = torch.where(
            active & found, (y_at << 2) | mv, -1)
        y = torch.where(active,
                        torch.where(found,
                                    torch.where(mv == 2, y_at, y_at - 1),
                                    -1),
                        y)
    return moves, wayin, best


def exact_walk(codes, final_band, final_anf, entry_bound, anf_full,
               lengths, ncols: int, *, cpad: int):
    """The entry scan and the walk: kernel G for CUDA tensors,
    `exact_walk_plain` for CPU ones. codes int32 [NW, B, W] from
    exact_fill; final_band int32 [B, W]; final_anf, entry_bound, lengths
    int32 [B]; anf_full int32 [B, L] (the band start of every position,
    max(0, way - W//2)), NW = ceil(L/16)."""
    dev = codes.device
    _check("codes", codes, torch.int32, 3, dev)
    _check("final_band", final_band, torch.int32, 2, dev)
    _check("final_anf", final_anf, torch.int32, 1, dev)
    _check("entry_bound", entry_bound, torch.int32, 1, dev)
    _check("anf_full", anf_full, torch.int32, 2, dev)
    _check("lengths", lengths, torch.int32, 1, dev)
    nw, b, w = codes.shape
    l = anf_full.shape[1]
    if final_band.shape != (b, w) or final_anf.shape != (b,) \
            or entry_bound.shape != (b,) or lengths.shape != (b,) \
            or anf_full.shape[0] != b or nw != -(-l // 16):
        raise ValueError("exact_walk: inconsistent shapes codes "
                         f"{tuple(codes.shape)} band "
                         f"{tuple(final_band.shape)} anf_full "
                         f"{tuple(anf_full.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    if not 0 < ncols <= cpad:
        raise ValueError(f"exact_walk: ncols {ncols}, cpad {cpad}")
    if dev.type == "cpu":
        return exact_walk_plain(codes, final_band, final_anf, entry_bound,
                                anf_full, lengths, ncols, cpad=cpad)
    if dev.type != "cuda":
        raise ValueError(f"exact_walk: unsupported device {dev}")
    lib = _build.load("exact_walk")
    moves = torch.empty((nw, b, 16), dtype=torch.int32, device=dev)
    wayin = torch.empty((b,), dtype=torch.int32, device=dev)
    best = torch.empty((b,), dtype=torch.int32, device=dev)
    p = _build.ptr
    ev = _build.launch_events("exact_walk")
    if ev:
        ev[0].record()
    err = lib.exact_walk_launch(
        p(codes), p(final_band), p(final_anf), p(entry_bound), p(anf_full),
        p(lengths), p(moves), p(wayin), p(best), b, w, nw, l, int(ncols),
        int(cpad), _build.stream_ptr(dev))
    if ev:
        ev[1].record()
    _build.check(lib, "exact_walk", err)
    exact_walk.launches += 1
    return moves, wayin, best


exact_walk.launches = 0


def _insert_counts(moves, lengths):
    """Inserts a row in the move records: int32 [B]."""
    nw, b, _ = moves.shape
    m = moves.permute(1, 0, 2).reshape(b, nw * 16)
    xs = torch.arange(nw * 16, dtype=torch.int32, device=moves.device)
    ins = (xs[None, :] < lengths[:, None]) & (m >= 0) & ((m & 3) == 2)
    return ins.sum(dim=1, dtype=torch.int32)


def entry_and_backtrack(codes, final_band, final_anf, seqs, anf_full,
                        entry_bound, lengths, ncols: int, *, cpad: int,
                        ins_cap: int | None = None):
    """The walk over exact_fill's codes, then the rows and insert lists:
    (new_rows int8 [B, cpad], best int32 [B], ins_y int32 [B, K],
    ins_base int8 [B, K], ins_n int32 [B]) with K the largest insert
    count of the block, at least MAX_INSERTS (one host read), or
    `ins_cap` from a caller that knows a bound (no host read): a row
    inserts at most its bases."""
    moves, _wayin, best = exact_walk(codes, final_band, final_anf,
                                     entry_bound, anf_full, lengths, ncols,
                                     cpad=cpad)
    nw, b, _ = moves.shape
    if nw * 16 != seqs.shape[1]:
        seqs = torch.nn.functional.pad(seqs, (0, nw * 16 - seqs.shape[1]))
    if ins_cap is None:
        with trace.span("exact.wait"):
            most = int(_insert_counts(moves, lengths).max()) if b else 0
        ins_cap = max(br.MAX_INSERTS, most)
    return moves_to_outputs(moves, seqs, lengths, best, cpad=cpad,
                            ins_cap=ins_cap)
