"""Kernels C and D's wrappers: the edit-DP fill and walk of cut and align.

Counterparts of the XLA device code of repeatresolver_tpu/ops/editdp.py
(the row scans of last_rows and align_with_codes, the backtrack loop of
align_on_device), which has no Pallas kernel:

  * `editdp_fill` launches csrc/editdp_fill.cu (kernel C): the final DP
    rows, and, when asked, the move codes, a byte a code in the plain
    version's layout [Lq, B, Lt] or two bits a code in the packed layout
    below;
  * `editdp_walk` launches csrc/editdp_walk.cu (kernel D): the entry scan
    and the backtrack over the packed codes.

CUDA tensors only: ops/editdp.py sends CPU tensors to its plain loop
(forward_plain, walk_plain), which gives the same bits. Outputs are
allocated with `new_*` from the inputs. `editdp_fill.launches` and
`editdp_walk.launches` count kernel launches.

Packed codes, int32 [B, nseg, steps, T]: the layout of
csrc/editdp_layout.cuh (a strip of 16 target columns a thread, T <= 512
threads a segment, the word [b, seg, s, k] holding strip seg*T + k at DP
row x = s - k). `layout` sizes it and `packed_rows` gives each word's
row; nothing else in Python restates it.
"""
from __future__ import annotations

import torch

from . import _build

STRIP = 16             # target columns a thread owns
MAX_THREADS = 512
_MODES = {None: 0, "int8": 1, "packed": 2}


def layout(lq: int, lt: int) -> tuple[int, int, int]:
    """(threads a CTA, segments, steps) of a fill of Lq rows over Lt
    columns: as few segments as 512 threads allow, as few threads as the
    segments need."""
    strips = -(-lt // STRIP)
    nseg = -(-strips // MAX_THREADS)
    threads = -(-(-(-strips // nseg)) // 32) * 32
    return threads, nseg, lq + threads - 1


def packed_rows(lq: int, lt: int, device=None) -> torch.Tensor:
    """The DP row x = s - k of each packed word [steps, T] of a fill of
    Lq rows over Lt columns (a word holds a row only where 0 <= x < Lq)."""
    threads, _, steps = layout(lq, lt)
    return (torch.arange(steps, device=device)[:, None]
            - torch.arange(threads, device=device)[None, :])


def packed_bytes_per_row(lq: int, lt: int) -> int:
    """Device bytes of one batch row's packed codes."""
    threads, nseg, steps = layout(lq, lt)
    return 4 * nseg * steps * threads


def _check_symbols(name, t, ndim, dev):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != torch.int16 or t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d torch.int16 symbols, "
                         f"got {t.dim()}-d {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")


def _check_qlens(qlens, b, lq, dev):
    if not isinstance(qlens, torch.Tensor) or qlens.dtype != torch.int32 \
            or qlens.shape != (b,) or not qlens.is_contiguous():
        raise ValueError(f"qlens must be a contiguous int32 [{b}] tensor")
    if qlens.device != dev:
        raise ValueError(f"qlens is on {qlens.device}, expected {dev}")
    host = qlens.cpu()
    if b and (int(host.min()) < 0 or int(host.max()) > lq):
        raise ValueError(f"qlens must lie in [0, {lq}]")


def editdp_fill(queries, qlens, targets, *, codes: str | None = None):
    """Kernel C. queries int16 [B, Lq], qlens int32 [B] in [0, Lq],
    targets int16 [B, Lt] or [Lt] (shared), all on one CUDA device; any
    strides. Returns (final rows int32 [B, Lt], codes): codes None, int8
    [Lq, B, Lt] for codes="int8" (every row, past qlen included), or the
    packed int32 [B, nseg, steps, T] for codes="packed"."""
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"editdp_fill: CUDA tensors only, got {dev}")
    if codes not in _MODES:
        raise ValueError(f"editdp_fill: unknown codes {codes!r}")
    _check_symbols("queries", queries, 2, dev)
    b, lq = queries.shape
    if targets.dim() == 1:
        targets = targets[None, :].expand(b, -1)
    _check_symbols("targets", targets, 2, dev)
    lt = targets.shape[1]
    if targets.shape[0] != b or lt < 1:
        raise ValueError(f"editdp_fill: targets {tuple(targets.shape)} for "
                         f"{b} queries")
    _check_qlens(qlens, b, lq, dev)
    threads, nseg, steps = layout(lq, lt)
    fr = queries.new_zeros((b, lt), dtype=torch.int32)
    out8 = queries.new_empty((lq, b, lt), dtype=torch.int8) \
        if codes == "int8" else None
    out2 = queries.new_empty((b, nseg, steps, threads), dtype=torch.int32) \
        if codes == "packed" else None
    bcol = queries.new_empty((b, lq), dtype=torch.int32) if nseg > 1 \
        else None
    if b == 0:
        return fr, out8 if codes == "int8" else out2
    lib = _build.load("editdp_fill")

    def p(t):
        return None if t is None else _build.ptr(t)
    ev = _build.launch_events("editdp_fill")
    if ev:
        ev[0].record()
    err = lib.editdp_fill_launch(
        p(queries), queries.stride(0), queries.stride(1), p(qlens),
        p(targets), targets.stride(0), targets.stride(1), b, lq, lt,
        _MODES[codes], threads, nseg, steps, p(out8), p(out2), p(fr),
        p(bcol), _build.stream_ptr(dev))
    if ev:
        ev[1].record()
    _build.check(lib, "editdp_fill", err)
    editdp_fill.launches += 1
    return fr, out8 if codes == "int8" else out2


editdp_fill.launches = 0


def editdp_walk(codes, qlens, fr, *, walked=None):
    """Kernel D over kernel C's packed codes int32 [B, nseg, steps, T];
    qlens int32 [B], fr int32 [B, Lt] (Lt >= 2) from the same fill.
    Returns alignments int32 [B, Lq]: the target column of each query
    base, or -1. walked, an int32 [B] tensor, receives each row's walk
    steps."""
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"editdp_walk: CUDA tensors only, got {dev}")
    if codes.dtype != torch.int32 or codes.dim() != 4 \
            or not codes.is_contiguous():
        raise ValueError("editdp_walk: codes must be kernel C's packed "
                         "int32 [B, nseg, steps, T]")
    b, nseg, steps, threads = codes.shape
    if fr.dtype != torch.int32 or fr.dim() != 2 or fr.shape[0] != b \
            or not fr.is_contiguous() or fr.device != dev:
        raise ValueError(f"editdp_walk: fr must be a contiguous int32 "
                         f"[{b}, Lt] tensor on {dev}")
    lt = fr.shape[1]
    lq = steps - threads + 1
    if lt < 2 or layout(lq, lt) != (threads, nseg, steps):
        raise ValueError(f"editdp_walk: codes {tuple(codes.shape)} are not "
                         f"the packed layout of {lt} columns")
    _check_qlens(qlens, b, lq, dev)
    if walked is not None and (walked.dtype != torch.int32
                               or walked.shape != (b,)
                               or walked.device != dev
                               or not walked.is_contiguous()):
        raise ValueError(f"editdp_walk: walked must be int32 [{b}] on {dev}")
    out = fr.new_empty((b, lq))
    if b == 0:
        return out
    lib = _build.load("editdp_walk")
    ev = _build.launch_events("editdp_walk")
    if ev:
        ev[0].record()
    err = lib.editdp_walk_launch(
        _build.ptr(codes), _build.ptr(qlens), _build.ptr(fr), _build.ptr(out),
        None if walked is None else _build.ptr(walked), b, lq, lt, threads,
        nseg, steps, _build.stream_ptr(dev))
    if ev:
        ev[1].record()
    _build.check(lib, "editdp_walk", err)
    editdp_walk.launches += 1
    return out


editdp_walk.launches = 0


def pack_codes(codes8):
    """The packed layout of int8 codes [Lq, B, Lt] (torch ops, any
    device, a batch row at a time): kernel C's packed output for the same
    fill, with every row x < Lq filled. Words of no row, and the bits of
    columns past Lt, hold 0."""
    lq, b, lt = codes8.shape
    dev = codes8.device
    threads, nseg, steps = layout(lq, lt)
    x = packed_rows(lq, lt, dev)
    has_row = (x >= 0) & (x < lq)
    rows = x[has_row]
    ks = torch.arange(threads, device=dev).expand(steps, -1)[has_row]
    shifts = 2 * torch.arange(STRIP, dtype=torch.int32, device=dev)
    out = torch.zeros((b, nseg, steps, threads), dtype=torch.int32,
                      device=dev)
    for r in range(b):
        c = torch.zeros((lq, nseg * threads * STRIP), dtype=torch.int32,
                        device=dev)
        c[:, :lt] = codes8[:, r]
        words = (c.view(lq, nseg, threads, STRIP) << shifts).sum(
            dim=-1, dtype=torch.int32)                      # [Lq, nseg, T]
        out[r][:, has_row] = words[rows, :, ks].t()
    return out
