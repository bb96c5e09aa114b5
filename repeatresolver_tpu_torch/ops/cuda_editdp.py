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

Packed codes, int32 [B, nseg, steps, T, 2]: the layout of
csrc/editdp_layout.cuh. The target's columns are words of 32; a segment
holds T <= 1,024 words, one a thread; the pair [b, seg, s, k] holds word
seg*T + k at DP row x = s - k as two bit planes, [..., 0] the low bit of
each column's code and [..., 1] the high bit. `layout` sizes it and
`packed_rows` gives each pair's row; nothing else in Python restates it.

Kernel C compares symbols through a table of at most MAX_SYMBOLS dense
codes: `symbol_codes` maps the int16 symbols of queries and targets to
them on their device, a query code equal to a target code exactly where
the symbols are equal (100 equals 100; 100 and 200 equal no base), and
raises when the targets hold more distinct symbols than the table.
"""
from __future__ import annotations

import torch

from . import _build

WORD = 32              # target columns of a packed word, one a thread
MAX_THREADS = 1024     # words of a segment
MAX_SYMBOLS = 8        # rows of kernel C's symbol table: the targets'
#                        distinct symbols and one for every other symbol
_MODES = {None: 0, "int8": 1, "packed": 2}


def layout(lq: int, lt: int) -> tuple[int, int, int]:
    """(threads a segment, segments, steps) of a fill of Lq rows over Lt
    columns: as few segments as 1,024 threads allow, as few threads as
    the segments need."""
    words = -(-lt // WORD)
    nseg = -(-words // MAX_THREADS)
    threads = -(-(-(-words // nseg)) // 32) * 32
    return threads, nseg, lq + threads - 1


def packed_rows(lq: int, lt: int, device=None) -> torch.Tensor:
    """The DP row x = s - k of each packed pair [steps, T] of a fill of
    Lq rows over Lt columns (a pair holds a row only where 0 <= x < Lq)."""
    threads, _, steps = layout(lq, lt)
    return (torch.arange(steps, device=device)[:, None]
            - torch.arange(threads, device=device)[None, :])


def packed_bytes_per_row(lq: int, lt: int) -> int:
    """Device bytes of one batch row's packed codes."""
    threads, nseg, steps = layout(lq, lt)
    return 8 * nseg * steps * threads


def _target_symbols(targets):
    """int32 [65,536]: 1 at each int16 value the targets hold."""
    present = targets.new_zeros(1 << 16, dtype=torch.int32)
    present[targets.reshape(-1).long() + 32768] = 1
    return present


def _check_nsym(n):
    if n > MAX_SYMBOLS:
        raise ValueError(f"editdp_fill: {n - 1} distinct target symbols, "
                         f"kernel C compares at most {MAX_SYMBOLS - 1}")


def _codes(present, queries, targets):
    """(query codes, target codes, n) from _target_symbols, without a
    device-to-host copy: the target symbols ranked 0..n-2 by value, every
    other symbol n-1, codes clamped into the table (n, a 0-d device
    tensor, says whether they had to be)."""
    n = present.sum() + 1
    table = torch.where(present > 0,
                        torch.cumsum(present, 0, dtype=torch.int32) - 1,
                        n - 1).clamp_(max=MAX_SYMBOLS - 1).to(torch.uint8)

    def codes(t):
        idx = t.reshape(-1).to(torch.int32).add_(32768)
        return table.index_select(0, idx).view(t.shape)
    return codes(queries), codes(targets), n


def symbol_codes(queries, targets):
    """(query codes uint8 [B, Lq], target codes uint8 [Bt, Lt], n): the
    int16 symbols as the dense codes of kernel C's table, torch ops on
    the tensors' device. The targets' distinct symbols get 0..n-2, every
    query symbol that no target holds gets n-1, so a query and a target
    code are equal exactly where their symbols are. Raises when n passes
    MAX_SYMBOLS."""
    qc, tc, n = _codes(_target_symbols(targets), queries, targets)
    n = int(n)
    _check_nsym(n)
    return qc, tc, n


def _check_symbols(name, t, ndim, dev):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != torch.int16 or t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d torch.int16 symbols, "
                         f"got {t.dim()}-d {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")


def _check_qlens(qlens, b, dev):
    if not isinstance(qlens, torch.Tensor) or qlens.dtype != torch.int32 \
            or qlens.shape != (b,) or not qlens.is_contiguous():
        raise ValueError(f"qlens must be a contiguous int32 [{b}] tensor")
    if qlens.device != dev:
        raise ValueError(f"qlens is on {qlens.device}, expected {dev}")


def _check_after_launch(name, qlens, lq, n=None):
    """The checks that read the device, after the launch, so that the
    card does not idle while the host reads: qlens in [0, Lq] and, for
    the fill, its symbol count n (a 0-d tensor). The kernels clamp what
    these reject, so an input they reject corrupts nothing before the
    raise."""
    vals = [qlens.min().long(), qlens.max().long()]
    if n is not None:
        vals.append(n.long())
    host = torch.stack(vals).tolist()
    if host[0] < 0 or host[1] > lq:
        raise ValueError(f"{name}: qlens must lie in [0, {lq}]")
    if n is not None:
        _check_nsym(host[2])


def editdp_fill(queries, qlens, targets, *, codes: str | None = None):
    """Kernel C. queries int16 [B, Lq], qlens int32 [B] in [0, Lq],
    targets int16 [B, Lt] or [Lt] (shared), all on one CUDA device; any
    strides; at most MAX_SYMBOLS - 1 distinct target symbols. Returns
    (final rows int32 [B, Lt], codes): codes None, int8 [Lq, B, Lt] for
    codes="int8" (every row, past qlen included), or the packed int32
    [B, nseg, steps, T, 2] for codes="packed"."""
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"editdp_fill: CUDA tensors only, got {dev}")
    if codes not in _MODES:
        raise ValueError(f"editdp_fill: unknown codes {codes!r}")
    _check_symbols("queries", queries, 2, dev)
    b, lq = queries.shape
    shared = targets.dim() == 1
    if shared:
        targets = targets[None, :]
    _check_symbols("targets", targets, 2, dev)
    lt = targets.shape[1]
    if shared or (targets.shape[0] == b and targets.stride(0) == 0):
        targets = targets[:1]                   # one row for the batch
    elif targets.shape[0] != b:
        raise ValueError(f"editdp_fill: targets {tuple(targets.shape)} for "
                         f"{b} queries")
    if lt < 1 or lq >= 1 << 26:
        raise ValueError(f"editdp_fill: unsupported Lq {lq} or Lt {lt}")
    _check_qlens(qlens, b, dev)
    threads, nseg, steps = layout(lq, lt)
    fr = queries.new_zeros((b, lt), dtype=torch.int32)
    out8 = queries.new_empty((lq, b, lt), dtype=torch.int8) \
        if codes == "int8" else None
    out2 = queries.new_empty((b, nseg, steps, threads, 2),
                             dtype=torch.int32) if codes == "packed" else None
    if b == 0:
        return fr, out8 if codes == "int8" else out2
    qc, tc, nsym = _codes(_target_symbols(targets), queries, targets)
    # the carry between segments, ping-ponged by segment parity
    bcol = queries.new_empty((2, b, lq), dtype=torch.uint8) if nseg > 1 \
        else None
    # several batch rows a CTA where a row has few words
    rows_per_cta = max(1, 256 // threads) if nseg == 1 else 1
    lib = _build.load("editdp_fill")

    def p(t):
        return None if t is None else _build.ptr(t)
    ev = _build.launch_events("editdp_fill")
    if ev:
        ev[0].record()
    err = lib.editdp_fill_launch(
        p(qc), p(qlens), p(tc), 0 if tc.shape[0] == 1 else lt, b, lq, lt,
        _MODES[codes], threads, rows_per_cta, nseg, steps, MAX_SYMBOLS,
        p(out8), p(out2), p(fr), p(bcol), _build.stream_ptr(dev))
    if ev:
        ev[1].record()
    _build.check(lib, "editdp_fill", err)
    editdp_fill.launches += 1
    _check_after_launch("editdp_fill", qlens, lq, nsym)
    return fr, out8 if codes == "int8" else out2


editdp_fill.launches = 0


def editdp_walk(codes, qlens, fr, *, walked=None):
    """Kernel D over kernel C's packed codes int32 [B, nseg, steps, T, 2];
    qlens int32 [B], fr int32 [B, Lt] (Lt >= 2) from the same fill.
    Returns alignments int32 [B, Lq]: the target column of each query
    base, or -1. walked, an int32 [B] tensor, receives each row's walk
    steps."""
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"editdp_walk: CUDA tensors only, got {dev}")
    if codes.dtype != torch.int32 or codes.dim() != 5 \
            or codes.shape[4] != 2 or not codes.is_contiguous():
        raise ValueError("editdp_walk: codes must be kernel C's packed "
                         "int32 [B, nseg, steps, T, 2]")
    b, nseg, steps, threads, _ = codes.shape
    if fr.dtype != torch.int32 or fr.dim() != 2 or fr.shape[0] != b \
            or not fr.is_contiguous() or fr.device != dev:
        raise ValueError(f"editdp_walk: fr must be a contiguous int32 "
                         f"[{b}, Lt] tensor on {dev}")
    lt = fr.shape[1]
    lq = steps - threads + 1
    if lt < 2 or layout(lq, lt) != (threads, nseg, steps):
        raise ValueError(f"editdp_walk: codes {tuple(codes.shape)} are not "
                         f"the packed layout of {lt} columns")
    _check_qlens(qlens, b, dev)
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
    _check_after_launch("editdp_walk", qlens, lq)
    return out


editdp_walk.launches = 0


def pack_codes(codes8):
    """The packed layout of int8 codes [Lq, B, Lt] (torch ops, any
    device, a batch row at a time): kernel C's packed output for the same
    fill, with every row x < Lq filled. Pairs of no row, and the bits of
    columns past Lt, hold 0."""
    lq, b, lt = codes8.shape
    dev = codes8.device
    threads, nseg, steps = layout(lq, lt)
    x = packed_rows(lq, lt, dev)
    has_row = (x >= 0) & (x < lq)
    rows = x[has_row]
    ks = torch.arange(threads, device=dev).expand(steps, -1)[has_row]
    shifts = torch.arange(WORD, dtype=torch.int64, device=dev)
    out = torch.zeros((b, nseg, steps, threads, 2), dtype=torch.int32,
                      device=dev)
    for r in range(b):
        c = torch.zeros((lq, nseg * threads * WORD), dtype=torch.int64,
                        device=dev)
        c[:, :lt] = codes8[:, r]
        c = c.view(lq, nseg, threads, WORD)
        # the two planes, as int32 bit patterns
        planes = torch.stack([((c >> bit & 1) << shifts).sum(dim=-1)
                              for bit in (0, 1)], dim=-1)
        planes = torch.where(planes >= 1 << 31, planes - (1 << 32),
                             planes).to(torch.int32)   # [Lq, nseg, T, 2]
        out[r][:, has_row] = planes[rows, :, ks].transpose(0, 1)
    return out
