"""Kernel A's wrapper: the staircase fill.

Counterpart of repeatresolver_tpu/ops/pallas_realign.py. For CUDA
tensors it launches csrc/staircase_fill.cu; for CPU tensors it runs the
plain version (ops/staircase_realign.staircase_fill). Both return the
same bits: codes int32 [Lpad/16, B, W2] (16 two-bit codes per word,
time-major), the final band int32 [B, W2] and the final window start
int32 [B].

`staircase_fill.launches` counts kernel launches (plain CPU runs are
not counted).
"""
from __future__ import annotations

import torch

from . import _build
from .staircase_realign import staircase_fill as staircase_fill_plain

# window lanes a row's two CTAs can hold: 512 threads of 4 lanes each
MAX_W2 = 4096


def _check(name, t, dtype, ndim, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d {dtype}, got "
                         f"{t.dim()}-d {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def staircase_fill(counts, rows_old, seqs, ways, lengths, ncols: int, *,
                   bandwidth: int, chunk: int, widen: int = 1):
    """Staircase DP fill of a block (see ops/staircase_realign.py for
    the contract). counts int32 [C, 6]; rows_old int8 [B, C]; seqs int8
    [B, L]; ways int32 [B, L]; lengths int32 [B], all on one device."""
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
        raise ValueError("staircase_fill: inconsistent shapes "
                         f"counts {tuple(counts.shape)} rows {(b, c)} "
                         f"seqs {tuple(seqs.shape)} ways "
                         f"{tuple(ways.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    w2 = bandwidth + widen * chunk
    if chunk % 16 or chunk < 16 or w2 > MAX_W2 or not 0 < ncols <= c:
        raise ValueError(f"staircase_fill: unsupported chunk {chunk}, "
                         f"window {w2} or ncols {ncols}")
    if dev.type == "cpu":
        return staircase_fill_plain(counts, rows_old, seqs, ways, lengths,
                                    ncols, bandwidth=bandwidth,
                                    chunk=chunk, widen=widen)
    if dev.type != "cuda":
        raise ValueError(f"staircase_fill: unsupported device {dev}")
    lib = _build.load("staircase_fill")
    nc = -(-l // chunk)
    codes = torch.empty((nc * chunk // 16, b, w2), dtype=torch.int32,
                        device=dev)
    band = torch.empty((b, w2), dtype=torch.int32, device=dev)
    # the kernel's scratch for the gap-cost prefix: one row per CTA
    gbuf = torch.empty((b * lib.staircase_fill_ctas_per_row(), c + 1),
                       dtype=torch.int32, device=dev)
    p = _build.ptr
    ev = _build.launch_events("staircase_fill")
    if ev:
        ev[0].record()
    err = lib.staircase_fill_launch(
        p(counts), p(rows_old), p(seqs), p(ways), p(lengths), p(gbuf),
        p(codes), p(band), b, c, l, int(ncols), bandwidth, chunk, w2,
        _build.stream_ptr(dev))
    if ev:
        ev[1].record()
    _build.check(lib, "staircase_fill", err)
    staircase_fill.launches += 1
    final_a = (ways[:, (nc - 1) * chunk] - bandwidth // 2).clamp(min=0)
    return codes, band, final_a.to(torch.int32)


staircase_fill.launches = 0
