"""Kernel E's wrapper: one tile pair of the MaxCorrs device scan.

`maxcorr_tile` launches csrc/maxcorr_tile.cu on CUDA tensors: the masks,
the coverage break, the float32 significance and the per-group maxima
of one tile pair after its four int8 products, in one launch. It takes
ops/maxcorr_tile.tile_pass_plain's arguments (defined there) and gives
the same result; CPU tensors go to that plain version
(models/maxcorr.MaxCorrScan.tile_step routes them), never here.
`maxcorr_tile.launches` counts launches.
"""
from __future__ import annotations

import torch

from . import _build


def _check(name, x, dtype, shape, dev):
    if not isinstance(x, torch.Tensor) or x.dtype != dtype \
            or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"maxcorr_tile: {name} must be a contiguous "
                         f"{dtype} {list(shape)} tensor")
    if x.device != dev:
        raise ValueError(f"maxcorr_tile: {name} is on {x.device}, "
                         f"expected {dev}")


def maxcorr_tile(shared, schnitt, gr1, gr2, alive, alive_next, seed_ok,
                 partner_ok, sizes, lf, acc, i0, j0, *, gap, ncols, mincov):
    """Kernel E (arguments: ops/maxcorr_tile.py). Updates acc and writes
    alive_next on the tensors' CUDA device; returns None."""
    dev = acc.device
    if dev.type != "cuda":
        raise ValueError(f"maxcorr_tile: CUDA tensors only, got {dev}")
    t = shared.shape[0]
    t5 = 5 * t
    cp5 = acc.shape[0]
    _check("shared", shared, torch.int32, (t, t), dev)
    _check("schnitt", schnitt, torch.int32, (t5, t5), dev)
    _check("gr1", gr1, torch.int32, (t5, t), dev)
    _check("gr2", gr2, torch.int32, (t, t5), dev)
    _check("alive", alive, torch.bool, (t,), dev)
    _check("alive_next", alive_next, torch.bool, (t,), dev)
    _check("seed_ok", seed_ok, torch.bool, (cp5 // 5, 5), dev)
    _check("partner_ok", partner_ok, torch.bool, (cp5 // 5, 5), dev)
    _check("sizes", sizes, torch.int32, (cp5,), dev)
    _check("acc", acc, torch.float32, (cp5,), dev)
    _check("lf", lf, torch.float32, (lf.shape[0], 2), dev)
    if cp5 % 5 or not (0 <= i0 and i0 + t <= cp5 // 5
                       and 0 <= j0 and j0 + t <= cp5 // 5):
        raise ValueError(f"maxcorr_tile: tiles at {i0}, {j0} of {t} "
                         f"columns do not lie in {cp5 // 5} columns")
    if alive.data_ptr() == alive_next.data_ptr():      # both __restrict__
        raise ValueError("maxcorr_tile: alive_next must not be alive")
    lib = _build.load("maxcorr_tile")
    p = _build.ptr
    ev = _build.launch_events("maxcorr_tile")
    if ev:
        ev[0].record()
    err = lib.maxcorr_tile_launch(
        p(shared), p(schnitt), p(gr1), p(gr2), p(alive), p(alive_next),
        p(seed_ok), p(partner_ok), p(sizes), p(lf), p(acc), t, int(i0),
        int(j0), int(gap), int(ncols), int(mincov), lf.shape[0] - 1,
        _build.stream_ptr(dev))
    if ev:
        ev[1].record()
    _build.check(lib, "maxcorr_tile", err)
    maxcorr_tile.launches += 1


maxcorr_tile.launches = 0
