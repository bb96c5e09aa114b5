"""Kernel E's wrapper: a group of tile pairs of the MaxCorrs device scan.

`maxcorr_group` launches csrc/maxcorr_tile.cu on CUDA tensors: the
derived counts, the coverage break across the group, the float32
significance and the per-group maxima of one seed tile and m partner
tiles after their one int8 product. It takes
ops/maxcorr_tile.group_pass_plain's arguments (defined there) and gives
the same result; CPU tensors go to that plain version
(models/maxcorr.MaxCorrScan.group_step routes them), never here.
`maxcorr_group.launches` counts its calls, one a group (each call runs
the kernel's two passes), and `maxcorr_group.tiles` the partner tiles of
those groups.
"""
from __future__ import annotations

import torch

from . import _build

# partner columns a CTA of either pass takes (csrc/maxcorr_tile.cu)
CHUNK = 256


def _check(name, x, dtype, shape, dev):
    if not isinstance(x, torch.Tensor) or x.dtype != dtype \
            or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"maxcorr_group: {name} must be a contiguous "
                         f"{dtype} {list(shape)} tensor")
    if x.device != dev:
        raise ValueError(f"maxcorr_group: {name} is on {x.device}, "
                         f"expected {dev}")


def maxcorr_group(schnitt, alive, alive_out, seed_ok, partner_ok, sizes, lf,
                  acc, i0, j0, *, gap, ncols, mincov):
    """Kernel E (arguments: ops/maxcorr_tile.py). Updates acc and writes
    alive_out on the tensors' CUDA device; returns None."""
    dev = acc.device
    if dev.type != "cuda":
        raise ValueError(f"maxcorr_group: CUDA tensors only, got {dev}")
    t, m = alive.shape[0], alive_out.shape[0]
    cp5 = acc.shape[0]
    _check("schnitt", schnitt, torch.int32, (5 * t, 5 * m * t), dev)
    _check("alive", alive, torch.bool, (t,), dev)
    _check("alive_out", alive_out, torch.bool, (m, t), dev)
    _check("seed_ok", seed_ok, torch.bool, (cp5 // 5, 5), dev)
    _check("partner_ok", partner_ok, torch.bool, (cp5 // 5, 5), dev)
    _check("sizes", sizes, torch.int32, (cp5,), dev)
    _check("acc", acc, torch.float32, (cp5,), dev)
    _check("lf", lf, torch.float32, (lf.shape[0], 2), dev)
    if cp5 % 5 or not (0 <= i0 and i0 + t <= cp5 // 5
                       and 0 <= j0 and j0 + m * t <= cp5 // 5):
        raise ValueError(f"maxcorr_group: tiles at {i0}, {j0} ({m} of {t} "
                         f"columns) do not lie in {cp5 // 5} columns")
    a0 = alive.data_ptr()
    o0 = alive_out.data_ptr()
    if o0 <= a0 < o0 + m * t:                          # both __restrict__
        raise ValueError("maxcorr_group: alive must not lie in alive_out")
    nchunks = -(-m * t // CHUNK)
    fails = alive.new_empty((t, nchunks), dtype=torch.int32)
    lib = _build.load("maxcorr_tile")
    p = _build.ptr
    ev = _build.launch_events("maxcorr_tile")
    if ev:
        ev[0].record()
    err = lib.maxcorr_tile_launch(
        p(schnitt), p(alive), p(alive_out), p(seed_ok), p(partner_ok),
        p(sizes), p(lf), p(acc), p(fails), t, m, int(i0), int(j0), int(gap),
        int(ncols), int(mincov), lf.shape[0] - 1, _build.stream_ptr(dev))
    if ev:
        ev[1].record()
    _build.check(lib, "maxcorr_tile", err)
    maxcorr_group.launches += 1
    maxcorr_group.tiles += m


maxcorr_group.launches = maxcorr_group.tiles = 0
