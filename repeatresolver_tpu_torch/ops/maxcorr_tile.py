"""A group of tile pairs of the MaxCorrs device scan, after its product.

Counterpart of the JAX package's `tile_step`
(repeatresolver_tpu/models/maxcorr.py:303-343) and its significance
(ops/hypergeom_device.py:81-159), from the products on, for one seed
tile and m partner tiles in a row: seed columns i0 + i (t columns, t5 =
5t groups, group 5i + k of column i holding symbol k) and partner
columns j0 + c, c < m*t, given the one product

  schnitt int32 [t5, m*t5]  rows in seed group 5i + k and in partner
                            group 5c + kk

Every other count of the JAX package's four products is a sum of it,
exactly: coverage is the sum of the five one-hot groups (an MSA code is
0-4, a symbol or gap, or >= 5, uncovered; MaxCorrScan rejects negative
codes), so (`derived_counts`)

  gr1[5i+k, c]  = sum_kk schnitt[5i+k, 5c+kk]   rows in group 5i + k
                                                covering column c
  gr2[i, 5c+kk] = sum_k  schnitt[5i+k, 5c+kk]   rows covering column i
                                                in group 5c + kk
  shared[i, c]  = sum_k sum_kk schnitt[...]     rows covering both

From them it computes, as the reference's threaded scan
(MaxCorrelation.c:804-823) does along a seed's row of partner columns:
`valid` pairs (j0 + c >= i0 + i + gap, j0 + c inside the MSA), `fail`
where their shared coverage is below mincov, the cut at each seed's
first fail across the m tiles in order (`cumfail`), the pairs `allowed`
for seeds still alive, the seeds alive after each tile, the Z of every
allowed pair of a seed group and a partner group that pass their size
gates, and the per-group maxima of Z into both sides of the accumulator.
That is the chain of the m tile steps, pair for pair.

`group_pass_plain` is the plain version, in torch ops on any device. It
takes Z only for the allowed pairs, with the per-pair stop rule
(hypergeom_device.positive_significance_f32_each): the same bits as the
JAX package's arithmetic on the whole tile. Kernel E (csrc/maxcorr_tile.cu,
ops/cuda_maxcorr.py) computes the same on the card;
`models/maxcorr.MaxCorrScan.group_step` sends CUDA tensors there and CPU
tensors here. `group_pass_plain.calls` counts its runs.

Shared arguments of both versions: alive bool [t] (seeds not yet cut),
alive_out bool [m, t] (written: row q holds the seeds alive after tile
q), seed_ok and partner_ok bool [Cp, 5], sizes int32 [Cp*5], acc float32
[Cp*5] (maxima, updated in place, all entries >= 0), lf float32
[nmax + 1, 2] (log_factorial_table's hi and lo side by side, nmax >=
every count), ints i0, j0, gap, ncols, mincov.
"""
from __future__ import annotations

import torch

from .hypergeom_device import positive_significance_f32_each


def derived_counts(schnitt):
    """(shared [t, m*t], gr1 [t, 5, m*t], gr2 [t, m*t, 5]), int32, from
    the group's product schnitt [5t, m*5t] (module docstring)."""
    t5, w5 = schnitt.shape
    blk = schnitt.view(t5 // 5, 5, w5 // 5, 5)
    gr1 = blk.sum(dim=3, dtype=torch.int32)
    gr2 = blk.sum(dim=1, dtype=torch.int32)
    return gr2.sum(dim=2, dtype=torch.int32), gr1, gr2


def group_pass_plain(schnitt, alive, alive_out, seed_ok, partner_ok, sizes,
                     lf, acc, i0, j0, *, gap, ncols, mincov,
                     with_steps=False):
    """The group pass in torch ops (module docstring). with_steps:
    return (allowed (group, group) pairs, relevant pairs, tail steps
    summed), the work kernel E does for these inputs; else None."""
    t, m = alive.shape[0], alive_out.shape[0]
    nc = m * t
    shared, gr1, gr2 = derived_counts(schnitt)
    dev = schnitt.device
    ii = i0 + torch.arange(t, device=dev)[:, None]
    jj = j0 + torch.arange(nc, device=dev)[None, :]
    valid = (jj >= ii + gap) & (jj < ncols)
    fail = valid & (shared < mincov)
    cumfail = torch.cumsum(fail.to(torch.int32), dim=1) > 0
    allowed = valid & alive[:, None] & ~cumfail
    alive_out.copy_((alive[:, None] & ~cumfail[:, t - 1::t]).t())
    group_pass_plain.calls += 1
    pair_ok = (allowed[:, None, :, None]
               & seed_ok[i0:i0 + t][:, :, None, None]
               & partner_ok[j0:j0 + nc][None, None, :, :])
    pi, pk, pc, pkk = pair_ok.nonzero(as_tuple=True)
    i5, c5 = pi * 5 + pk, pc * 5 + pkk
    z, steps = positive_significance_f32_each(
        schnitt[i5, c5], gr1[pi, pk, pc], gr2[pi, pc, pkk], shared[pi, pc],
        sizes[i0 * 5 + i5], sizes[j0 * 5 + c5], lf[:, 0], lf[:, 1],
        with_steps=True)
    # acc >= 0 throughout, so the zeros of the JAX package's masked tile
    # never win a maximum and the allowed pairs alone decide it
    acc.scatter_reduce_(0, i0 * 5 + i5, z, "amax")
    acc.scatter_reduce_(0, j0 * 5 + c5, z, "amax")
    if not with_steps:
        return None
    return int(pi.numel()), int((steps > 0).sum()), int(steps.sum())


group_pass_plain.calls = 0
