"""One tile pair of the MaxCorrs device scan, after its four products.

Counterpart of the JAX package's `tile_step`
(repeatresolver_tpu/models/maxcorr.py:303-343) and its significance
(ops/hypergeom_device.py:81-159), from the products on: seed columns
i0 + i and partner columns j0 + j of one tile each (t columns, t5 = 5t
groups, group i5 = 5i + k of column i holding symbol k), given

  shared  int32 [t, t]    rows covering both columns i and j
  schnitt int32 [t5, t5]  rows in group i5 and in group j5
  gr1     int32 [t5, t]   rows in group i5 covering column j
  gr2     int32 [t, t5]   rows covering column i in group j5

it computes, as the reference's threaded scan (MaxCorrelation.c:804-823)
does: `valid` pairs (jj >= ii + gap, jj inside the MSA), `fail` where
their shared coverage is below mincov, the cut at each seed's first
fail along its row (`cumfail`), the pairs `allowed` for seeds still
alive, the seeds alive after the tile, the Z of every allowed pair of
a seed group and a partner group that pass their size gates, and the
per-group maxima of Z into both sides of the accumulator.

`tile_pass_plain` is the plain version, in torch ops on any device.
It indexes the four products directly (no [t5, t5] expansion of gr1,
gr2 and shared) and takes Z only for the allowed pairs, with the
per-pair stop rule (hypergeom_device.positive_significance_f32_each):
the same bits as the JAX package's arithmetic on the whole tile.
Kernel E (csrc/maxcorr_tile.cu, ops/cuda_maxcorr.py) computes the same
on the card; `models/maxcorr.MaxCorrScan.tile_step` sends CUDA tensors
there and CPU tensors here. `tile_pass_plain.calls` counts its runs.

Shared arguments of both versions: alive bool [t] (seeds not yet cut),
alive_next bool [t] (written), seed_ok and partner_ok bool [Cp, 5],
sizes int32 [Cp*5], acc float32 [Cp*5] (maxima, updated in place, all
entries >= 0), lf float32 [nmax + 1, 2] (log_factorial_table's hi and
lo side by side, nmax >= every count), ints i0, j0, gap, ncols, mincov.
"""
from __future__ import annotations

import torch

from .hypergeom_device import positive_significance_f32_each

# kernel E's threads a CTA: thread j % THREADS of seed column i's CTA
# takes the pairs of partner column j (csrc/maxcorr_tile.cu)
THREADS = 256


def tile_pass_plain(shared, schnitt, gr1, gr2, alive, alive_next, seed_ok,
                    partner_ok, sizes, lf, acc, i0, j0, *, gap, ncols,
                    mincov, with_steps=False):
    """The tile pass in torch ops (module docstring). with_steps: return
    (allowed (group, group) pairs, relevant pairs, tail steps summed,
    the same three counts for each of kernel E's threads as an int64
    [t, THREADS, 3] tensor), the work kernel E does for these inputs;
    else None."""
    t = shared.shape[0]
    iota = torch.arange(t, device=shared.device)
    ii = i0 + iota[:, None]
    jj = j0 + iota[None, :]
    valid = (jj >= ii + gap) & (jj < ncols)
    fail = valid & (shared < mincov)
    cumfail = torch.cumsum(fail.to(torch.int32), dim=1) > 0
    allowed = valid & alive[:, None] & ~cumfail
    alive_next.copy_(alive & ~cumfail[:, -1])
    tile_pass_plain.calls += 1
    pair_ok = (allowed[:, None, :, None]
               & seed_ok[i0:i0 + t][:, :, None, None]
               & partner_ok[j0:j0 + t][None, None, :, :])
    pi, pk, pj, pkk = pair_ok.nonzero(as_tuple=True)
    i5, j5 = pi * 5 + pk, pj * 5 + pkk
    z, steps = positive_significance_f32_each(
        schnitt[i5, j5], gr1[i5, pj], gr2[pi, j5], shared[pi, pj],
        sizes[i0 * 5 + i5], sizes[j0 * 5 + j5], lf[:, 0], lf[:, 1],
        with_steps=True)
    # acc >= 0 throughout, so the zeros of the JAX package's masked tile
    # never win a maximum and the allowed pairs alone decide it
    acc.scatter_reduce_(0, i0 * 5 + i5, z, "amax")
    acc.scatter_reduce_(0, j0 * 5 + j5, z, "amax")
    if not with_steps:
        return None
    per = torch.zeros((t * THREADS, 3), dtype=torch.int64,
                      device=shared.device)
    per.index_add_(0, pi * THREADS + pj % THREADS,
                   torch.stack([torch.ones_like(steps), steps > 0, steps],
                               dim=1).to(torch.int64))
    return (int(pi.numel()), int((steps > 0).sum()), int(steps.sum()),
            per.view(t, THREADS, 3))


tile_pass_plain.calls = 0
