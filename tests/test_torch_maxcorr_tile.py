"""Kernel E's plain versions and the regrouped device scan, on the CPU.

  * ops/hypergeom_device.positive_significance_f32_each (each pair stops
    at its own running term <= 1e-8, kernel E's rule) against
    positive_significance_f32 (the JAX package's batch-wide rule):
    bit for bit, on counts of up to 13,834 rows;
  * ops/maxcorr_tile.tile_pass_plain against the scan's tile step as it
    stood before it (the [t5, t5] expansion and the batch-wide rule,
    written out below): alive seeds and accumulator bit for bit;
  * MaxCorrScan's partner sweep read back once every `group` tile pairs:
    the same bits at every group size, within 1e-5 of the JAX package's
    compute_maxcorrs_device (float32 in two frameworks) with identical
    decisions at the MaxCorrs cutoff, and at most the stated host reads;
  * the card route with kernel E's library stood in for: CUDA-typed
    tensors reach the kernel's launch, never the plain pass, and a
    launch or build error raises.

Inputs are numpy data from a seed (test_golden_maxcorr's planted MSA,
test_torch_cuda_kernels.maxcorr_msa, random counts).
"""
import ctypes

import numpy as np
import pytest
import torch

from repeatresolver_tpu.config import MaxCorrConfig
from repeatresolver_tpu_torch.models import maxcorr as pmc
from repeatresolver_tpu_torch.ops import hypergeom_device as phd
from repeatresolver_tpu_torch.ops import maxcorr_tile as pmt
from repeatresolver_tpu_torch.ops.devmm import int_matmul_t
from tests.test_golden_maxcorr import planted_msa  # noqa: F401 (fixture)
from tests.test_torch_cuda_kernels import maxcorr_msa
from tests.test_torch_editdp import _CudaTyped

CPU = torch.device("cpu")
ROWS = 13834


def _counts(rng, n, nmax, where):
    """(s, gr1, gr2, cov): `where` 'random' anywhere in the support,
    'near' just above the mode (the slow tails), 'below' under it."""
    nn = rng.integers(1, nmax + 1, n)
    if where == "near":
        nn = rng.integers(nmax // 2, nmax + 1, n)
    k = rng.integers(0, nn + 1)
    g1 = rng.integers(0, nn + 1)
    lo = np.maximum(0, g1 + k - nn)
    hi = np.minimum(g1, k)
    if where == "random":
        s = lo + (rng.random(n) * (hi - lo + 1)).astype(np.int64)
    else:
        mode = ((g1 + 1) * (k + 1)) // (nn + 2)
        off = rng.integers(0, 3, n)
        s = mode + 1 + off if where == "near" else mode - off
        s = np.clip(s, lo, hi)
    return s, g1, k, nn


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_each_stop_equals_batch_rule(seed):
    rng = np.random.default_rng(seed)
    parts = [_counts(rng, 3000, ROWS, w) for w in
             ("random", "near", "below")]
    s, g1, g2, cov = (np.concatenate(v) for v in zip(*parts))
    sz1, sz2 = g1 + rng.integers(0, 3, len(s)), g2 + 1
    hi, lo = (torch.from_numpy(v) for v in phd.log_factorial_table(ROWS))
    args = [_t(v) for v in (s, g1, g2, cov, sz1, sz2)] + [hi, lo]
    batch = phd.positive_significance_f32(*args)
    each, steps = phd.positive_significance_f32_each(*args, with_steps=True)
    np.testing.assert_array_equal(each.numpy(), batch.numpy())
    # the cases reach both ends of the rule: the 128-term cap and an
    # early stop, and pairs at or below the mode take no step
    rel = steps > 0
    assert (steps == 128).sum() > 100 and ((steps > 0) & (steps < 20)).sum() \
        > 100
    assert ((batch > 0) == rel).all() and (~rel).sum() > 1000
    # a pair's value does not depend on the batch it is evaluated in
    half = [a[::2] for a in args[:6]] + [hi, lo]
    np.testing.assert_array_equal(
        phd.positive_significance_f32_each(*half).numpy(),
        batch.numpy()[::2])


def _old_tile_step(sc, acc, alive, i0, j0):
    """The scan's tile step before kernel E (its products and the JAX
    package's arithmetic on the whole [t5, t5] tile, masked after)."""
    t = sc.t
    gi, ci = sc.groups[i0 * 5:(i0 + t) * 5], sc.coverage[i0:i0 + t]
    gj, cj = sc.groups[j0 * 5:(j0 + t) * 5], sc.coverage[j0:j0 + t]
    sok, szi = sc.seed_ok[i0:i0 + t], sc.sizes[i0 * 5:(i0 + t) * 5]
    shared = int_matmul_t(ci, cj)
    iota = torch.arange(t)
    ii, jj = i0 + iota[:, None], j0 + iota[None, :]
    valid = (jj >= ii + sc.gap) & (jj < sc.c)
    fail = valid & (shared < sc.mincov)
    cumfail = torch.cumsum(fail.to(torch.int32), dim=1) > 0
    allowed = valid & alive[:, None] & ~cumfail
    alive_next = alive & ~cumfail[:, -1]
    schnitt, gr1, gr2 = (int_matmul_t(gi, gj), int_matmul_t(gi, cj),
                         int_matmul_t(ci, gj))
    pok, szj = sc.partner_ok[j0:j0 + t], sc.sizes[j0 * 5:(j0 + t) * 5]
    pair_ok = (allowed[:, None, :, None] & sok[:, :, None, None]
               & pok[None, None, :, :]).reshape(t * 5, t * 5)
    g1 = gr1.repeat_interleave(5, dim=1)
    g2 = gr2.repeat_interleave(5, dim=0)
    cv = shared.repeat_interleave(5, dim=0).repeat_interleave(5, dim=1)
    z = phd.positive_significance_f32(schnitt, g1, g2, cv, szi[:, None],
                                      szj[None, :], sc.lf[:, 0], sc.lf[:, 1])
    z = torch.where(pair_ok, z, 0.0)
    acc[i0 * 5:(i0 + t) * 5] = torch.maximum(acc[i0 * 5:(i0 + t) * 5],
                                             z.max(dim=1).values)
    acc[j0 * 5:(j0 + t) * 5] = torch.maximum(acc[j0 * 5:(j0 + t) * 5],
                                             z.max(dim=0).values)
    return alive_next, allowed


T = 32


@pytest.fixture(scope="module")
def tile_scan():
    """A 90 x 300 MSA whose rows cover one interval each (tile 32: ten
    tiles, the last one partial)."""
    msa = maxcorr_msa(3, rows=90, cols=300)
    return pmc.MaxCorrScan(msa, MaxCorrConfig(mincov=30), T, CPU)


@pytest.fixture(scope="module")
def covered_scan():
    """The same, every row covering every column: the last partner tile
    has allowed pairs."""
    msa = maxcorr_msa(3, rows=90, cols=300, ragged=False)
    return pmc.MaxCorrScan(msa, MaxCorrConfig(mincov=30), T, CPU)


def _break_pair(sc):
    """A tile pair in which a seed alive on entry is cut at a partner
    column inside the tile, after some allowed pairs."""
    acc = torch.zeros_like(sc.acc)
    for k in range(sc.nt):
        alive = sc.seed_ok[k * T:(k + 1) * T].any(dim=1)
        for kj in range(k, sc.nt):
            nxt, allowed = _old_tile_step(sc, acc, alive, k * T, kj * T)
            cut = alive & ~nxt & allowed.any(dim=1)
            if cut.any():
                return k, kj, alive
            alive = nxt
    raise AssertionError("no break inside a tile")


@pytest.mark.parametrize("case", ["diagonal", "last_partial", "all_dead",
                                  "break_inside"])
def test_tile_pass_equals_old_tile_step(tile_scan, covered_scan, case):
    sc = covered_scan if case == "last_partial" else tile_scan
    if case == "break_inside":
        k, kj, alive = _break_pair(sc)
    else:
        k, kj = {"diagonal": (3, 3), "last_partial": (7, sc.nt - 1),
                 "all_dead": (2, 4)}[case]
        alive = sc.seed_ok[k * T:(k + 1) * T].any(dim=1)
        if case == "all_dead":
            alive = torch.zeros_like(alive)
    assert case != "last_partial" or (sc.nt * T > sc.c)
    i0, j0 = k * T, kj * T
    rng = np.random.default_rng(4)
    acc0 = torch.from_numpy(rng.random(sc.acc.shape[0]).astype(np.float32))
    ref = acc0.clone()
    ref_alive, allowed = _old_tile_step(sc, ref, alive, i0, j0)
    acc, out = acc0.clone(), torch.empty_like(alive)
    calls = pmt.tile_pass_plain.calls
    work = pmt.tile_pass_plain(*sc.products(i0, j0), alive, out, sc.seed_ok,
                               sc.partner_ok, sc.sizes, sc.lf, acc, i0, j0,
                               gap=sc.gap, ncols=sc.c, mincov=sc.mincov,
                               with_steps=True)
    assert pmt.tile_pass_plain.calls == calls + 1
    assert torch.equal(out, ref_alive)
    np.testing.assert_array_equal(acc.numpy(), ref.numpy())
    # each thread's counts add up to the totals
    assert tuple(int(x) for x in work[3].sum(dim=(0, 1))) == work[:3]
    if case == "all_dead":
        assert work[:3] == (0, 0, 0) and torch.equal(acc, acc0)
    else:
        # the pass had work to do: relevant pairs moved the maxima
        assert work[1] > 0 and not torch.equal(acc, acc0)
    if case == "break_inside":
        assert (alive & ~out).any()


TILE = 32


@pytest.fixture(scope="module")
def jax_scan(planted_msa):  # noqa: F811
    from repeatresolver_tpu.models import maxcorr as jmc
    _, _, msa = planted_msa
    return jmc.compute_maxcorrs_device(msa, MaxCorrConfig(mincov=20),
                                       tile=TILE)


def _grouped(msa, group):
    sc = pmc.MaxCorrScan(msa, MaxCorrConfig(mincov=20), TILE, CPU,
                         group=group)
    return sc.scan(range(sc.nt)).numpy()[:msa.shape[1] * 5], sc


@pytest.mark.parametrize("group", [1, 8])
def test_regrouped_scan_matches_jax(planted_msa, jax_scan, group):  # noqa: F811
    _, _, msa = planted_msa
    cfg = MaxCorrConfig(mincov=20)
    got, sc = _grouped(msa, group)
    again, _ = _grouped(msa, group)
    np.testing.assert_array_equal(got, again)
    cutoff = cfg.resolved_cutoff(msa.shape[1])
    np.testing.assert_array_equal(got > cutoff, jax_scan > cutoff)
    assert (got > cutoff).sum() >= 6
    np.testing.assert_allclose(got, jax_scan, rtol=0, atol=1e-5)
    # the reads: one for the seed tiles, then one a group of pairs
    assert sc.host_reads <= 1 + sc.seed_tiles + sc.tile_pairs / group
    assert sc.tile_pairs_needed <= sc.tile_pairs \
        <= sc.tile_pairs_needed + sc.seed_tiles * (group - 1)
    if group == 1:
        assert sc.host_reads == 1 + sc.tile_pairs
        assert sc.tile_pairs == sc.tile_pairs_needed


def test_group_size_changes_no_bit(planted_msa):  # noqa: F811
    """Group sizes 1, 3 and 8: the same bits and the same pairs needed;
    fewer reads and more pairs scanned as the group grows."""
    _, _, msa = planted_msa
    res = {g: _grouped(msa, g) for g in (1, 3, 8)}
    for g in (3, 8):
        np.testing.assert_array_equal(res[g][0], res[1][0])
        assert res[g][1].tile_pairs_needed == res[1][1].tile_pairs_needed
    assert res[8][1].host_reads < res[3][1].host_reads \
        < res[1][1].host_reads
    assert res[8][1].tile_pairs >= res[1][1].tile_pairs
    stats = pmc.compute_maxcorrs_device(msa, MaxCorrConfig(mincov=20),
                                        tile=TILE, device="cpu")
    np.testing.assert_array_equal(stats, res[pmc.GROUP][0])
    last = pmc.compute_maxcorrs_device.last_stats
    assert last["tile_pairs"] == res[pmc.GROUP][1].tile_pairs
    assert last["host_reads"] == res[pmc.GROUP][1].host_reads


class _FakeE:
    """Stands in for kernel E's compiled library."""

    def __init__(self, err=0):
        self.err = err
        self.launches = []

    def maxcorr_tile_launch(self, *args):
        self.launches.append(args)
        return self.err

    def maxcorr_tile_error_string(self, err):
        return b"stand-in error"


@pytest.fixture
def card_route(monkeypatch, tile_scan):
    """tile_scan's state as CUDA-typed tensors, kernel E's library stood
    in for and the plain tile pass made to fail if it runs."""
    from repeatresolver_tpu_torch.ops import _build, cuda_maxcorr

    def plain(*a, **k):
        raise AssertionError("the plain tile pass ran on the card route")
    monkeypatch.setattr(pmt, "tile_pass_plain", plain)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: ctypes.c_void_p())
    fake = _FakeE()
    monkeypatch.setattr(_build, "load", lambda name: fake)
    sc = tile_scan
    for name in ("groups", "coverage", "acc", "seed_ok", "partner_ok",
                 "sizes", "lf"):
        monkeypatch.setattr(sc, name, getattr(sc, name).clone().as_subclass(
            _CudaTyped))
    return fake, cuda_maxcorr, sc, monkeypatch


def test_card_route_reaches_kernel_e(card_route):
    """A tile step on CUDA-typed state launches kernel E once, with the
    tile, offsets, gates and table size of its C entry (91 rows)."""
    fake, ce, sc = card_route[:3]
    alive = sc.seed_ok[64:96].any(dim=1).as_subclass(_CudaTyped)
    out = torch.empty_like(alive)
    n0 = ce.maxcorr_tile.launches
    sc.tile_step(alive, out, 64, 96)
    assert ce.maxcorr_tile.launches == n0 + 1 and len(fake.launches) == 1
    a = fake.launches[0]
    # 11 pointers, then t, i0, j0, gap, ncols, mincov, nmax, the stream
    assert a[11:18] == (32, 64, 96, 20, 300, 30, 90) and len(a) == 19


def test_card_route_raises_on_launch_and_build_errors(card_route):
    fake, ce, sc, monkeypatch = card_route
    alive = sc.seed_ok[:32].any(dim=1).as_subclass(_CudaTyped)
    fake.err = 700
    n0 = ce.maxcorr_tile.launches
    with pytest.raises(RuntimeError, match="maxcorr_tile launch failed"):
        sc.tile_step(alive, torch.empty_like(alive), 0, 32)
    assert ce.maxcorr_tile.launches == n0

    def no_nvcc(name):
        raise RuntimeError("nvcc failed on csrc/maxcorr_tile.cu")
    monkeypatch.setattr(ce._build, "load", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        sc.tile_step(alive, torch.empty_like(alive), 0, 32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ce.maxcorr_tile(*sc.products(0, 32), alive, torch.empty_like(alive),
                        sc.seed_ok, sc.partner_ok, sc.sizes, sc.lf,
                        torch.zeros(sc.acc.shape[0]), 0, 32, gap=20,
                        ncols=300, mincov=30)
