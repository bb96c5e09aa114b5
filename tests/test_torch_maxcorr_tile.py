"""Kernel E's plain versions and the regrouped device scan, on the CPU.

  * ops/hypergeom_device.positive_significance_f32_each (each pair stops
    at its own running term <= 1e-8, kernel E's rule) against
    positive_significance_f32 (the JAX package's batch-wide rule):
    bit for bit, on counts of up to 13,834 rows;
  * ops/maxcorr_tile.group_pass_plain, on a group's one product, against
    the chain of its tile steps fed the four products (written out below:
    the per-tile pass kernel E ran before, and the [t5, t5] tile step with
    the batch-wide rule before that), breaks inside a group's first and
    middle tile and a short last group among the cases: alive seeds after
    each tile and accumulator bit for bit; the counts it derives from the
    product equal the four products exactly; a negative code raises;
  * the scan's row windows: each holds every row that covers its seed
    tile, and a product over it equals the product over all rows;
  * MaxCorrScan's partner sweep read back once every `group` tile pairs:
    the same bits at every group size, within 1e-5 of the JAX package's
    compute_maxcorrs_device (float32 in two frameworks) with identical
    decisions at the MaxCorrs cutoff, and at most the stated host reads;
  * the card route with kernel E's library stood in for: CUDA-typed
    tensors reach one product and the kernel's launch a group, never the
    plain pass, and a launch or build error raises.

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


def _four_products(sc, msa, i0, j0):
    """The four int8 products of a tile pair as the scan computed them
    before one product a group, over all of the scan's rows: shared,
    schnitt, gr1, gr2, with the coverage built from the MSA as the one-hot
    groups are (rows in the scan's order, padded rows and columns
    uncovered)."""
    t = sc.t
    cov = torch.zeros((sc.nt * t, sc.groups.shape[1]), dtype=torch.int8)
    cov[:sc.c, :sc.r] = torch.from_numpy(
        (np.asarray(msa)[sc.row_order] < 5).T.astype(np.int8))
    gi, ci = sc.groups[i0 * 5:(i0 + t) * 5], cov[i0:i0 + t]
    gj, cj = sc.groups[j0 * 5:(j0 + t) * 5], cov[j0:j0 + t]
    return (int_matmul_t(ci, cj), int_matmul_t(gi, gj), int_matmul_t(gi, cj),
            int_matmul_t(ci, gj))


def _old_tile_step(sc, prods, acc, alive, i0, j0):
    """The scan's tile step before kernel E (its four products and the
    JAX package's arithmetic on the whole [t5, t5] tile, masked after)."""
    t = sc.t
    shared, schnitt, gr1, gr2 = prods
    sok, szi = sc.seed_ok[i0:i0 + t], sc.sizes[i0 * 5:(i0 + t) * 5]
    iota = torch.arange(t)
    ii, jj = i0 + iota[:, None], j0 + iota[None, :]
    valid = (jj >= ii + sc.gap) & (jj < sc.c)
    fail = valid & (shared < sc.mincov)
    cumfail = torch.cumsum(fail.to(torch.int32), dim=1) > 0
    allowed = valid & alive[:, None] & ~cumfail
    alive_next = alive & ~cumfail[:, -1]
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


def _tile_pass(shared, schnitt, gr1, gr2, alive, seed_ok, partner_ok, sizes,
               lf, acc, i0, j0, *, gap, ncols, mincov):
    """Kernel E's plain version as it stood for one tile pair fed the
    four products (the per-pair stop, the allowed pairs alone): returns
    (alive after the tile, (allowed pairs, relevant pairs, tail steps))."""
    t = shared.shape[0]
    iota = torch.arange(t)
    ii, jj = i0 + iota[:, None], j0 + iota[None, :]
    valid = (jj >= ii + gap) & (jj < ncols)
    fail = valid & (shared < mincov)
    cumfail = torch.cumsum(fail.to(torch.int32), dim=1) > 0
    allowed = valid & alive[:, None] & ~cumfail
    pair_ok = (allowed[:, None, :, None]
               & seed_ok[i0:i0 + t][:, :, None, None]
               & partner_ok[j0:j0 + t][None, None, :, :])
    pi, pk, pj, pkk = pair_ok.nonzero(as_tuple=True)
    i5, j5 = pi * 5 + pk, pj * 5 + pkk
    z, steps = phd.positive_significance_f32_each(
        schnitt[i5, j5], gr1[i5, pj], gr2[pi, j5], shared[pi, pj],
        sizes[i0 * 5 + i5], sizes[j0 * 5 + j5], lf[:, 0], lf[:, 1],
        with_steps=True)
    acc.scatter_reduce_(0, i0 * 5 + i5, z, "amax")
    acc.scatter_reduce_(0, j0 * 5 + j5, z, "amax")
    return alive & ~cumfail[:, -1], (int(pi.numel()), int((steps > 0).sum()),
                                     int(steps.sum()))


T = 32


def _scan_of(msa):
    return pmc.MaxCorrScan(msa, MaxCorrConfig(mincov=30), T, CPU)


@pytest.fixture(scope="module")
def tile_scan():
    """A 90 x 300 MSA whose rows cover one interval each (tile 32: ten
    tiles, the last one partial; rows padded to 96): (scan, MSA)."""
    msa = maxcorr_msa(3, rows=90, cols=300)
    return _scan_of(msa), msa


@pytest.fixture(scope="module")
def covered_scan():
    """The same, every row covering every column: no seed is cut, and
    the last partner tile has allowed pairs."""
    msa = maxcorr_msa(3, rows=90, cols=300, ragged=False)
    return _scan_of(msa), msa


def _chain(sc, msa, acc, alive, k, kj, m, step):
    """The m tile steps of seed tile k from partner tile kj, each fed the
    four products: step "old" (_old_tile_step) or "pass" (_tile_pass).
    Returns (the alive seeds after each tile [m, t], the work summed,
    each tile's allowed pairs)."""
    outs, work, allowed = [], (0, 0, 0), []
    for q in range(m):
        i0, j0 = k * T, (kj + q) * T
        prods = _four_products(sc, msa, i0, j0)
        if step == "old":
            alive, ok = _old_tile_step(sc, prods, acc, alive, i0, j0)
            allowed.append(ok)
        else:
            alive, w = _tile_pass(*prods, alive, sc.seed_ok, sc.partner_ok,
                                  sc.sizes, sc.lf, acc, i0, j0, gap=sc.gap,
                                  ncols=sc.c, mincov=sc.mincov)
            work = tuple(a + b for a, b in zip(work, w))
        outs.append(alive)
    return torch.stack(outs), work, allowed


def _find_break(sc, msa, q, m):
    """(k, kj, m, alive) of a group of m tiles (m None: GROUP, or up to
    the last tile) in which a seed alive on entry is cut at a partner
    column inside the group's tile q, after allowed pairs of that tile."""
    acc = torch.zeros_like(sc.acc)
    for k in range(sc.nt):
        alive = {k: sc.seed_ok[k * T:(k + 1) * T].any(dim=1)}
        for kj in range(k, sc.nt):
            nxt, ok = _old_tile_step(sc, _four_products(sc, msa, k * T,
                                                        kj * T),
                                     acc, alive[kj], k * T, kj * T)
            kj0 = kj - q
            mm = min(pmc.GROUP, sc.nt - kj0) if m is None else m
            if (alive[kj] & ~nxt & ok.any(dim=1)).any() and kj0 >= k \
                    and q < mm and kj0 + mm <= sc.nt:
                return k, kj0, mm, alive[kj0]
            alive[kj + 1] = nxt
    raise AssertionError(f"no break inside tile {q} of a group")


CASES = {"diagonal": (3, 3, 3), "last_partial": (7, 7, 3),
         "all_dead": (2, 4, 3), "short_last_group": (0, 8, 2)}


@pytest.mark.parametrize("case", ["diagonal", "last_partial", "all_dead",
                                  "break_inside", "break_middle_tile",
                                  "short_last_group"])
def test_tile_pass_equals_old_tile_step(tile_scan, covered_scan, case):
    """The group pass on the group's one product against the chain of its
    m tile steps fed the four products (the per-tile pass kernel E ran
    before, and the tile step before that): the alive seeds after each
    tile and the accumulator bit for bit, and the same work."""
    covered = case in ("last_partial", "short_last_group")
    sc, msa = covered_scan if covered else tile_scan
    if case.startswith("break"):
        k, kj, m, alive = _find_break(sc, msa, int(case != "break_inside"),
                                      None if case == "break_inside" else 3)
    else:
        k, kj, m = CASES[case]
        alive = sc.seed_ok[k * T:(k + 1) * T].any(dim=1)
        if case == "all_dead":
            alive = torch.zeros_like(alive)
    i0, j0 = k * T, kj * T
    rng = np.random.default_rng(4)
    acc0 = torch.from_numpy(rng.random(sc.acc.shape[0]).astype(np.float32))
    old = acc0.clone()
    outs_old, _, allowed = _chain(sc, msa, old, alive, k, kj, m, "old")
    ref = acc0.clone()
    outs, work_ref, _ = _chain(sc, msa, ref, alive, k, kj, m, "pass")
    acc, out = acc0.clone(), torch.empty((m, T), dtype=torch.bool)
    calls = pmt.group_pass_plain.calls
    work = pmt.group_pass_plain(sc.product(i0, j0, m), alive, out, sc.seed_ok,
                                sc.partner_ok, sc.sizes, sc.lf, acc, i0, j0,
                                gap=sc.gap, ncols=sc.c, mincov=sc.mincov,
                                with_steps=True)
    assert pmt.group_pass_plain.calls == calls + 1
    assert torch.equal(outs, outs_old) and torch.equal(out, outs)
    np.testing.assert_array_equal(ref.numpy(), old.numpy())
    np.testing.assert_array_equal(acc.numpy(), ref.numpy())
    assert work == work_ref
    if case == "all_dead":
        assert work == (0, 0, 0) and torch.equal(acc, acc0) and not out.any()
    else:
        # the pass had work to do: relevant pairs moved the maxima
        assert work[1] > 0 and not torch.equal(acc, acc0)
    if case == "last_partial":
        assert (kj + m) * T > sc.c
    if case == "short_last_group":
        assert m < pmc.GROUP and kj + m == sc.nt and out[-1].any()
    if case.startswith("break"):
        q = int(case != "break_inside")
        before = alive if q == 0 else out[q - 1]
        assert (before & ~out[q] & allowed[q].any(dim=1)).any()


@pytest.mark.parametrize("k,kj,m", [(0, 0, 8), (7, 7, 3)])
def test_derived_counts_equal_products(tile_scan, k, kj, m):
    """shared, gr1 and gr2 summed from the group's one product equal the
    four int8 products of each of its tile pairs exactly, on an MSA with
    gaps (code 4) and uncovered cells (code 5), its 90 rows padded to 96
    and its 300 columns to 320 (the second group ends in the padding)."""
    sc, msa = tile_scan
    assert (msa == 4).any() and (msa == 5).any()
    assert sc.groups.shape[1] > sc.r and sc.nt * T > sc.c
    n0 = sc.product_launches
    schnitt = sc.product(k * T, kj * T, m)
    assert sc.product_launches == n0 + 1
    assert schnitt.shape == (5 * T, 5 * m * T) and schnitt.is_contiguous()
    shared, gr1, gr2 = pmt.derived_counts(schnitt)
    for q in range(m):
        four = _four_products(sc, msa, k * T, (kj + q) * T)
        cols = slice(q * T, (q + 1) * T)
        assert torch.equal(shared[:, cols], four[0])
        assert torch.equal(schnitt[:, 5 * q * T:5 * (q + 1) * T], four[1])
        assert torch.equal(gr1[:, :, cols].reshape(5 * T, T), four[2])
        assert torch.equal(gr2[:, cols, :].reshape(T, 5 * T), four[3])


def test_row_windows_hold_every_covering_row():
    """The scan's rows are sorted by their first covered column, and each
    seed tile's row window, aligned to ROW_ALIGN, holds every row that
    covers one of its columns; the group products over the windows equal
    those over all rows. A 700-row MSA (rows padded to 768) at tile 64,
    whose first tiles' windows leave rows out."""
    msa = maxcorr_msa(8, rows=700, cols=1200)
    sc = pmc.MaxCorrScan(msa, MaxCorrConfig(mincov=200), 64, CPU)
    srt = msa[sc.row_order] < 5
    first = np.where(srt.any(axis=1), srt.argmax(axis=1), msa.shape[1])
    assert (np.diff(first) >= 0).all()
    rp, a = sc.groups.shape[1], pmc.ROW_ALIGN
    assert rp == 768 and len(sc.windows) == sc.nt
    for k, (lo, hi) in enumerate(sc.windows):
        assert lo % a == 0 and hi % a == 0 and 0 <= lo < hi <= rp
        covering = srt[:, k * 64:(k + 1) * 64].any(axis=1).nonzero()[0]
        assert lo <= covering.min() and covering.max() < hi, k
    assert any(hi - lo < rp for lo, hi in sc.windows)
    for k, kj, m in ((0, 0, 8), (1, 3, 5), (15, 16, 3)):
        full = int_matmul_t(sc.groups[k * 320:(k + 1) * 320],
                            sc.groups[kj * 320:(kj + m) * 320])
        assert torch.equal(sc.product(k * 64, kj * 64, m), full), (k, kj)


def test_negative_code_raises():
    """The derived counts need coverage to be the sum of the five groups,
    which a negative code (covered, in no group) breaks."""
    msa = maxcorr_msa(3, rows=40, cols=100)
    msa[5, 7] = -1
    with pytest.raises(ValueError, match="negative code"):
        pmc.MaxCorrScan(msa, MaxCorrConfig(mincov=10), T, CPU)


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


@pytest.mark.parametrize("group", [1, 3, 8])
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
    for g, (_, sc) in res.items():
        # one product and one group pass a group, a host read after each
        assert sc.product_launches == sc.groups_queued == sc.host_reads - 1
        assert sc.groups_queued <= sc.tile_pairs <= g * sc.groups_queued
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
    in for and the plain group pass made to fail if it runs."""
    from repeatresolver_tpu_torch.ops import _build, cuda_maxcorr

    def plain(*a, **k):
        raise AssertionError("the plain group pass ran on the card route")
    monkeypatch.setattr(pmt, "group_pass_plain", plain)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: ctypes.c_void_p())
    fake = _FakeE()
    monkeypatch.setattr(_build, "load", lambda name: fake)
    sc = tile_scan[0]
    for name in ("groups", "acc", "seed_ok", "partner_ok", "sizes", "lf"):
        monkeypatch.setattr(sc, name, getattr(sc, name).clone().as_subclass(
            _CudaTyped))
    for name in ("product_launches", "groups_queued", "tile_pairs"):
        monkeypatch.setattr(sc, name, 0)
    return fake, cuda_maxcorr, sc, monkeypatch


def test_card_route_reaches_kernel_e(card_route):
    """A group step on CUDA-typed state runs one product and launches
    kernel E once, with the tile, group size, offsets, gates and table
    size of its C entry (91 rows)."""
    fake, ce, sc = card_route[:3]
    alive = sc.seed_ok[64:96].any(dim=1).as_subclass(_CudaTyped)
    out = alive.new_empty((3, 32))
    n0 = ce.maxcorr_group.launches
    sc.group_step(alive, out, 64, 96)
    assert ce.maxcorr_group.launches == n0 + 1 and len(fake.launches) == 1
    assert (sc.product_launches, sc.groups_queued, sc.tile_pairs) == (1, 1, 3)
    a = fake.launches[0]
    # 9 pointers, then t, m, i0, j0, gap, ncols, mincov, nmax, the stream
    assert a[9:17] == (32, 3, 64, 96, 20, 300, 30, 90) and len(a) == 18


def test_card_route_raises_on_launch_and_build_errors(card_route):
    fake, ce, sc, monkeypatch = card_route
    alive = sc.seed_ok[:32].any(dim=1).as_subclass(_CudaTyped)
    fake.err = 700
    n0 = ce.maxcorr_group.launches
    with pytest.raises(RuntimeError, match="maxcorr_tile launch failed"):
        sc.group_step(alive, alive.new_empty((2, 32)), 0, 32)
    assert ce.maxcorr_group.launches == n0
    out = alive.new_empty((2, 32))
    with pytest.raises(ValueError, match="alive must not lie in alive_out"):
        ce.maxcorr_group(sc.product(0, 32, 2), out[1], out, sc.seed_ok,
                         sc.partner_ok, sc.sizes, sc.lf, sc.acc, 0, 32,
                         gap=20, ncols=300, mincov=30)

    def no_nvcc(name):
        raise RuntimeError("nvcc failed on csrc/maxcorr_tile.cu")
    monkeypatch.setattr(ce._build, "load", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        sc.group_step(alive, alive.new_empty((2, 32)), 0, 32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ce.maxcorr_group(sc.product(0, 32, 2), alive, out, sc.seed_ok,
                         sc.partner_ok, sc.sizes, sc.lf,
                         torch.zeros(sc.acc.shape[0]), 0, 32, gap=20,
                         ncols=300, mincov=30)
