"""The port's CUDA kernels against their plain torch versions, on the GPU.

Kernel A (csrc/staircase_fill.cu), kernel B (csrc/walk_backtrack.cu),
kernel C (csrc/editdp_fill.cu), kernel D (csrc/editdp_walk.cu), kernel
E (csrc/maxcorr_tile.cu) and kernels F and G (csrc/exact_fill.cu,
csrc/exact_walk.cu) run through their wrappers on CUDA tensors; the plain versions run on the same CUDA tensors. Every integer
output must be equal (tolerance 0); E's float32 maxima within 1e-5
absolute with identical decisions at the MaxCorrs cutoff (the two may
round a log in another ulp). Marked `cuda`: skipped, with the reason,
where torch sees no GPU (the plain versions are held to the JAX package
by tests/test_torch_ops.py, tests/test_torch_editdp.py and
tests/test_torch_maxcorr_tile.py and tests/test_torch_exact_kernels.py
on the CPU). The file imports no jax,
so it also runs where JAX is absent, without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda_kernels.py -q
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


def _inputs(seed, b, tlen, c, len_lo=0.5, gapdense=False, zero_rows=()):
    """test_pallas_backtrack's random blocks, without jax: gap-dense
    column paths (long gap runs, band jumps) and rows of length 0 and 1.
    chip_smoke.py loads this generator by path."""
    rng = np.random.default_rng(seed)
    msa = rng.integers(0, 4, (b, c)).astype(np.int8)
    counts = np.stack([(msa == s).sum(axis=0) for s in range(6)],
                      axis=1).astype(np.int32)
    counts[:, 0] += 10
    seqs = rng.integers(0, 4, (b, tlen)).astype(np.int8)
    if gapdense:
        ways = np.sort(rng.choice(c, (b, tlen)), axis=1).astype(np.int32)
    else:
        ways = np.broadcast_to(
            np.linspace(0, c - 1, tlen).astype(np.int32), (b, tlen)).copy()
    lengths = rng.integers(max(1, int(tlen * len_lo)), tlen + 1,
                           b).astype(np.int32)
    for i in zero_rows:
        lengths[i] = 0 if i % 2 == 0 else 1
    for i in range(b):
        if lengths[i]:
            ways[i, lengths[i]:] = ways[i, lengths[i] - 1]
    return counts, msa, seqs, ways, lengths


def _drifty_case(seed, b=4, c=200, l=64):
    """test_staircase_exact_parity's drifty blocks: slow column-path
    advance with jumps, so paths hug the band bottom across chunks."""
    rng = np.random.default_rng(seed)
    msa = rng.integers(0, 6, (b * 3, c)).astype(np.int8)
    counts = np.stack([(msa == s).sum(axis=0) for s in range(6)],
                      axis=1).astype(np.int32)
    seqs = rng.integers(0, 4, (b, l)).astype(np.int8)
    steps = rng.choice([0, 1, 1, 2, 5], (b, l)).astype(np.int32)
    ways = np.minimum(np.cumsum(steps, axis=1), c - 1).astype(np.int32)
    lengths = rng.integers(l // 2, l + 1, b).astype(np.int32)
    for i in range(b):
        ways[i, lengths[i]:] = ways[i, lengths[i] - 1]
    return counts, msa[:b], seqs, ways, lengths


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _fill_and_walk(dev, counts, msa, seqs, ways, lengths, w, t, widen):
    from repeatresolver_tpu_torch.ops import cuda_backtrack as cb
    from repeatresolver_tpu_torch.ops import cuda_realign as cr
    from repeatresolver_tpu_torch.ops import staircase_realign as sr

    def d(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    counts, msa, seqs = d(counts.astype(np.int32)), d(msa), d(seqs)
    ways, lengths = d(ways.astype(np.int32)), d(lengths.astype(np.int32))
    b, c = msa.shape
    kw = dict(bandwidth=w, chunk=t, widen=widen)
    n0 = cr.staircase_fill.launches
    kernel = cr.staircase_fill(counts, msa, seqs, ways, lengths, c, **kw)
    assert cr.staircase_fill.launches == n0 + 1
    plain = sr.staircase_fill(counts, msa, seqs, ways, lengths, c, **kw)
    for name, k, p in zip(("codes", "band", "final_a"), kernel, plain):
        assert torch.equal(k, p), name
    codes, band, final_a = kernel
    anf_full = sr.staircase_anf(ways, w, t)
    last_way = ways[torch.arange(b, device=dev), (lengths - 1).clamp(min=0)]
    entry_bound = (last_way - w // 2).clamp(min=-1)
    wayin, best = cb.entry_scan(band, final_a, entry_bound, c, cpad=c + 64,
                                bandwidth=w + widen * t)
    aint = anf_full[:, ::t].contiguous()
    n0 = cb.backtrack_moves.launches
    mk = cb.backtrack_moves(codes, wayin, aint, lengths, chunk=t)
    assert cb.backtrack_moves.launches == n0 + 1
    mp = cb.walk_plain(codes, wayin, aint, lengths, chunk=t)
    assert torch.equal(mk, mp), "moves"
    torch.cuda.synchronize()


@pytest.mark.parametrize("seed,gapdense,len_lo,zero_rows", [
    (5, False, 0.5, ()), (7, True, 0.5, ()), (11, True, 0.05, ()),
    (3, False, 0.5, (2, 5)),
])
@pytest.mark.parametrize("widen", [1, 3])
def test_kernels_match_plain(dev, seed, gapdense, len_lo, zero_rows,
                             widen):
    args = _inputs(seed, 8, 256, 512, len_lo=len_lo, gapdense=gapdense,
                   zero_rows=zero_rows)
    _fill_and_walk(dev, *args, 64, 32, widen)


@pytest.mark.parametrize("seed", [1, 26])
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("widen", [1, 16])
def test_kernels_match_plain_drifty(dev, seed, chunk, widen):
    """Covering and uncovering slack: widen 1 at chunk 16 shifts the
    band past the window (the jump arm of the lane d-1 carry)."""
    _fill_and_walk(dev, *_drifty_case(seed), 16, chunk, widen)


def test_kernels_match_plain_wide_window(dev):
    """A window wider than one warp-row of threads (W2 = 3,048, 384
    threads per row) at the production band."""
    args = _inputs(2, 4, 512, 8192, gapdense=True)
    _fill_and_walk(dev, *args, 1000, 128, widen=16)


def test_wrapper_rejects_bad_input(dev):
    from repeatresolver_tpu_torch.ops import cuda_realign as cr
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
            _inputs(5, 2, 64, 128)]
    counts, msa, seqs, ways, lengths = args
    with pytest.raises(ValueError):
        cr.staircase_fill(counts, msa, seqs, ways.to(torch.int64),
                          lengths, 128, bandwidth=64, chunk=32)
    with pytest.raises(ValueError):
        cr.staircase_fill(counts.cpu(), msa, seqs, ways, lengths, 128,
                          bandwidth=64, chunk=32)


def editdp_batch(seed, b, lq, lt, *, per_row_targets=False, pad_from=None):
    """Edit-DP inputs (numpy, from a seed): int16 queries [b, lq] (pad
    100), qlens [b] with a row of length 0 and one of 1 (b >= 4) and one
    at lq, and an int16 target [lt] (or [b, lt] with per_row_targets,
    200 from column pad_from on in every other row): mutated slices of
    the target, a homopolymer row and a homopolymer run in the target,
    so that ties decide codes and entries. chip_smoke.py loads this
    generator by path."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, lt).astype(np.int16)
    t[lt // 7:lt // 7 + min(lt // 5, 40)] = 2
    lens = rng.integers(max(1, lq // 2), lq + 1, b).astype(np.int32)
    lens[0] = lq
    if b >= 4:
        lens[1], lens[2] = 0, 1
    q = np.full((b, lq), 100, np.int16)
    for r in range(b):
        n = int(lens[r])
        start = int(rng.integers(0, max(1, lt - n)))
        src = np.resize(t[start:], n) if lt else np.zeros(n, np.int16)
        mut = rng.random(n) < 0.1
        src[mut] = rng.integers(0, 4, int(mut.sum()))
        q[r, :n] = src
    if b >= 4:
        q[3, :lens[3]] = 2
    if not per_row_targets:
        return q, lens, t
    tg = np.stack([np.roll(t, 3 * r) for r in range(b)])
    if pad_from is not None:
        tg[::2, pad_from:] = 200
    return q, lens, tg


def packed_max_diff(kern, codes8, qlens):
    """The largest difference between kernel C's packed codes [B, nseg,
    steps, T, 2] and the plain codes int8 [Lq, B, Lt] packed by
    cuda_editdp.pack_codes, over the words the kernel writes: rows x in
    [0, qlen). 0 when they are equal. chip_smoke.py loads this by path."""
    from repeatresolver_tpu_torch.ops import cuda_editdp as ce
    lq, _, lt = codes8.shape
    plain = ce.pack_codes(codes8)
    x = ce.packed_rows(lq, lt, kern.device)
    worst = 0
    for r, n in enumerate(qlens.tolist()):
        valid = (x >= 0) & (x < n)
        if n:
            d = (kern[r][:, valid].long() - plain[r][:, valid].long()).abs()
            worst = max(worst, int(d.max()))
    return worst


def _fill_cases(dev, seed, b, lq, lt, per_row, pad_from=None,
                expand=False):
    from repeatresolver_tpu_torch.ops import cuda_editdp as ce
    from repeatresolver_tpu_torch.ops import editdp as ed
    q, lens, tg = editdp_batch(seed, b, lq, lt, per_row_targets=per_row,
                               pad_from=pad_from)
    if expand:                       # cut's stride-0 queries
        q = np.repeat(q[:1], b, axis=0)
        lens = np.full(b, lq, np.int32)
    q = torch.from_numpy(q).to(dev)
    if expand:
        q = q[:1].expand(b, -1)
    lens, tg = torch.from_numpy(lens).to(dev), torch.from_numpy(tg).to(dev)
    return ce, ed, q, lens, tg


@pytest.mark.parametrize("seed,b,lq,lt,per_row,pad_from,expand", [
    (0, 6, 200, 300, False, None, False),   # Lt not a multiple of 32
    (1, 6, 160, 320, False, None, False),   # 16-byte code stores
    (2, 5, 700, 90, False, None, False),    # Lq > Lt
    (3, 4, 66, 9001, True, 5000, True),     # cut: pads, stride-0 queries
    (4, 4, 150, 17000, False, None, False),  # 17 warps a row
    (5, 4, 37, 1, True, None, False),        # Lt = 1 (final rows)
    (6, 3, 50, 33000, True, 20000, False),   # two segments
    (9, 3, 50, 70000, True, 40000, False),   # three: carry buffers reused
    (7, 64, 66, 25950, True, 13000, True),   # cut's shape
    (8, 256, 13700, 4000, False, None, False),  # align's largest batch
])
def test_editdp_fill_matches_plain(dev, seed, b, lq, lt, per_row, pad_from,
                                   expand):
    """Kernel C in its three modes against forward_plain: final rows,
    int8 codes of every row, packed codes of the rows below qlen."""
    ce, ed, q, lens, tg = _fill_cases(dev, seed, b, lq, lt, per_row,
                                      pad_from, expand)
    targets = tg if per_row else tg[None, :].expand(b, -1)
    codes_p = torch.empty((lq, b, lt), dtype=torch.int8, device=dev)
    fr_p = ed.forward_plain(q, lens, targets, codes_p)
    n0 = ce.editdp_fill.launches
    fr, none = ce.editdp_fill(q, lens, tg)
    assert none is None and torch.equal(fr, fr_p), "final rows"
    fr8, codes8 = ce.editdp_fill(q, lens, tg, codes="int8")
    assert torch.equal(fr8, fr_p) and torch.equal(codes8, codes_p), "int8"
    fr2, packed = ce.editdp_fill(q, lens, tg, codes="packed")
    assert torch.equal(fr2, fr_p), "final rows (packed)"
    assert packed_max_diff(packed, codes_p, lens) == 0, "packed codes"
    assert ce.editdp_fill.launches == n0 + 3
    torch.cuda.synchronize()


@pytest.mark.parametrize("seed,b,lq,lt", [
    (6, 6, 200, 300), (7, 5, 700, 90), (8, 4, 120, 9001), (9, 4, 40, 2),
    (11, 256, 13700, 4000),                 # align's largest batch
])
def test_editdp_walk_matches_plain(dev, seed, b, lq, lt):
    """Kernel D against walk_plain on the plain codes packed, and on
    kernel C's own packed codes; align_on_device on the card never runs
    the plain loop."""
    ce, ed, q, lens, t = _fill_cases(dev, seed, b, lq, lt, False)
    codes_p = torch.empty((lq, b, lt), dtype=torch.int8, device=dev)
    fr_p = ed.forward_plain(q, lens, t[None, :].expand(b, -1), codes_p)
    al_p = ed.walk_plain(codes_p, lens, fr_p)
    walked = torch.full((b,), -1, dtype=torch.int32, device=dev)
    n0 = ce.editdp_walk.launches
    al = ce.editdp_walk(ce.pack_codes(codes_p), lens, fr_p, walked=walked)
    assert torch.equal(al, al_p), "walk over the plain codes"
    assert ce.editdp_walk.launches == n0 + 1
    assert (walked[lens > 0] > 0).all() and (walked[lens == 0] == 0).all()
    plain = (ed.forward_plain.calls, ed.walk_plain.calls)
    al_k, fr_k = ed.align_on_device(q, lens, t)
    assert (ed.forward_plain.calls, ed.walk_plain.calls) == plain
    assert torch.equal(al_k, al_p) and torch.equal(fr_k, fr_p)
    assert (al_k[1] == -1).all()
    torch.cuda.synchronize()


@pytest.mark.parametrize("lt,nseg", [(33000, 2), (70000, 3)])
def test_editdp_walk_across_segments(dev, lt, nseg):
    """Kernel C's packed codes over two and three segments (the third
    reuses the first's carry buffer) and kernel D's walk from the last
    segment into the one before: queries are mutated copies of the
    target around that segment border."""
    from repeatresolver_tpu_torch.ops import cuda_editdp as ce
    from repeatresolver_tpu_torch.ops import editdp as ed
    lq, b = 3000, 3
    threads, got, _ = ce.layout(lq, lt)
    border = (nseg - 1) * threads * 32      # the last segment's first column
    assert got == nseg
    rng = np.random.default_rng(12)
    t = rng.integers(0, 4, lt).astype(np.int16)
    q = np.full((b, lq), 100, np.int16)
    lens = np.array([lq, lq - 700, 0], np.int32)
    for r in range(2):
        src = t[border - lq // 2:border - lq // 2 + lens[r]].copy()
        mut = rng.random(lens[r]) < 0.1
        src[mut] = rng.integers(0, 4, int(mut.sum()))
        q[r, :lens[r]] = src
    q, lens, t = (torch.from_numpy(a).to(dev) for a in (q, lens, t))
    codes_p = torch.empty((lq, b, lt), dtype=torch.int8, device=dev)
    fr_p = ed.forward_plain(q, lens, t[None, :].expand(b, -1), codes_p)
    al_p = ed.walk_plain(codes_p, lens, fr_p)
    assert int(al_p[0].max()) >= border > int(al_p[0][al_p[0] >= 0].min())
    fr, packed = ce.editdp_fill(q, lens, t, codes="packed")
    assert torch.equal(fr, fr_p)
    assert packed_max_diff(packed, codes_p, lens) == 0
    assert torch.equal(ce.editdp_walk(packed, lens, fr), al_p)
    torch.cuda.synchronize()


def test_editdp_wrappers_reject_bad_input(dev):
    from repeatresolver_tpu_torch.ops import cuda_editdp as ce
    q, lens, t = (torch.from_numpy(a).to(dev)
                  for a in editdp_batch(1, 4, 30, 50))
    with pytest.raises(ValueError, match="int16"):
        ce.editdp_fill(q.to(torch.int32), lens, t)
    with pytest.raises(ValueError, match="qlens"):
        ce.editdp_fill(q, lens + 40, t)
    with pytest.raises(ValueError, match="CUDA"):
        ce.editdp_fill(q.cpu(), lens.cpu(), t.cpu())
    fr, packed = ce.editdp_fill(q, lens, t[:1], codes="packed")
    with pytest.raises(ValueError, match="2 columns|packed layout"):
        ce.editdp_walk(packed, lens, fr)


# ---- kernel E: a group of tile pairs of the MaxCorrs device scan

def maxcorr_msa(seed, rows=80, cols=300, copies=2, snp_every=37,
                ragged=True):
    """A small MaxCorrs input: `copies` copy groups told apart at every
    snp_every-th column, 2% noise, 3% gaps, and, if ragged, each row
    covering one interval (coverage gap 5 outside), so that partner
    sweeps break. tests/test_torch_maxcorr_tile.py uses it too."""
    rng = np.random.default_rng(seed)
    consensus = rng.integers(0, 4, cols)
    msa = np.tile(consensus, (rows, 1)).astype(np.int8)
    group = np.arange(rows) % copies
    for cc in range(5, cols, snp_every):
        for g in range(1, copies):
            msa[group == g, cc] = (consensus[cc] + g) % 4
    noise = rng.random((rows, cols)) < 0.02
    msa[noise] = rng.integers(0, 4, noise.sum())
    msa[rng.random((rows, cols)) < 0.03] = 4
    if not ragged:
        return msa
    lo = rng.integers(0, cols // 3, rows)
    hi = rng.integers(2 * cols // 3, cols + 1, rows)
    for r in range(rows):
        msa[r, :lo[r]] = 5
        msa[r, hi[r]:] = 5
    return msa


def compare_maxcorr_group(sc, i0, j0, m, alive, acc0):
    """Kernel E and its plain version on the group of m tile pairs of the
    scan `sc` (models/maxcorr.MaxCorrScan on the card) at seed column i0
    and partner column j0, on the group's one product, from the same
    alive seeds and accumulator: (max |dZ| over the accumulator, entries
    whose decision at the scan's cutoff differs, the alive seeds after
    every tile equal, the plain version's work:
    group_pass_plain(with_steps=True), the seeds alive on entry and cut
    inside the group). chip_smoke.py loads this by path."""
    from repeatresolver_tpu_torch.ops import cuda_maxcorr, maxcorr_tile
    schnitt = sc.product(i0, j0, m)
    outs, accs = [], []
    for fn, kw in ((cuda_maxcorr.maxcorr_group, {}),
                   (maxcorr_tile.group_pass_plain, dict(with_steps=True))):
        acc = acc0.clone()
        out = torch.empty((m, alive.shape[0]), dtype=torch.bool,
                          device=alive.device)
        work = fn(schnitt, alive, out, sc.seed_ok, sc.partner_ok, sc.sizes,
                  sc.lf, acc, i0, j0, gap=sc.gap, ncols=sc.c,
                  mincov=sc.mincov, **kw)
        outs.append(out)
        accs.append(acc)
    torch.cuda.synchronize()
    cutoff = -np.log10(1.0 / (5.0 * sc.c))
    dz = float((accs[0] - accs[1]).abs().max())
    differ = int(((accs[0] > cutoff) != (accs[1] > cutoff)).sum())
    cut = int((alive & ~outs[1][-1]).sum())
    return dz, differ, bool(torch.equal(outs[0], outs[1])), work, cut


@pytest.mark.parametrize("seed,rows,cols,tile", [
    (1, 80, 300, 32), (2, 600, 1200, 256), (3, 600, 1200, 64),
    (4, 2000, 700, 128),
    (5, 30000, 512, 128),                # a table of 240 KB
])
def test_maxcorr_tile_matches_plain(dev, seed, rows, cols, tile):
    """Random groups of a scan (GROUP partner tiles, or up to the last):
    from the diagonal tile, from its neighbour, the last (partial)
    partner tile alone and a group past the middle; all seeds alive, a
    random half alive, and none. Some group cuts a seed inside it."""
    from repeatresolver_tpu_torch.config import MaxCorrConfig
    from repeatresolver_tpu_torch.models import maxcorr as pmc
    from repeatresolver_tpu_torch.ops import cuda_maxcorr
    msa = maxcorr_msa(seed, rows, cols)
    sc = pmc.MaxCorrScan(msa, MaxCorrConfig(mincov=rows // 3), tile, dev)
    rng = np.random.default_rng(seed)
    n0 = cuda_maxcorr.maxcorr_group.launches
    relevant = cut = 0
    for k, kj in ((0, 0), (0, 1), (0, sc.nt - 1),
                  (sc.nt // 2, min(sc.nt - 1, sc.nt // 2 + 1))):
        i0, j0 = k * tile, kj * tile
        m = min(pmc.GROUP, sc.nt - kj)
        seeds = sc.seed_ok[i0:i0 + tile].any(dim=1)
        half = torch.from_numpy(rng.random(tile) < 0.5).to(dev)
        acc0 = torch.from_numpy(rng.random(sc.acc.shape[0]).astype(
            np.float32) * 3).to(dev)
        for alive in (seeds, seeds & half, torch.zeros_like(seeds)):
            dz, differ, same_alive, work, c = compare_maxcorr_group(
                sc, i0, j0, m, alive, acc0)
            assert dz == 0 and differ == 0 and same_alive, (k, kj, dz)
            relevant += work[1]
            cut += c
    assert relevant > 0 and cut > 0
    assert cuda_maxcorr.maxcorr_group.launches == n0 + 12


def test_maxcorr_scan_launches_e_only(dev):
    """The device scan on the card runs one product and one call of
    kernel E a group queued, and never the plain group pass."""
    from repeatresolver_tpu_torch.config import MaxCorrConfig
    from repeatresolver_tpu_torch.models import maxcorr as pmc
    from repeatresolver_tpu_torch.ops import cuda_maxcorr, maxcorr_tile
    msa = maxcorr_msa(6, 200, 900)
    plain0 = maxcorr_tile.group_pass_plain.calls
    n0 = cuda_maxcorr.maxcorr_group.launches
    sc = pmc.MaxCorrScan(msa, MaxCorrConfig(mincov=60), 64, dev)
    acc = sc.scan(range(sc.nt))
    torch.cuda.synchronize()
    assert cuda_maxcorr.maxcorr_group.launches - n0 == sc.groups_queued \
        == sc.product_launches > 0
    assert sc.groups_queued <= sc.tile_pairs <= pmc.GROUP * sc.groups_queued
    assert maxcorr_tile.group_pass_plain.calls == plain0
    assert sc.tile_pairs_needed <= sc.tile_pairs
    cpu = pmc.MaxCorrScan(msa, MaxCorrConfig(mincov=60), 64,
                          torch.device("cpu")).scan(range(sc.nt))
    np.testing.assert_allclose(acc.cpu().numpy(), cpu.numpy(), rtol=0,
                               atol=1e-5)


def test_maxcorr_tile_rejects_bad_input(dev):
    from repeatresolver_tpu_torch.config import MaxCorrConfig
    from repeatresolver_tpu_torch.models import maxcorr as pmc
    from repeatresolver_tpu_torch.ops import cuda_maxcorr
    sc = pmc.MaxCorrScan(maxcorr_msa(7), MaxCorrConfig(mincov=20), 32, dev)
    schnitt = sc.product(0, 32, 2)
    alive = sc.seed_ok[:32].any(dim=1)
    out = torch.empty((2, 32), dtype=torch.bool, device=dev)
    args = [sc.seed_ok, sc.partner_ok, sc.sizes, sc.lf, sc.acc]
    kw = dict(gap=sc.gap, ncols=sc.c, mincov=sc.mincov)
    with pytest.raises(ValueError, match="schnitt"):
        cuda_maxcorr.maxcorr_group(schnitt.to(torch.int64), alive, out,
                                   *args, 0, 32, **kw)
    with pytest.raises(ValueError, match="alive must not lie"):
        cuda_maxcorr.maxcorr_group(schnitt, out[1], out, *args, 0, 32, **kw)
    with pytest.raises(ValueError, match="do not lie"):
        cuda_maxcorr.maxcorr_group(schnitt, alive, out, *args, 0,
                                   (sc.nt - 1) * 32, **kw)


# ---- kernels F and G: the exact band's fill, entry scan and walk

def exact_inputs(seed, b, c, l, w, cpad=None):
    """An exact-band block (numpy, from a seed): counts int32 [cpad, 6]
    of a random MSA of 3b rows over c columns, rows_old int8 [b, cpad]
    (symbol 5 and zero counts past c), seqs int8 [b, l], ways int32
    [b, l] (monotone, with jumps past the band, edge-padded past each
    row's length) and lengths int32 [b]: row 0 empty, row 1 one base,
    row 2 ending at column c - 1 (b >= 4). Returns (counts, rows_old,
    seqs, ways, lengths, ncols). chip_smoke.py loads it by path."""
    rng = np.random.default_rng(seed)
    cpad = c + 8 if cpad is None else cpad
    msa = rng.choice(6, (3 * b, c), p=[.2, .2, .2, .2, .12, .08]).astype(
        np.int8)
    counts = np.zeros((cpad, 6), np.int32)
    for sym in range(6):
        counts[:c, sym] = (msa == sym).sum(axis=0)
    rows_old = np.full((b, cpad), 5, np.int8)
    rows_old[:, :c] = msa[:b]
    seqs = rng.integers(0, 4, (b, l)).astype(np.int8)
    steps = rng.choice([0, 1, 1, 1, 2, 3, w + 3], (b, l),
                       p=[.15, .3, .2, .15, .1, .07, .03])
    start = rng.integers(0, max(1, c // 4), (b, 1))
    ways = np.minimum(start + np.cumsum(steps, axis=1), c - 1).astype(
        np.int32)
    lengths = rng.integers(max(1, l // 2), l + 1, b).astype(np.int32)
    lengths[0], lengths[1] = 0, 1
    ways[0] = 0
    lengths[2] = l
    ways[2, -1] = c - 1
    for i in range(1, b):
        ways[i, lengths[i]:] = ways[i, lengths[i] - 1]
    return counts, rows_old, seqs, ways, lengths, c


def exact_shift_inputs(seed, b, c, l, w, span=128):
    """exact_inputs' block with steps of every kind kernel F splits: 0,
    1, a few columns, half and past a warp's span of lanes (`span`),
    half and past the band."""
    counts, rows, seqs, ways, lengths, ncols = exact_inputs(seed, b, c, l, w)
    rng = np.random.default_rng(seed + 100)
    steps = rng.choice([0, 1, 2, 3, span // 2, span + 5, w // 2 + 1, w + 3],
                       (b, l), p=[.15, .3, .25, .15, .06, .04, .03, .02])
    start = rng.integers(0, max(1, c // 8), (b, 1))
    ways = np.minimum(start + np.cumsum(steps, axis=1), c - 1).astype(
        np.int32)
    ways[0] = 0
    ways[2, -1] = c - 1
    for i in range(1, b):
        ways[i, lengths[i]:] = ways[i, lengths[i] - 1]
    return counts, rows, seqs, ways, lengths, ncols


def unpad_ways(arrays, seed):
    """The block with the ways of every other row not edge-padded past
    its length (random columns): past the row's end the band then moves
    below its carried start and the jump rule's base differs from it."""
    counts, rows, seqs, ways, lengths = (a.copy() for a in arrays)
    rng = np.random.default_rng(seed)
    c = int((counts.sum(axis=1) > 0).sum())
    for b in range(1, len(lengths), 2):
        n = ways.shape[1] - lengths[b]
        if n > 0:
            ways[b, lengths[b]:] = rng.integers(0, c, n)
    return counts, rows, seqs, ways, lengths


def insert_heavy_block(n=2100, others=3):
    """A block whose last row needs n - 1 inserts (more than
    MAX_INSERTS for n > 2049): the other rows hold a consensus in the
    even columns and gaps in the odd ones, the last row a base in every
    column. Returns (msa int8 [others + 1, 2n], its rows in block
    order)."""
    rng = np.random.default_rng(0)
    cons = rng.integers(0, 4, n).astype(np.int8)
    msa = np.full((others + 1, 2 * n), 4, np.int8)
    msa[:, 0::2] = cons
    msa[others, 1::2] = rng.integers(0, 4, n)
    return msa, [others] + list(range(others))


def exact_bounds(ways, lengths, w):
    """(anf_full, entry_bound) of an exact-band block (numpy)."""
    b = len(lengths)
    anf = np.maximum(0, ways - w // 2).astype(np.int32)
    last_way = ways[np.arange(b), np.maximum(lengths - 1, 0)]
    return anf, np.maximum(-1, last_way - w // 2).astype(np.int32)


EXACT_CASES = [(1, 4, 200, 64, 16), (2, 6, 600, 150, 64),
               (3, 8, 3000, 400, 256), (4, 4, 6000, 160, 2600),
               (5, 5, 5000, 700, 1000)]


@pytest.mark.parametrize("seed,b,c,l,w", EXACT_CASES)
def test_exact_kernels_match_plain(dev, seed, b, c, l, w):
    """F's codes, band and band start, G's moves, entry and best, and
    the rebuilt rows and inserts, bit-equal to the plain versions."""
    from repeatresolver_tpu_torch.ops import cuda_exact as ce
    *arrays, ncols = exact_inputs(seed, b, c, l, w)
    counts, rows, seqs, ways, lengths = (torch.from_numpy(a).to(dev)
                                         for a in arrays)
    anf, eb = (torch.from_numpy(a).to(dev)
               for a in exact_bounds(arrays[3], arrays[4], w))
    cpad = rows.shape[1]
    n0 = ce.exact_fill.launches
    kern = ce.exact_fill(counts, rows, seqs, ways, lengths, ncols,
                         bandwidth=w)
    assert ce.exact_fill.launches == n0 + 1
    plain = ce.exact_fill_plain(counts, rows, seqs, ways, lengths, ncols,
                                bandwidth=w)
    for name, k, p in zip(("codes", "band", "anf"), kern, plain):
        assert torch.equal(k, p), name
    n0 = ce.exact_walk.launches
    walk = ce.exact_walk(kern[0], kern[1], kern[2], eb, anf, lengths, ncols,
                         cpad=cpad)
    assert ce.exact_walk.launches == n0 + 1
    walk_p = ce.exact_walk_plain(kern[0], kern[1], kern[2], eb, anf,
                                 lengths, ncols, cpad=cpad)
    for name, k, p in zip(("moves", "wayin", "best"), walk, walk_p):
        assert torch.equal(k, p), name
    torch.cuda.synchronize()


# wide bands: 4,200 (past kernel A's 4,096 lanes, four CTAs a row),
# 8,192 (four) and the clustered layout's cap (eight); past it the wide
# layout: 20,000 (two groups of 2,048 lanes a CTA), 32,768 (two) and
# 65,536 (four)
EXACT_WIDE_CASES = [(9, 4, 12600, 96, 4200), (10, 4, 24600, 48, 8192),
                    (11, 4, 49200, 48, 16384), (17, 4, 49300, 48, 16392),
                    (14, 4, 60000, 48, 20000),
                    (15, 4, 98400, 40, 32768), (16, 3, 196800, 32, 65536)]


def _fill_same(dev, arrays, ncols, w):
    from repeatresolver_tpu_torch.ops import cuda_exact as ce
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
    kern = ce.exact_fill(*t, ncols, bandwidth=w)
    plain = ce.exact_fill_plain(*t, ncols, bandwidth=w)
    for name, k, p in zip(("codes", "band", "anf"), kern, plain):
        assert torch.equal(k, p), name
    torch.cuda.synchronize()
    return kern


@pytest.mark.parametrize("seed,b,c,l,w", EXACT_WIDE_CASES)
def test_exact_fill_wide_bands(dev, seed, b, c, l, w):
    """F at each wide band, and G over its codes, bit-equal to their
    plain versions."""
    from repeatresolver_tpu_torch.ops import cuda_exact as ce
    *arrays, ncols = exact_shift_inputs(seed, b, c, l, w)
    kern = _fill_same(dev, arrays, ncols, w)
    anf, eb, lengths = (torch.from_numpy(a).to(dev) for a in (
        *exact_bounds(arrays[3], arrays[4], w), arrays[4]))
    walk = ce.exact_walk(*kern, eb, anf, lengths, ncols, cpad=c + 8)
    walk_p = ce.exact_walk_plain(*kern, eb, anf, lengths, ncols,
                                 cpad=c + 8)
    for name, k, p in zip(("moves", "wayin", "best"), walk, walk_p):
        assert torch.equal(k, p), name


@pytest.mark.parametrize("w", [1000, 3000, 4200, 9000])
@pytest.mark.parametrize("padded", [True, False])
def test_exact_fill_geometries_and_shifts(dev, w, padded):
    """One, two, four and eight CTAs a row (bands 1,000, 3,000, 4,200
    and 9,000) on a block with every kind of shift and rows that cross x = 256; past
    some rows' ends the ways are not edge-padded (shifts below 0, jump
    bases that are not the carried band start)."""
    *arrays, ncols = exact_shift_inputs(12, 6, 9 * w, 300, w)
    if not padded:
        arrays = unpad_ways(arrays, 12)
    _fill_same(dev, arrays, ncols, w)


@pytest.mark.parametrize("ctas,wide", [(1, None), (2, None), (4, None),
                                       (8, None), (None, True)])
def test_exact_fill_any_layout(dev, ctas, wide):
    """Band 1,000 at each number of CTAs a row the wrapper can be asked
    for, and in the wide layout: the same bits as the plain version."""
    from repeatresolver_tpu_torch.ops import cuda_exact as ce
    *arrays, ncols = exact_shift_inputs(13, 6, 9000, 300, 1000)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
    kern = ce.exact_fill(*t, ncols, bandwidth=1000, ctas=ctas, wide=wide)
    plain = ce.exact_fill_plain(*t, ncols, bandwidth=1000)
    for name, k, p in zip(("codes", "band", "anf"), kern, plain):
        assert torch.equal(k, p), name
    torch.cuda.synchronize()


def walk_codes_case(seed, b=6, l=90, w=12, c=160):
    """Random codes [B, L, W] with nonzero lane-0 codes and band starts
    that often stand still, so that diagonals from lane 0 leave the band
    (the lockstep walk's clamp), and jumps of the band start. Returns
    (packed codes, band, fanf, entry bound, anf, lengths, c)."""
    from repeatresolver_tpu_torch.ops import cuda_exact as ce
    rng = np.random.default_rng(seed)
    codes = rng.choice(3, size=(b, l, w), p=[.5, .3, .2]).astype(np.uint8)
    codes[:, :, 0] = rng.choice([1, 2], size=(b, l), p=[.8, .2])
    anf = np.minimum(np.cumsum(rng.choice([0, 0, 1, 2, 7, w + 40], (b, l),
                                          p=[.3, .2, .2, .15, .13, .02]),
                               1), c - 1).astype(np.int32)
    lengths = rng.integers(1, l + 1, b).astype(np.int32)
    lengths[0] = 0
    band = rng.integers(0, 40, (b, w)).astype(np.int32)
    fanf = anf[np.arange(b), np.maximum(lengths - 1, 0)]
    eb = (fanf - rng.integers(0, 3, b)).astype(np.int32)
    packed = ce.pack_codes(torch.from_numpy(codes))
    return packed, band, fanf, eb, anf, lengths, c


@pytest.mark.parametrize("seed,b,l,w", [(0, 6, 90, 12), (1, 8, 700, 600),
                                        (2, 4, 1500, 1000)])
def test_exact_walk_random_codes(dev, seed, b, l, w):
    """G's walk on random codes (walks below their band, gap runs past
    a window and a tile, band jumps) equals its plain version."""
    from repeatresolver_tpu_torch.ops import cuda_exact as ce
    packed, *rest, c = walk_codes_case(seed, b, l, w, c=3 * l + 2 * w)
    t = [packed.to(dev)] + [torch.from_numpy(a).to(dev) for a in rest]
    got = ce.exact_walk(*t, c, cpad=c + 5)
    ref = ce.exact_walk_plain(*t, c, cpad=c + 5)
    for name, g, r in zip(("moves", "wayin", "best"), got, ref):
        assert torch.equal(g, r), name
    m = got[0].permute(1, 0, 2).reshape(b, -1).cpu().numpy()[:, :l]
    assert ((m >> 2) < rest[3])[m >= 0].any(), "no walk left its band"
    torch.cuda.synchronize()


def test_exact_kernels_list_any_insert_count(dev):
    """A row with more inserts than MAX_INSERTS: kernels F and G list
    them all, equal to the host native engine's."""
    from repeatresolver_tpu_torch.models import realigner as prt
    from repeatresolver_tpu_torch.ops import banded_realign as br
    from repeatresolver_tpu_torch.utils import native
    msa, order = insert_heavy_block()
    w = 64
    counts = prt.symbol_counts(msa).astype(np.int32)
    rows_old = msa[order]
    seqs, ways, lengths = prt.compact_rows(rows_old)
    anf, eb = exact_bounds(ways, lengths, w)
    ref = prt.realign_block_native(native, counts, rows_old, seqs, ways,
                                   lengths, w)
    assert ref[4].max() > br.MAX_INSERTS
    out = prt.block_dp(*(torch.from_numpy(a).to(dev) for a in (
        counts, rows_old, seqs, ways, lengths, anf, eb)), msa.shape[1],
        bandwidth=w, chunk=256, widen=1, staircase=False, kernel="torch")
    out = [t.cpu().numpy() for t in out]
    for name, g, r in zip(("rows", "best", "inn"), out[:2] + out[4:],
                          ref[:2] + ref[4:]):
        np.testing.assert_array_equal(g, r, err_msg=name)
    for i, n in enumerate(ref[4]):
        np.testing.assert_array_equal(out[2][i, :n], ref[2][i, :n])
        np.testing.assert_array_equal(out[3][i, :n], ref[3][i, :n])


def test_exact_wrappers_reject_bad_input(dev):
    from repeatresolver_tpu_torch.ops import cuda_exact as ce
    *arrays, ncols = exact_inputs(1, 4, 200, 64, 16)
    counts, rows, seqs, ways, lengths = (torch.from_numpy(a).to(dev)
                                         for a in arrays)
    with pytest.raises(ValueError, match="ways"):
        ce.exact_fill(counts, rows, seqs, ways.to(torch.int64), lengths,
                      ncols, bandwidth=16)
    with pytest.raises(ValueError, match="counts is on"):
        ce.exact_fill(counts.cpu(), rows, seqs, ways, lengths, ncols,
                      bandwidth=16)
    with pytest.raises(ValueError, match="unsupported band"):
        ce.exact_fill(counts, rows, seqs, ways, lengths, ncols,
                      bandwidth=0)
    codes, band, anf = ce.exact_fill(counts, rows, seqs, ways, lengths,
                                     ncols, bandwidth=16)
    with pytest.raises(ValueError, match="inconsistent"):
        ce.exact_walk(codes, band, anf, lengths,
                      ways[:, :16].contiguous(), lengths,
                      ncols, cpad=rows.shape[1])


def serial_msa(seed, rows, tlen, d=0.06):
    """tests/test_realigner_device.make_msa's MSA, without jax: rows of a
    template with substitutions, '-' and ragged ends."""
    rng = np.random.default_rng(seed)
    template = rng.integers(0, 4, tlen)
    msa = np.full((rows, tlen), 5, np.int8)
    for k in range(rows):
        row = template.copy()
        muts = rng.random(tlen) < d
        row[muts] = rng.integers(0, 4, int(muts.sum()))
        row[rng.random(tlen) < 0.08] = 4
        lo = rng.integers(0, tlen // 8)
        hi = tlen - rng.integers(0, tlen // 8)
        msa[k, lo:hi] = row[lo:hi]
    return msa


@pytest.mark.parametrize("w,slack", [(96, None), (1000, None), (96, 0)])
def test_serial_sweep_on_the_card_matches_host(dev, w, slack):
    """Two block-1 sweeps on the card (BatchedRealigner._sweep_serial_card:
    kernels F and G a row over the column store on the device; slack 0
    regrows the store at the first insert) equal the host serial sweep
    on the native engine, MSA and histogram, after each sweep; F and G
    launch once a row with bases."""
    from repeatresolver_tpu_torch.models import realigner as prt
    from repeatresolver_tpu_torch.ops import cuda_exact as ce
    msa = serial_msa(5, rows=24, tlen=1500)
    msa[7] = 5                                  # a row without bases
    card = prt.BatchedRealigner(msa.copy(), bandwidth=w, block_rows=1,
                                mode="exact", kernel="cuda", device=dev)
    host = prt.BatchedRealigner(msa.copy(), bandwidth=w, block_rows=1,
                                mode="exact", kernel="native", device="cpu")
    f0, g0 = ce.exact_fill.launches, ce.exact_walk.launches
    for _ in range(2):
        card._sweep_serial_card(slack=slack)
        host.sweep()
        np.testing.assert_array_equal(card.msa, host.msa)
        np.testing.assert_array_equal(card.counts, host.counts)
    assert ce.exact_fill.launches - f0 == ce.exact_walk.launches - g0 \
        == 2 * 23
    torch.cuda.synchronize()


# ---- kernel H: relative_vars' pair pass (ops/cuda_resolver.py)

PAIR_CLUSTERS = ((30, 40), (64, 25), (130, 60), (1, 3), (200, 0),
                 (3000, 50), (48, 700), (64, 1300), (20, 300), (150, 200))


def pair_pass_inputs(seed, clusters=PAIR_CLUSTERS, span=8000,
                     forms=None):
    """Random inputs of kernel H in ops/cuda_resolver's layout, as numpy
    arrays: for each (size, selected rows) cluster, random memberships
    of `size` rows packed 64 a word (bits past size clear), ascending
    distinct group indices below `span` (so that some pairs lie 100
    apart and some do not; span grows with the selected rows), the
    popcounts' table indices, and the table's form: `forms` (one a
    cluster) or BITMAP, HASHED and HASHED_WIDE in turn, each BITMAP
    table's decisions random bits over its words, the hashed tables'
    entries spaced apart by hbase."""
    from repeatresolver_tpu_torch.ops import cuda_resolver as cv
    rng = np.random.default_rng(seed)
    out = {k: [] for k in ("masks", "sel", "gidx", "rowk", "word_off",
                           "words", "tab_off", "tab_words", "dims",
                           "hbase", "kflag")}
    row_off, ntab, nword, nbase = [0], 0, 0, 0
    for k, (size, n) in enumerate(clusters):
        w = -(-size // 64)
        bits = rng.random((n, w * 64)) < rng.uniform(0.05, 0.95)
        bits[:, size:] = False
        packed = np.packbits(bits, axis=1, bitorder="little")
        out["masks"].append(packed.reshape(-1).view("<i8"))
        out["sel"].append(np.sort(rng.choice(max(span, 30 * n), n,
                                             replace=False)))
        gr = bits.sum(1)
        vals = np.unique(gr) if n else np.zeros(0, np.int64)
        d = len(vals)
        form = forms[k] if forms is not None else k % 3
        tw = cv.bitmap_words(d, int(vals.max())) if d else 0
        if form != cv.BITMAP or tw * 4 > cv.SMEM_TABLE_BYTES:
            form = cv.HASHED if form == cv.BITMAP else form
            tw = 0
        out["gidx"].append(np.searchsorted(vals, gr))
        out["rowk"].append(np.full(n, k))
        out["word_off"].append(nword)
        out["words"].append(w)
        out["tab_off"].append(ntab)
        out["tab_words"].append(tw)
        out["dims"].append(d)
        out["hbase"].append(nbase)
        out["kflag"].append(form)
        nword += n * w
        ntab += tw
        nbase += (int(vals.max()) + 1) * d * d if d else 0
        row_off.append(row_off[-1] + n)
    arr = {k: np.concatenate([np.atleast_1d(np.asarray(x, np.int64))
                              for x in v]) if v else np.zeros(0, np.int64)
           for k, v in out.items()}
    res = {k: v.astype(np.int64 if k in ("masks", "hbase") else np.int32)
           for k, v in arr.items()}
    res["row_off"] = np.array(row_off, np.int32)
    # sparse hits: the AND of six random words keeps a bit in 64
    t = rng.integers(0, 2 ** 32, (6, max(ntab, 4)), dtype=np.uint64)
    res["tables"] = np.bitwise_and.reduce(t).astype(np.uint32).view(
        np.int32)
    return res


def pair_pass_on(arrays, dev, tiles=None):
    """(PairPass, tables) of pair_pass_inputs' arrays on `dev`, with
    pair_tiles' tiles or the given [T, 4] numpy tiles."""
    from repeatresolver_tpu_torch.ops import cuda_resolver as cv
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in arrays.items()}
    tables = t.pop("tables")
    t["tiles"] = (cv.pair_tiles(t["sel"], t["rowk"], t["row_off"])
                  if tiles is None else torch.from_numpy(
                      np.ascontiguousarray(tiles, np.int32)).to(dev))
    return cv.PairPass(**t), tables


def pair_pass_both(p, tables, dev, runs, log2=20, count_only=False):
    """Each of `runs` (pair_pass, pair_pass_plain) through a counting
    launch into a zeroed occurrence bitmap and an empty hash of 2^log2
    slots, then (unless count_only) a lookup launch on the given BITMAP
    decisions and the hash's decisions from _hash_decide. Returns a list
    of (occ, sorted keys, hash, marks) as numpy arrays (hash: PairHash)."""
    from repeatresolver_tpu_torch.ops import cuda_resolver as cv
    out = []
    for run in runs:
        occ = torch.zeros_like(tables)
        h = cv.PairHash.empty(log2, dev)
        marked = torch.zeros((p.nrows + 31) // 32, dtype=torch.int32,
                             device=dev)
        n0 = cv.pair_pass.launches
        run(p, tables, occ, h, marked, count=True)
        assert cv.pair_pass.launches - n0 == (
            run is cv.pair_pass and p.tiles.shape[0] > 0
            and torch.device(dev).type == "cuda")
        keys = torch.sort(h.keys[h.keys != 0]).values.cpu().numpy()
        marks = None
        if not count_only:
            assert not h.overflowed()
            _hash_decide(h)
            run(p, tables, occ, h, marked)
            marks = marked.cpu().numpy()
        out.append((occ.cpu().numpy(), keys, h, marks))
    return out


def _hash_decide(h):
    """Set the decision bit of about one key in 61 of h, as a function
    of the key alone, so that hashes built apart agree on it."""
    from repeatresolver_tpu_torch.ops import cuda_resolver as cv
    keys = h.keys
    h.bits.copy_(((keys != 0) & (cv.hash_slot(keys, 30) % 61 == 0))
                 .to(torch.uint8))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resolver_pairs_matches_plain(dev, seed):
    """Kernel H against pair_pass_plain on the same CUDA tensors, every
    table form (BITMAP, HASHED, HASHED_WIDE; one-word and many-word
    clusters; full and partial a-tiles): the counting launch's
    occurrence bitmap bit for bit and its hash keys as a set, then the
    lookup launch's packed marks bit for bit; one launch each."""
    from repeatresolver_tpu_torch.ops import cuda_resolver as cv
    p, tables = pair_pass_on(pair_pass_inputs(seed), dev)
    (occ_k, keys_k, _, marks_k), (occ_p, keys_p, _, marks_p) = \
        pair_pass_both(p, tables, dev, (cv.pair_pass, cv.pair_pass_plain))
    assert occ_k.any() and keys_k.size > 1000
    np.testing.assert_array_equal(occ_k, occ_p)
    np.testing.assert_array_equal(keys_k, keys_p)
    assert marks_k.any()
    np.testing.assert_array_equal(marks_k, marks_p)
    torch.cuda.synchronize()


@pytest.mark.parametrize("cut", ["whole", "fine"])
def test_resolver_pairs_any_tiling(dev, cut):
    """The same pass cut into other tiles, one a-tile against its whole
    b-range (past the kernel's staged NB rows) or against chunks of 37
    b-rows, and the tiles in reverse order: the kernel's occurrence
    bits, keys and marks equal the plain version's on pair_tiles."""
    from repeatresolver_tpu_torch.ops import cuda_resolver as cv
    arrays = pair_pass_inputs(7, clusters=((60, 2600), (40, 900),
                                           (100, 400)), span=60000)
    p0, tables = pair_pass_on(arrays, dev)
    want = pair_pass_both(p0, tables, dev, (cv.pair_pass_plain,))[0]
    t = p0.tiles.cpu().numpy()
    firsts = np.unique(t[:, :2], axis=0, return_index=True)[1]
    rows = []
    for i in firsts:
        k, a0, b0 = t[i, :3]
        end = int(arrays["row_off"][k + 1])
        step = end - b0 if cut == "whole" else 37
        rows += [(k, a0, c, min(c + step, end)) for c in range(b0, end,
                                                                step)]
    assert cut == "fine" or max(r[3] - r[2] for r in rows) > 1024
    p, _ = pair_pass_on(arrays, dev, np.array(rows[::-1]))
    got = pair_pass_both(p, tables, dev, (cv.pair_pass,))[0]
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
    torch.cuda.synchronize()


def test_resolver_pairs_hash_overflow(dev):
    """A hash of 16 slots holds 8 keys: both versions flag the overflow
    of a counting pass with more keys; the plain version stops at 8, and
    the kernel ends even when racing inserts fill every slot."""
    from repeatresolver_tpu_torch.ops import cuda_resolver as cv
    p, tables = pair_pass_on(pair_pass_inputs(4), dev)
    for run in (cv.pair_pass, cv.pair_pass_plain):
        *_, h, _ = pair_pass_both(p, tables, dev, (run,), log2=4,
                                  count_only=True)[0]
        assert h.overflowed()
        filled = int((h.keys != 0).sum())
        assert filled <= (16 if run is cv.pair_pass else 8)
        assert int(h.state[0]) == filled
    torch.cuda.synchronize()


def test_resolver_pairs_hash_fits_its_keys(dev):
    """Two million pairs of one cluster share a few thousand keys, in a
    hash whose half holds them with little room to spare: many lanes
    insert the same new key at once, and the counting launch must not
    flag an overflow (it counts the keys put in, not the attempts); the
    keys equal the plain version's, and so do the marks."""
    from repeatresolver_tpu_torch.ops import cuda_resolver as cv
    p, tables = pair_pass_on(pair_pass_inputs(
        5, clusters=((64, 2000),), span=400000, forms=(cv.HASHED,)), dev)
    n = pair_pass_both(p, tables, dev, (cv.pair_pass_plain,), log2=22,
                       count_only=True)[0][1].size
    log2 = (n - 1).bit_length() + 1       # the least half that holds n
    assert n > 1000
    got = pair_pass_both(p, tables, dev, (cv.pair_pass, cv.pair_pass_plain),
                         log2=log2)
    for _, keys, h, _ in got:
        assert not h.overflowed() and int(h.state[0]) == n == keys.size
    np.testing.assert_array_equal(got[0][1], got[1][1])
    assert got[0][3].any()
    np.testing.assert_array_equal(got[0][3], got[1][3])
    torch.cuda.synchronize()


def test_resolver_pairs_rejects_bad_input(dev):
    from repeatresolver_tpu_torch.ops import cuda_resolver as cv
    p, tables = pair_pass_on(pair_pass_inputs(3), dev)
    h = cv.PairHash.empty(10, dev)
    m = torch.zeros((p.nrows + 31) // 32, dtype=torch.int32, device=dev)
    occ = torch.zeros_like(tables)
    with pytest.raises(ValueError, match="marked"):
        cv.pair_pass(p, tables, occ, h, m.to(torch.uint8))
    with pytest.raises(ValueError, match="gidx"):
        cv.pair_pass(cv.PairPass(**{**vars(p), "gidx": p.gidx[:-1]}),
                     tables, occ, h, m)
    with pytest.raises(ValueError, match="tables"):
        cv.pair_pass(p, tables.cpu(), occ, h, m)
    with pytest.raises(ValueError, match="occ"):
        cv.pair_pass(p, tables, occ[:-1], h, m)
    with pytest.raises(ValueError, match="tiles"):
        cv.pair_pass(cv.PairPass(**{**vars(p), "tiles": p.tiles[:, :3]}),
                     tables, occ, h, m)
    with pytest.raises(ValueError, match="power of two"):
        cv.pair_pass(p, tables, occ, cv.PairHash(h.keys[:-1], h.bits[:-1],
                                                 h.state), m)
    bad = p.tab_off.clone()
    bad[0] += 1
    with pytest.raises(ValueError, match="BITMAP"):
        cv.pair_pass(cv.PairPass(**{**vars(p), "tab_off": bad}), tables,
                     occ, h, m)
