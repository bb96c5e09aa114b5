"""The resolver's card route, on CPU tensors, against the JAX package.

models/resolver.resolve_window(route="card") keeps a window's groups on
a device and runs there group_refinement's candidate statistics and
cliques (_cliques_card: exact int8 products, the mode gate, the host's
float64 significance on the distinct argument tuples only, a stable
sort for TheBestUpdater) and every cluster's relative_vars in one pass
(_relative_vars_card: kernel H on a CUDA device, its plain version
ops/cuda_resolver.pair_pass_plain on CPU tensors, as here). The
windows: 10 planted copies of about 30 rows over 300 columns, 3% noise,
made from a numpy seed; the "tree" layout leaves RelDrop clusters of
55-160 rows (past the 64-row word), the "merged" one a cluster of six
copies (166-192 rows). The pair pass runs with its tables in every
form: all in shared-memory bitmaps (the default switch,
cuda_resolver.SMEM_TABLE_BYTES), all hashed (the switch at 0, a small
first hash that must regrow), and mixed (the switch between the
window's table sizes). Every result is integer labels or lists, held
with tolerance 0; the significance values bit for bit. Kernel H's
plain version is also held to a brute-force count of its occurrence
bits, keys and marks on random inputs (tests/test_torch_cuda_kernels.
pair_pass_inputs, which the card's tests feed to the kernel), under
any tiling.
"""
import contextlib
import copy
import importlib.util
import os
from unittest import mock

import numpy as np
import pytest
import torch

from repeatresolver_tpu import config as C

LAYOUTS = {
    # copies sharing each split's 4 planted SNP columns
    "tree": [list(range(0, 5)), list(range(5, 10)), [4], [5, 6],
             [7, 8, 9], [7], [8]],
    "merged": [list(range(0, 6)), list(range(6, 10)), [6, 7], [8], [9],
               [8, 9]],
}


@contextlib.contextmanager
def _jax_host():
    """The JAX package's products on its host route (ops/devmm)."""
    from repeatresolver_tpu.ops import devmm as jdevmm
    saved = jdevmm._state.get("on")
    jdevmm._state["on"] = False
    try:
        yield
    finally:
        if saved is None:
            jdevmm._state.pop("on", None)
        else:
            jdevmm._state["on"] = saved


def _window(layout, seed, n_copies=10, cov=30, w=300, noise=0.03,
            labels=False):
    rng = np.random.default_rng(seed)
    tpl = rng.integers(0, 4, w)
    copies = np.tile(tpl, (n_copies, 1))
    cols = rng.permutation(w)
    c = 0
    for grp in LAYOUTS[layout]:
        for _ in range(4):
            copies[grp, cols[c]] = (tpl[cols[c]] + 1) % 4
            c += 1
    rows, copy_of = [], []
    for ci, cp in enumerate(copies):
        for _ in range(cov + int(rng.integers(-3, 4))):
            r = cp.copy()
            err = rng.random(w) < noise
            r[err] = rng.integers(0, 4, err.sum())
            rows.append(r)
            copy_of.append(ci)
    msa = np.array(rows, np.int8)
    return (msa, np.array(copy_of)) if labels else msa


@pytest.fixture(scope="module", params=[("tree", 0), ("merged", 2)],
                ids=["tree", "merged"])
def case(request):
    """(msa, maxcorrs, cfg, the JAX package's state at kmeans time)."""
    from repeatresolver_tpu.models import maxcorr
    from repeatresolver_tpu.models import resolver as jres
    layout, seed = request.param
    msa, copy_of = _window(layout, seed, labels=True)
    cov = 30
    mc = np.asarray(maxcorr.compute_maxcorrs(
        msa, maxcorr.MaxCorrConfig(mincov=cov)))
    cfg = C.ResolverConfig(cov=cov)
    with _jax_host():
        w = msa.shape[1]
        gd = jres.GroupData.from_window(jres.extract_window(msa, 0, w - 1))
        cutoff = cfg.resolved_cutoff(w)
        mck = mc.astype(np.float64).copy()
        ref = jres.group_refinement(gd, mck, cutoff, cfg.cov, cfg.maxclique,
                                    cutoff, cfg.min_clique_size)
        refine_dropoff = dict(ref.dropoff)   # RelDrop rewrites it
        ref_refined = copy.deepcopy(ref)
        u = jres.dropoff_subdivision(ref, cutoff, cfg.dropoffcutoff,
                                     cfg.sizecutoff, cfg.mingroup,
                                     msa.shape[0])
        jres.relative_dropoff_subdivision(gd, ref, u, cutoff,
                                          cfg.dropoffcutoff, cfg.sizecutoff,
                                          cfg.mingroup)
        number = jres.komprimierung(u)
        ks = [k for k in range(number)
              if int((u == k).sum()) > cfg.mingroup * 2]
        jax_out = jres.resolve_window(msa, mc.copy(), 0, w - 1, cfg)
    assert len(ks) >= 2
    return dict(msa=msa, mc=mc, cfg=cfg, gd=gd, cutoff=cutoff, mck=mck,
                ref_refined=ref_refined,
                ref=ref, refine_dropoff=refine_dropoff, u=u, ks=ks,
                jax_out=jax_out, copy_of=copy_of)


def _card(case):
    from repeatresolver_tpu_torch.models import resolver as pres
    gd = pres.GroupData(case["gd"].groups, case["gd"].coverage,
                        case["gd"].sizes, case["gd"].covcount)
    return gd, pres.CardGroups(gd, "cpu")


def _bitmap_table_bytes(case):
    """The bytes of each cluster size's table as a BITMAP, from a pass
    with every table in shared memory."""
    from repeatresolver_tpu_torch.models import resolver as pres
    from repeatresolver_tpu_torch.ops import cuda_resolver as cv
    _, card = _card(case)
    seen = []
    real = cv.pair_pass

    def spy(p, *args, **kw):
        seen.append(p)
        return real(p, *args, **kw)
    with mock.patch.object(cv, "SMEM_TABLE_BYTES", 1 << 30), \
            mock.patch.object(cv, "pair_pass", spy):
        pres._relative_vars_card(card, case["u"].copy(), case["ks"],
                                 case["ref"].maxcorrs, case["cutoff"],
                                 case["cfg"].mingroup, pres.SplitClock())
    p = seen[0]
    used = p.row_off[1:] > p.row_off[:-1]
    return sorted(set((p.tab_words[used] * 4).tolist()))


@contextlib.contextmanager
def _table_form(case, form):
    """The pair pass's switch for `form`: "bitmap" the default (every
    table of these windows fits), "hashed" 0 with a first hash of 16
    slots (it must regrow), "mixed" the smallest table's bytes (it alone
    stays a bitmap)."""
    from repeatresolver_tpu_torch.ops import cuda_resolver as cv
    if form == "bitmap":
        assert _bitmap_table_bytes(case)[-1] <= cv.SMEM_TABLE_BYTES
        patches = []
    elif form == "hashed":
        patches = [mock.patch.object(cv, "SMEM_TABLE_BYTES", 0),
                   mock.patch.object(cv, "HASH_LOG2_START", 4)]
    else:
        patches = [mock.patch.object(cv, "SMEM_TABLE_BYTES",
                                     _bitmap_table_bytes(case)[0])]
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        yield


def test_fixture_reaches_both_table_modes_and_word_boundary(case):
    """With the switch between its tables' sizes, the window's pass
    holds BITMAP and hashed tables at once and clusters past a 64-row
    word, and the host evaluates only the entries that occur."""
    from repeatresolver_tpu_torch.models import resolver as pres
    from repeatresolver_tpu_torch.ops import cuda_resolver as cv
    _, card = _card(case)
    clock = pres.SplitClock()
    assert len(_bitmap_table_bytes(case)) >= 2
    with _table_form(case, "mixed"):
        pres._relative_vars_card(card, case["u"].copy(), case["ks"],
                                 case["ref"].maxcorrs, case["cutoff"],
                                 case["cfg"].mingroup, clock)
    sizes = [int((case["u"] == k).sum()) for k in case["ks"]]
    c = clock.counts
    assert max(sizes) > 64
    assert 1 <= c["relvars_hashed_clusters"] < len(case["ks"])
    assert c["relvars_h_launches"] == 2
    assert c["relvars_hash_keys"] > 0 and c["relvars_bitmap_entries"] > 0
    assert c["relvars_tuples"] == c["relvars_hash_keys"] \
        + c["relvars_bitmap_entries"]
    assert c["relvars_tiles"] >= len(case["ks"])
    assert "relvars_hash_regrows" not in c
    assert cv.HASH_LOG2_START > 1


@pytest.mark.parametrize("form", ["bitmap", "hashed", "mixed"])
@pytest.mark.parametrize("batched", [False, True],
                         ids=["each_cluster", "all_clusters"])
def test_pair_pass_plain_matches_jax_relative_vars(case, batched, form):
    """The pair pass's plain version (through _relative_vars_card on CPU
    tensors), one cluster at a time and all at once, with its tables in
    each form, against the JAX package's relative_vars on every
    cluster."""
    from repeatresolver_tpu.models import resolver as jres
    from repeatresolver_tpu_torch.models import resolver as pres
    from repeatresolver_tpu_torch.ops import cuda_resolver as cv
    _, card = _card(case)
    u, ks, mcr = case["u"], case["ks"], case["ref"].maxcorrs
    mingroup, cutoff = case["cfg"].mingroup, case["cutoff"]
    with _jax_host():
        want = {k: jres.relative_vars(case["gd"], u, k, mcr, cutoff,
                                      mingroup) for k in ks}
    calls = cv.pair_pass.launches
    clocks = []
    with _table_form(case, form):
        if batched:
            clocks.append(pres.SplitClock())
            got = pres._relative_vars_card(card, u.copy(), ks, mcr, cutoff,
                                           mingroup, clocks[-1])
        else:
            got = {}
            for k in ks:
                clocks.append(pres.SplitClock())
                got.update(pres._relative_vars_card(
                    card, u.copy(), [k], mcr, cutoff, mingroup, clocks[-1]))
    assert cv.pair_pass.launches == calls     # CPU tensors: no kernel
    assert got == want
    assert any(want.values())
    hashed = sum(c.counts["relvars_hashed_clusters"] for c in clocks)
    assert (hashed == 0) == (form == "bitmap")
    if form == "hashed":
        assert all(c.counts.get("relvars_hash_regrows", 0) >= 1
                   for c in clocks)


def _kernel_tests():
    """tests/test_torch_cuda_kernels.py, loaded by path, for kernel H's
    random inputs (pair_pass_inputs, pair_pass_on, pair_pass_both)."""
    path = os.path.join(os.path.dirname(__file__),
                        "test_torch_cuda_kernels.py")
    spec = importlib.util.spec_from_file_location("_cuda_kernel_tests",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 1])
def test_pair_tiles_cover_every_pair_once(seed):
    """pair_tiles on random clusters (empty ones, one row, past TILE_A
    rows and past TILE_B b-rows): every pair (sel[b] >= sel[a] +
    ROW_GAP within a cluster) in exactly one tile, TILE_A a-rows and at
    most TILE_B b-rows a tile, an a-tile's chunks within one row of each
    other's length."""
    from repeatresolver_tpu_torch.ops import cuda_resolver as cv
    rng = np.random.default_rng(seed)
    nsel = [0, 1, 5, 127, 128, 129, 700, 2600, 40]
    sel, rowk = [], []
    for k, n in enumerate(nsel):
        sel.append(np.sort(rng.choice(n * int(rng.integers(2, 60)) + 1, n,
                                      replace=False)))
        rowk.append(np.full(n, k))
    sel_t = torch.from_numpy(np.concatenate(sel).astype(np.int32))
    rowk_t = torch.from_numpy(np.concatenate(rowk).astype(np.int32))
    row_off = torch.from_numpy(np.r_[0, np.cumsum(nsel)].astype(np.int32))
    tiles = cv.pair_tiles(sel_t, rowk_t, row_off).numpy()
    assert tiles.dtype == np.int32 and tiles.shape[1] == 4
    s = sel_t.numpy().astype(np.int64)
    seen = np.zeros((len(s), len(s)), np.int32)
    for k, a0, b0, b1 in tiles:
        hi = row_off[k + 1].item()
        assert row_off[k].item() <= a0 < hi and a0 < b1 <= hi
        assert 0 < b1 - b0 <= cv.TILE_B
        a1 = min(a0 + cv.TILE_A, hi)
        seen[a0:a1, b0:b1] += (s[None, b0:b1] >= s[a0:a1, None]
                               + cv.ROW_GAP)
    want = np.zeros_like(seen)
    for k in range(len(nsel)):
        lo, hi = row_off[k].item(), row_off[k + 1].item()
        want[lo:hi, lo:hi] = s[None, lo:hi] >= s[lo:hi, None] + cv.ROW_GAP
    np.testing.assert_array_equal(seen, want)
    assert want.sum() > 1000000
    for a in np.unique(tiles[:, 1]):
        lens = np.diff(tiles[tiles[:, 1] == a][:, 2:], axis=1)
        assert lens.max() - lens.min() <= 1


@pytest.mark.parametrize("seed", [0, 1])
def test_pair_pass_plain_counts_what_occurs(seed):
    """pair_pass_plain on random inputs in every table form (BITMAP,
    HASHED, HASHED_WIDE; one-word and many-word clusters) against a
    brute force over every pair in numpy: the occurrence bits are the
    BITMAP entries that occur, the hash keys the hashed ones, and the
    marks the rows of every pair whose decision bit is set."""
    from repeatresolver_tpu_torch.ops import cuda_resolver as cv
    kt = _kernel_tests()
    arrays = kt.pair_pass_inputs(seed)
    p, tables = kt.pair_pass_on(arrays, "cpu")
    occ, keys, h, marks = kt.pair_pass_both(p, tables, "cpu",
                                            (cv.pair_pass,))[0]
    a = {k: v.astype(np.int64) for k, v in arrays.items()}
    tab = a["tables"].astype(np.uint32)
    want_occ = np.zeros(len(tab), np.uint32)
    want_keys, hit_keys, hits = [], [], np.zeros(len(a["sel"]), bool)
    hkeys = h.keys.numpy()
    decided = set(hkeys[h.bits.numpy() != 0].tolist())
    for k in range(len(a["words"])):
        lo, hi = a["row_off"][k], a["row_off"][k + 1]
        n, w, d = hi - lo, a["words"][k], a["dims"][k]
        if n == 0:
            continue
        m = a["masks"][a["word_off"][k]:a["word_off"][k] + n * w]
        bits = np.unpackbits(m.view(np.uint8).reshape(n, -1), axis=1,
                             bitorder="little").astype(np.int64)
        s = bits @ bits.T                                 # [a, b]
        ia, ib = np.nonzero(a["sel"][None, lo:hi]
                            >= a["sel"][lo:hi, None] + cv.ROW_GAP)
        ss = s[ia, ib]
        ga, gb = a["gidx"][lo + ia], a["gidx"][lo + ib]
        if a["kflag"][k] == cv.BITMAP:
            rr, sw = cv.table_geometry(int(d))
            word = a["tab_off"][k] + ss * sw + gb * rr + (ga >> 5)
            np.bitwise_or.at(want_occ, word,
                             (np.uint32(1) << (ga & 31).astype(np.uint32)))
            hit = (tab[word] >> (ga & 31).astype(np.uint32)) & 1 == 1
        else:
            key = (ss * d + gb) * d + ga + a["hbase"][k] + 1
            want_keys.append(np.unique(key))
            hit = np.array([x in decided for x in key.tolist()], bool)
        hits[lo + ia[hit]] = True
        hits[lo + ib[hit]] = True
    np.testing.assert_array_equal(occ.view(np.uint32), want_occ)
    np.testing.assert_array_equal(keys, np.unique(np.concatenate(
        want_keys)))
    got = np.unpackbits(marks.view(np.uint8), bitorder="little")
    np.testing.assert_array_equal(got[:len(hits)].astype(bool), hits)
    assert not got[len(hits):].any() and hits.any() and not hits.all()


@pytest.mark.parametrize("cut", ["whole", "fine"])
def test_pair_pass_plain_any_tiling(cut):
    """The plain version on other tiles than pair_tiles' (an a-tile's
    whole b-range in one tile, or chunks of 37 b-rows, in reverse order)
    gives the same occurrence bits, keys and marks."""
    from repeatresolver_tpu_torch.ops import cuda_resolver as cv
    kt = _kernel_tests()
    arrays = kt.pair_pass_inputs(7, clusters=((60, 1300), (40, 300),
                                              (100, 200)), span=30000)
    p0, tables = kt.pair_pass_on(arrays, "cpu")
    want = kt.pair_pass_both(p0, tables, "cpu", (cv.pair_pass_plain,))[0]
    t = p0.tiles.numpy()
    rows = []
    for i in np.unique(t[:, :2], axis=0, return_index=True)[1]:
        k, a0, b0 = t[i, :3]
        end = int(arrays["row_off"][k + 1])
        step = end - b0 if cut == "whole" else 37
        rows += [(k, a0, c, min(c + step, end))
                 for c in range(b0, end, step)]
    assert cut == "fine" or max(r[3] - r[2] for r in rows) > cv.TILE_B
    p, _ = kt.pair_pass_on(arrays, "cpu", np.array(rows[::-1]))
    got = kt.pair_pass_both(p, tables, "cpu", (cv.pair_pass_plain,))[0]
    for x, y in zip(got, want):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
    assert want[3].any()


def test_relative_vars_before_kmeans_equal_sequential_loop(case):
    """kmeans(k) relabels only cluster k's rows, above u.max(): every
    relative_vars of a window taken before the first kmeans equals the
    JAX package's loop, which takes each after the kmeans before it;
    and kmeans_subdivision on the card route labels as the JAX one."""
    from repeatresolver_tpu.models import resolver as jres
    from repeatresolver_tpu_torch.models import resolver as pres
    gd, card = _card(case)
    ref, cutoff, mingroup = case["ref"], case["cutoff"], case["cfg"].mingroup
    u_seq = case["u"].copy()
    seq = {}
    with _jax_host():
        for k in case["ks"]:
            seq[k] = jres.relative_vars(case["gd"], u_seq, k, ref.maxcorrs,
                                        cutoff, mingroup)
            jres.kmeans(case["gd"], u_seq, k, seq[k], mingroup)
        jres.komprimierung(u_seq)
    u0 = case["u"].copy()
    upfront = pres._relative_vars_card(card, u0, case["ks"], ref.maxcorrs,
                                       cutoff, mingroup, pres.SplitClock())
    assert upfront == seq
    u_card = case["u"].copy()
    pres.kmeans_subdivision(gd, ref, u_card, cutoff, mingroup, "cpu",
                            card=card)
    np.testing.assert_array_equal(u_card, u_seq)


def _large_cluster(seed, size=1100, n_sel=1050, families=4, w=600):
    """One cluster of `size` rows (and 100 rows outside it) whose
    `n_sel` selected groups all have distinct popcounts, so that a dense
    pair table over (schnitt, gr_b, gr_a) would need size x n_sel^2
    entries (1.2e9 at the defaults). Each of `families` takes a random
    order of the rows and nests its groups along it (their pairs are
    significant); the last family's groups are independent random
    subsets. Returns
    (GroupData, u, maxcorrs, cutoff, mingroup)."""
    from repeatresolver_tpu_torch.models import resolver as pres
    rng = np.random.default_rng(seed)
    n, mingroup, cutoff = size + 100, 5, 4.0
    groups = np.zeros((5 * w, n), bool)
    sel = np.sort(rng.choice(5 * w, n_sel, replace=False))
    pops = rng.permutation(np.arange(mingroup, mingroup + n_sel))
    fam = rng.integers(0, families + 1, n_sel)
    orders = [rng.permutation(size) for _ in range(families)]
    for g, c, f in zip(sel, pops, fam):
        rows = (orders[f][:c] if f < families
                else rng.choice(size, c, replace=False))
        groups[g, rows] = True
    groups[:, size:] = rng.random((5 * w, 100)) < 0.5
    maxcorrs = np.zeros(5 * w)
    maxcorrs[sel] = cutoff + 1.0
    coverage = np.ones((w, n), bool)
    gd = pres.GroupData(groups, coverage, groups.sum(1).astype(np.int64),
                        coverage.sum(1).astype(np.int64))
    u = np.r_[np.zeros(size, np.int64), np.ones(100, np.int64)]
    return gd, u, maxcorrs, cutoff, mingroup


def test_pair_pass_large_cluster_matches_jax_relative_vars():
    """A cluster of 1,100 rows with 1,050 distinct popcounts: the hashed
    entries (half a million keys where a dense table would hold 1.2e9
    entries), grown from a hash too small for them, against the JAX
    package's relative_vars."""
    from repeatresolver_tpu.models import resolver as jres
    from repeatresolver_tpu_torch.models import resolver as pres
    from repeatresolver_tpu_torch.ops import cuda_resolver as cv
    gd, u, mc, cutoff, mingroup = _large_cluster(5)
    with _jax_host():
        want = jres.relative_vars(gd, u, 0, mc, cutoff, mingroup)
    clock = pres.SplitClock()
    start = cv.HASH_LOG2_START
    cv.HASH_LOG2_START = 12          # 2,048 keys before the first regrow
    try:
        got = pres._relative_vars_card(pres.CardGroups(gd, "cpu"), u, [0],
                                       mc, cutoff, mingroup, clock)
    finally:
        cv.HASH_LOG2_START = start
    assert got == {0: want}
    assert 0 < len(want) < 1050
    assert clock.counts["relvars_hash_regrows"] >= 1
    assert clock.counts["relvars_hash_keys"] > 1 << 11
    assert clock.counts["relvars_h_launches"] == 2 + clock.counts[
        "relvars_hash_regrows"]


RELDROP_STARTS = ("dropoff", "one_cluster", "copy_pairs", "copies")


def _reldrop_start(case, start):
    """A labelling for RelDrop to subdivide: the Dropoff subdivision,
    all rows in one cluster, pairs of planted copies, the copies."""
    if start == "dropoff":
        from repeatresolver_tpu.models import resolver as jres
        cfg = case["cfg"]
        return jres.dropoff_subdivision(
            copy.deepcopy(case["ref_refined"]), case["cutoff"],
            cfg.dropoffcutoff, cfg.sizecutoff, cfg.mingroup,
            case["msa"].shape[0])
    if start == "one_cluster":
        return np.zeros(case["msa"].shape[0], np.int64)
    div = 2 if start == "copy_pairs" else 1
    return (case["copy_of"] // div).astype(np.int64)


def test_card_dropoff_matches_jax(case):
    """The card route's Dropoff subdivision (its cluster loop in array
    operations) against the JAX package's dropoff_subdivision."""
    from repeatresolver_tpu.models import resolver as jres
    from repeatresolver_tpu_torch.models import resolver as pres
    cfg, n = case["cfg"], case["msa"].shape[0]
    args = (case["cutoff"], cfg.dropoffcutoff, cfg.sizecutoff, cfg.mingroup,
            n)
    want = jres.dropoff_subdivision(copy.deepcopy(case["ref_refined"]),
                                    *args)
    got = pres._dropoff_subdivision_vec(copy.deepcopy(case["ref_refined"]),
                                        *args)
    np.testing.assert_array_equal(got, want)
    assert want.max() >= 1


@pytest.mark.parametrize("seed", range(4))
def test_komprimierung_vec_matches_loop(seed):
    from repeatresolver_tpu.models import resolver as jres
    from repeatresolver_tpu_torch.models import resolver as pres
    rng = np.random.default_rng(seed)
    for _ in range(50):
        u = rng.integers(-1, rng.integers(1, 40), rng.integers(0, 400))
        a, b = u.copy(), u.copy()
        assert pres._komprimierung_vec(a) == jres.komprimierung(b)
        np.testing.assert_array_equal(a, b)


def test_card_reldrop_matches_jax(case):
    """RelDrop's (cluster, var) tests on the card (plain torch ops on
    CPU tensors) against the JAX package's loop, from four labellings:
    the labels and every ref.dropoff value it leaves, equal; at least
    one start splits a cluster."""
    from repeatresolver_tpu.models import resolver as jres
    from repeatresolver_tpu_torch.models import resolver as pres
    gd, card = _card(case)
    cfg, cutoff = case["cfg"], case["cutoff"]
    splits = 0
    for start in RELDROP_STARTS:
        u0 = _reldrop_start(case, start)
        want_u, want_ref = u0.copy(), copy.deepcopy(case["ref_refined"])
        with _jax_host():
            jres.relative_dropoff_subdivision(
                case["gd"], want_ref, want_u, cutoff, cfg.dropoffcutoff,
                cfg.sizecutoff, cfg.mingroup)
        got_u, got_ref = u0.copy(), copy.deepcopy(case["ref_refined"])
        pres.relative_dropoff_subdivision(
            gd, got_ref, got_u, cutoff, cfg.dropoffcutoff, cfg.sizecutoff,
            cfg.mingroup, card=card)
        np.testing.assert_array_equal(got_u, want_u, err_msg=start)
        assert got_ref.dropoff == want_ref.dropoff, start
        splits += int(got_u.max()) > int(pres.komprimierung(u0.copy())) - 1
    assert splits >= 1


def test_card_refinement_matches_jax(case):
    """Candidate statistics, cliques and the Refinement of the card
    route against the JAX package's group_refinement."""
    from repeatresolver_tpu_torch.models import resolver as pres
    gd, card = _card(case)
    cfg, cutoff = case["cfg"], case["cutoff"]
    clock = pres.SplitClock()
    got = pres.group_refinement(gd, case["mck"], cutoff, cfg.cov,
                                cfg.maxclique, cutoff, cfg.min_clique_size,
                                device="cpu", split=clock, card=card)
    want = case["ref"]
    np.testing.assert_array_equal(got.maxcorrs, want.maxcorrs)
    assert got.cliques == want.cliques
    assert got.sizes == want.sizes and got.cutoffs == want.cutoffs
    assert got.dropoff == case["refine_dropoff"]
    for name in ("c_groups", "c_coverage"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.keys() == b.keys()
        for i in a:
            np.testing.assert_array_equal(a[i], b[i], err_msg=f"{name} {i}")
    c = clock.counts
    assert 0 < c["refine_tuples"] <= c["refine_relevant"] \
        <= c["refine_candidates"]


@pytest.mark.parametrize("fast", [True, False], ids=["gated", "all"])
@pytest.mark.parametrize("n,seed", [(1, 0), (37, 1), (5000, 2),
                                    (40000, 3)])
def test_unique_tuple_significance_is_bitwise_the_direct_call(n, seed,
                                                              fast):
    """The significance of the distinct tuples (_unique_rows), gathered
    back, against the host route's direct call on the whole batch
    (shuffled, with repeats), bit for bit."""
    from repeatresolver_tpu_torch.models import resolver as pres
    from repeatresolver_tpu_torch.ops import hypergeom as hg
    rng = np.random.default_rng(seed)
    cov = rng.integers(20, 3200, n)
    gr1 = (cov * rng.random(n)).astype(np.int64)
    gr2 = (cov * rng.random(n)).astype(np.int64)
    s = np.minimum(gr1, gr2) - rng.integers(0, 6, n)
    s = np.maximum(s, (rng.random(n) < 0.2) * np.minimum(gr1, gr2) // 3)
    size1 = gr1 + rng.integers(0, 4, n)
    size2 = gr2 + rng.integers(0, 4, n)
    tup = np.stack([s, gr1, gr2, cov, size1, size2], 1).astype(np.int64)
    tup = tup[rng.integers(0, n, n)]                  # repeats, shuffled
    if fast:
        direct = hg.positive_significance_fast(*tup.T, cap_base=97.90)
        f = tup.T.astype(np.float64)
        mode = (f[1] + 1.0) * (f[2] + 1.0) / (f[3] + 2.0)
        rel = (f[0] > mode) & (f[0] >= 1) & (f[1] > 0) & (f[2] > 0)
    else:
        direct = hg.positive_significance(*tup.T, cap_base=97.90)
        rel = np.ones(n, bool)
    got = np.zeros(n)
    if rel.any():
        uq, inv = pres._unique_rows(torch.from_numpy(tup[rel]))
        assert len(np.unique(uq.numpy(), axis=0)) == len(uq)
        np.testing.assert_array_equal(uq.numpy()[inv.numpy()], tup[rel])
        got[rel] = pres._significance(uq.numpy(), fast)[inv.numpy()]
    np.testing.assert_array_equal(got.view(np.int64), direct.view(np.int64))


def test_resolve_window_card_route_matches_jax(case):
    """All three subdivisions of the card route (plain versions, CPU
    tensors) and of the host route against the JAX package's
    resolve_window, tolerance 0; the record's split and tallies."""
    from repeatresolver_tpu_torch.models import resolver as pres
    msa, mc, cfg = case["msa"], case["mc"], case["cfg"]
    w = msa.shape[1]
    pres.resolve_window.log = []
    card = pres.resolve_window(msa, mc.copy(), 0, w - 1, cfg, "cpu",
                               route="card")
    host = pres.resolve_window(msa, mc.copy(), 0, w - 1, cfg, "cpu")
    for out in (card, host):
        assert out.keys() == case["jax_out"].keys()
        for k in out:
            np.testing.assert_array_equal(out[k], case["jax_out"][k],
                                          err_msg=k)
    rc, rh = pres.resolve_window.log
    assert (rc["route"], rh["route"]) == ("card", "host")
    assert set(rc["split"]) == set(pres.SPLIT_PARTS)
    assert rc["relvars_h_launches"] >= 1 and rc["refine_tuples"] > 0
    assert "refine_tuples" not in rh and rh["relvars_pairs"] > 0


def test_resolve_route_choice(monkeypatch):
    from repeatresolver_tpu_torch.models import resolver as pres
    msa = _window("tree", 0)[:, :40]
    mc = np.zeros(40 * 5)
    with pytest.raises(ValueError, match="route"):
        pres.resolve_window(msa, mc, 0, 39, C.ResolverConfig(), "cpu",
                            route="gpu")
    pres.resolve_window.log = []
    pres.resolve_window(msa, mc, 0, 39, C.ResolverConfig(), "cpu")
    assert pres.resolve_window.log[-1]["route"] == "host"
