"""Kernels F and G's plain versions (ops/cuda_exact.py) and their routes,
against the JAX package's exact band on the CPU. Inputs are numpy arrays
from a seed (4-8 rows, 200-4,200 columns, bands 16 to 2,600); every
comparison is exact (tolerance 0: integer DP).

  * F's plain version: its packed codes, unpacked, and its final band
    and band start equal the JAX `banded_fill`'s (shifts past the band,
    rows of length 0 and 1, a row ending at the last column, padding
    columns, band 2,600);
  * G's plain version with the rebuild (`entry_and_backtrack`) equals
    the JAX `entry_and_backtrack` on those fills, and on random codes
    whose walks enter positions below their band (the lockstep walk's
    clamp to lane 0, where kernel B's walk would end);
  * a row with more inserts than MAX_INSERTS: the route lists them all,
    equal to the host native engine, where the torch exact band raises;
  * `block_dp`'s exact branch on CPU tensors runs the torch exact band
    (counted by `banded_fill.calls`), whatever the kernel;
  * the resident engine's device route for exact blocks (compaction on
    the device, the rows and histogram updated in place) equals its host
    route; on the CPU the engine keeps the host route, and each sweep's
    record splits its exact blocks and seconds by route.

The kernels themselves run on the card: tests/test_torch_cuda_kernels.py
(`-k exact`) and chip_smoke.py (phases 2 and 9).
"""
import ctypes

import numpy as np
import pytest
import torch
import torch.overrides
from repeatresolver_tpu.ops import banded_realign as jbr

from repeatresolver_tpu_torch.models import realigner as prt
from repeatresolver_tpu_torch.models import realigner_device as prd
from repeatresolver_tpu_torch.ops import banded_realign as pbr
from repeatresolver_tpu_torch.ops import cuda_exact as pce
from repeatresolver_tpu_torch.ops import staircase_realign as psr
from repeatresolver_tpu_torch.utils import native
from tests.test_realigner_device import make_msa
from tests.test_torch_cuda_kernels import (EXACT_CASES, exact_bounds,
                                           exact_inputs, insert_heavy_block)

torch.set_num_threads(2)
NAMES = ("rows", "best", "iy", "ib", "inn")


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, ref):
    """(rows, best, iy, ib, inn) equal; insert slots up to inn a row."""
    got = [np.asarray(g.numpy() if isinstance(g, torch.Tensor) else g)
           for g in got]
    ref = [np.asarray(r) for r in ref]
    for name, g, r in zip(NAMES, got, ref, strict=True):
        if name in ("iy", "ib"):
            for i, n in enumerate(ref[4]):
                np.testing.assert_array_equal(g[i, :n], r[i, :n],
                                              err_msg=f"{name} row {i}")
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)


_jax_fills: dict = {}


def _jax_fill(case):
    """The JAX fill of a case, once a module."""
    if case not in _jax_fills:
        *arrays, ncols = exact_inputs(*case)
        _jax_fills[case] = (arrays, ncols, jbr.banded_fill(
            *arrays, np.int32(ncols), bandwidth=case[-1]))
    return _jax_fills[case]


@pytest.mark.parametrize("case", EXACT_CASES)
def test_exact_fill_plain_matches_jax(case):
    (counts, rows, seqs, ways, lengths), ncols, jf = _jax_fill(case)
    w = case[-1]
    codes, band, anf = pce.exact_fill(T(counts), T(rows), T(seqs), T(ways),
                                      T(lengths), ncols, bandwidth=w)
    l = seqs.shape[1]
    assert codes.dtype == torch.int32 and codes.shape == (-(-l // 16),
                                                          len(lengths), w)
    np.testing.assert_array_equal(psr.unpack_codes(codes, l).numpy(),
                                  np.asarray(jf[0]))
    np.testing.assert_array_equal(band.numpy(), np.asarray(jf[1]))
    np.testing.assert_array_equal(anf.numpy(), np.asarray(jf[2]))
    # the positions past L in the last word are 0
    if l % 16:
        assert not (codes[-1] >> (2 * (l % 16))).any()
    # the jump rule ran: some step moved the band by more than its width
    assert (np.diff(np.maximum(0, ways - w // 2), axis=1) > w).any()


@pytest.mark.parametrize("case", EXACT_CASES)
def test_exact_walk_plain_matches_jax(case):
    (counts, rows, seqs, ways, lengths), ncols, jf = _jax_fill(case)
    w = case[-1]
    anf, eb = exact_bounds(ways, lengths, w)
    cpad = rows.shape[1]
    ref = jbr.entry_and_backtrack(*jf, seqs, anf, eb, lengths,
                                  np.int32(ncols), cpad=cpad, bandwidth=w)
    fill = pce.exact_fill(T(counts), T(rows), T(seqs), T(ways), T(lengths),
                          ncols, bandwidth=w)
    got = pce.entry_and_backtrack(*fill, T(seqs), T(anf), T(eb),
                                  T(lengths), ncols, cpad=cpad)
    _same(got, ref)
    assert got[2].shape == (len(lengths), pbr.MAX_INSERTS)
    assert (got[0].numpy()[:, :ncols] != rows[:, :ncols]).any()


def test_exact_band_past_the_clustered_cap_matches_jax():
    """Band 20,000, past the 16,384 lanes of kernel F's clustered layout
    (the card takes it in the wide layout), on a small block: the plain
    fill's codes, band and band start, and the walk with its rebuild,
    equal the JAX package's banded_fill and entry_and_backtrack."""
    case = (18, 3, 50000, 24, 20000)
    (counts, rows, seqs, ways, lengths), ncols, jf = _jax_fill(case)
    w = case[-1]
    assert w > pce.MAX_W and pce.fill_geometry(w).groups == 2
    fill = pce.exact_fill(T(counts), T(rows), T(seqs), T(ways), T(lengths),
                          ncols, bandwidth=w)
    l = seqs.shape[1]
    np.testing.assert_array_equal(psr.unpack_codes(fill[0], l).numpy(),
                                  np.asarray(jf[0]))
    np.testing.assert_array_equal(fill[1].numpy(), np.asarray(jf[1]))
    np.testing.assert_array_equal(fill[2].numpy(), np.asarray(jf[2]))
    anf, eb = exact_bounds(ways, lengths, w)
    cpad = rows.shape[1]
    ref = jbr.entry_and_backtrack(*jf, seqs, anf, eb, lengths,
                                  np.int32(ncols), cpad=cpad, bandwidth=w)
    got = pce.entry_and_backtrack(*fill, T(seqs), T(anf), T(eb),
                                  T(lengths), ncols, cpad=cpad)
    _same(got, ref)
    assert (got[0].numpy()[:, :ncols] != rows[:, :ncols]).any()


def _walk_case(seed):
    """Random codes [B, L, W] with nonzero lane-0 codes and band starts
    that stand still, so that diagonals from lane 0 leave the band."""
    rng = np.random.default_rng(seed)
    b, l, w = 6, 90, 12
    c = 160
    codes = rng.choice(3, size=(b, l, w), p=[.5, .3, .2]).astype(np.uint8)
    codes[:, :, 0] = rng.choice([1, 2], size=(b, l), p=[.8, .2])
    anf = np.minimum(np.cumsum(rng.choice([0, 0, 1, 2, 7], (b, l)), 1),
                     c - 1).astype(np.int32)
    lengths = rng.integers(1, l + 1, b).astype(np.int32)
    lengths[0] = 0
    band = rng.integers(0, 40, (b, w)).astype(np.int32)
    fanf = anf[np.arange(b), np.maximum(lengths - 1, 0)]
    eb = (fanf - rng.integers(0, 3, b)).astype(np.int32)
    seqs = rng.integers(0, 4, (b, l)).astype(np.int8)
    return codes, band, fanf, seqs, anf, eb, lengths, c


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_walk_below_the_band_matches_jax(seed):
    """Walks that enter a position below its band read lane 0 there, as
    the JAX lockstep walk clamps them (kernel B's walk would end)."""
    codes, band, fanf, seqs, anf, eb, lengths, c = _walk_case(seed)
    cpad = c + 5
    ref = jbr.entry_and_backtrack(codes, band, fanf, seqs, anf, eb, lengths,
                                  np.int32(c), cpad=cpad,
                                  bandwidth=codes.shape[2])
    packed = pce.pack_codes(T(codes))
    got = pce.entry_and_backtrack(packed, T(band), T(fanf), T(seqs),
                                  T(anf), T(eb), T(lengths), c, cpad=cpad)
    _same(got, ref)
    moves, _, _ = pce.exact_walk(packed, T(band), T(fanf), T(eb), T(anf),
                                 T(lengths), c, cpad=cpad)
    m = moves.permute(1, 0, 2).reshape(len(lengths), -1).numpy()
    m = m[:, :codes.shape[1]]
    assert ((m >> 2) < anf)[m >= 0].any(), "no walk left its band"


def test_exact_band_lists_inserts_past_max_inserts():
    """A row with more inserts than MAX_INSERTS: F and G's route lists
    every one, equal to the host native engine; the torch exact band's
    lists hold MAX_INSERTS, so its block is refused."""
    msa, order = insert_heavy_block()
    w = 64
    counts = prt.symbol_counts(msa).astype(np.int32)
    rows = msa[order]
    seqs, ways, lengths = prt.compact_rows(rows)
    anf, eb = exact_bounds(ways, lengths, w)
    ncols = msa.shape[1]
    ref = prt.realign_block_native(native, counts, rows, seqs, ways,
                                   lengths, w)
    assert ref[4].max() > pbr.MAX_INSERTS
    fill = pce.exact_fill(T(counts), T(rows), T(seqs), T(ways), T(lengths),
                          ncols, bandwidth=w)
    got = pce.entry_and_backtrack(*fill, T(seqs), T(anf), T(eb),
                                  T(lengths), ncols, cpad=ncols)
    _same(got, ref)
    assert got[2].shape[1] == ref[4].max()
    lock = prt.block_dp(*(T(a) for a in (counts, rows, seqs, ways, lengths,
                                         anf, eb)), ncols, bandwidth=w,
                        chunk=256, widen=1, staircase=False, kernel="cuda")
    with pytest.raises(RuntimeError, match="insert buffer overflow"):
        prt._check_inserts(lock[4].numpy(), lock[2].shape[1])


def test_block_dp_exact_on_cpu_runs_the_plain_band():
    """block_dp's exact branch on CPU tensors is the torch exact band,
    counted, whatever the kernel, and equals F and G's plain route."""
    case = EXACT_CASES[1]
    *arrays, ncols = exact_inputs(*case)
    w = case[-1]
    anf, eb = exact_bounds(arrays[3], arrays[4], w)
    args = [T(a) for a in (*arrays, anf, eb)]
    cpad = arrays[1].shape[1]
    f0, l0 = pbr.banded_fill.calls, pce.exact_fill.launches
    out = prt.block_dp(*args, ncols, bandwidth=w, chunk=256, widen=1,
                       staircase=False, kernel="cuda")
    assert pbr.banded_fill.calls == f0 + 1
    assert pce.exact_fill.launches == l0
    fill = pce.exact_fill(*args[:5], ncols, bandwidth=w)
    ref = pce.entry_and_backtrack(*fill, args[2], args[5], args[6],
                                  args[4], ncols, cpad=cpad)
    _same(out, [r.numpy() for r in ref])


def test_exact_wrappers_reject_bad_input():
    *arrays, ncols = exact_inputs(1, 4, 200, 64, 16)
    counts, rows, seqs, ways, lengths = (T(a) for a in arrays)
    with pytest.raises(ValueError, match="ways"):
        pce.exact_fill(counts, rows, seqs, ways.long(), lengths, ncols,
                       bandwidth=16)
    with pytest.raises(ValueError, match="inconsistent"):
        pce.exact_fill(counts[:10], rows, seqs, ways, lengths, ncols,
                       bandwidth=16)
    assert pce.MAX_W == 16384
    with pytest.raises(ValueError, match="unsupported band"):
        pce.exact_fill(counts, rows, seqs, ways, lengths, ncols,
                       bandwidth=0)
    codes, band, anf = pce.exact_fill(counts, rows, seqs, ways, lengths,
                                      ncols, bandwidth=16)
    with pytest.raises(ValueError, match="inconsistent"):
        pce.exact_walk(codes, band, anf, lengths,
                       ways[:, :16].contiguous(), lengths, ncols,
                       cpad=rows.shape[1])
    with pytest.raises(ValueError, match="ncols"):
        pce.exact_walk(codes, band, anf, lengths, ways, lengths, ncols,
                       cpad=ncols - 1)


def _resident(device="cpu"):
    eng = prd.DeviceResidentRealigner(
        make_msa(3, rows=16, tlen=240), bandwidth=96, block_rows=8,
        chunk=32, device=device)
    eng.ent_al_gapper()
    eng._ensure_order()
    return eng


def test_resident_device_route_matches_host_route():
    """The device route of an exact block (compaction on the device, F
    and G's place taken here by the torch exact band of CPU tensors,
    rows and histogram written in place) leaves the same MSA,
    histogram and inserts as the host route."""
    a, b = _resident(), _resident()
    for bid in range(2):
        rows = a._ord_host[bid * 8:(bid + 1) * 8]
        iy_d, ib_d, inn_d = a._exact_block_device(rows)
        route, iy_h, ib_h, inn_h = b._exact_block_host(rows)
        assert route == "native"
        np.testing.assert_array_equal(inn_d, inn_h)
        for i, n in enumerate(inn_h):
            np.testing.assert_array_equal(iy_d[i, :n], iy_h[i, :n])
            np.testing.assert_array_equal(ib_d[i, :n], ib_h[i, :n])
        assert torch.equal(a._msa_d, b._msa_d)
        assert torch.equal(a._counts_d, b._counts_d)
    assert inn_h.sum() > 0


def test_resident_sweep_log_splits_exact_blocks(monkeypatch):
    """Each resident sweep's record: its seconds, and its exact blocks
    and their seconds by route; on the CPU every exact block takes the
    host native engine."""
    cls = prd.DeviceResidentRealigner
    monkeypatch.setattr(cls, "exact_blocks_run",
                        dict.fromkeys(cls.ROUTES, 0))
    monkeypatch.setattr(cls, "exact_block_s",
                        dict.fromkeys(cls.ROUTES, 0.0))
    monkeypatch.setattr(cls, "sweep_log", [])
    eng = prd.DeviceResidentRealigner(
        make_msa(3, rows=16, tlen=240), bandwidth=96, block_rows=8,
        chunk=32, device="cpu")
    eng._maxf = 1                        # every overflowing block exact
    eng.ent_al_gapper()
    for _ in range(2):
        eng.sweep()
    log = cls.sweep_log
    assert len(log) == 2
    assert sum(r["exact_blocks"]["native"] for r in log) \
        == cls.exact_blocks_run["native"] > 0
    assert cls.exact_blocks_run["cuda"] == cls.exact_blocks_run["torch"] \
        == 0
    for r in log:
        assert 0 <= r["exact_block_s"]["native"] <= r["s"]


# ---- the card's routes for exact blocks, on the CPU: F and G's
# libraries stood in for, tensors that claim the card

class _CardTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_card(dev):
    return dev is not None and torch.device(dev).type == "cuda"


class _FakeCard(torch.overrides.TorchFunctionMode):
    """Tensors made or moved "to the card" stay on the CPU as
    _CardTyped, so the card's routes run here up to the kernels."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        wrap = _on_card(kwargs.get("device"))
        if wrap:
            kwargs["device"] = "cpu"
        if func is torch.Tensor.to:
            rest = [a for a in args[1:]
                    if not (isinstance(a, (str, torch.device))
                            and _on_card(a))]
            wrap = wrap or len(rest) != len(args) - 1
            args = args[:1] + tuple(rest)
            if not rest and not kwargs:
                out = args[0]
                return out if isinstance(out, _CardTyped) \
                    else out.as_subclass(_CardTyped)
        out = func(*args, **kwargs)
        if wrap and isinstance(out, torch.Tensor) \
                and not isinstance(out, _CardTyped):
            out = out.as_subclass(_CardTyped)
        return out


class _FakeExactKernels:
    """Stands in for kernels F and G's libraries: records each launch's
    integer arguments and leaves defined outputs (codes and band 0, every
    move record -1: no inserts)."""

    def __init__(self):
        self.launches = []

    def exact_fill_launch(self, *a):
        b, c, l, ncols, w, cs, threads, cps = a[9:17]
        self.launches.append(("fill", (b, c, l, ncols, w, cs, threads, cps,
                                       a[18])))
        for p, n in ((a[6], -(-l // 16) * b * w), (a[7], b * w), (a[8], b)):
            ctypes.memset(p.value, 0, 4 * n)
        return 0

    def exact_walk_launch(self, *a):
        b, w, nw, l, ncols, cpad = a[9:15]
        self.launches.append(("walk", (b, w, nw, l, ncols, cpad)))
        ctypes.memset(a[6].value, 0xff, 4 * nw * b * 16)
        ctypes.memset(a[7].value, 0, 4 * b)
        ctypes.memset(a[8].value, 0, 4 * b)
        return 0

    def exact_fill_error_string(self, err):
        return b"stand-in error"

    exact_walk_error_string = exact_fill_error_string


AMPLE = 1 << 40


@pytest.fixture
def fake_card(monkeypatch):
    from repeatresolver_tpu_torch.ops import _build
    fake = _FakeExactKernels()
    monkeypatch.setattr(_build, "load", lambda name: fake)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: ctypes.c_void_p())
    # the memory budget of a card with ample memory (no card to ask)
    monkeypatch.setenv("RR_DEVICE_HBM_BUDGET", str(AMPLE))

    def plain(*a, **k):
        raise AssertionError("the torch exact band ran on the card route")
    monkeypatch.setattr(pbr, "banded_fill", plain)
    with _FakeCard():
        yield fake


def _block(w, seed=3):
    """A block of a small MSA: (arrays as numpy, the MSA width)."""
    msa = make_msa(seed, rows=8, tlen=240)
    counts = prt.symbol_counts(msa).astype(np.int32)
    seqs, ways, lengths = prt.compact_rows(msa)
    anf, eb = exact_bounds(ways, lengths, w)
    return (counts, msa, seqs, ways, lengths, anf, eb), msa.shape[1]


def _card(arrays):
    return [T(a).as_subclass(_CardTyped) for a in arrays]


def test_block_dp_card_route_by_band(fake_card, monkeypatch):
    """block_dp's exact branch on the card: band 4,200 (past kernel A's
    4,096 lanes) and the clustered layout's cap launch F and G (four and
    eight CTAs a row); bands 16,392 and 32,768 launch them in the wide
    layout (eight CTAs a row, two groups of 2,048 lanes a CTA). A band
    whose one row's codes pass the device memory budget raises
    ValueError and leaves the card for no other engine."""
    for w, cs, groups in ((4200, 4, 0), (pce.MAX_W, 8, 0),
                          (pce.MAX_W + 8, 8, 2), (2 * pce.MAX_W, 8, 2)):
        fake_card.launches.clear()
        arrays, c = _block(w)
        out = prt.block_dp(*_card(arrays), c, bandwidth=w, chunk=256,
                           widen=1, staircase=False, kernel="cuda")
        assert [k for k, _ in fake_card.launches] == ["fill", "walk"]
        # band, CTAs a row, the wide layout's groups
        launch = fake_card.launches[0][1]
        assert (launch[4], launch[5], launch[8]) == (w, cs, groups)
        assert out[0].shape == arrays[1].shape
    fake_card.launches.clear()
    w = pce.MAX_W + 8
    arrays, c = _block(w)
    monkeypatch.setenv("RR_DEVICE_HBM_BUDGET",
                       str(pce.codes_bytes(arrays[2].shape[1], w) - 1))
    with pytest.raises(ValueError, match="device memory budget"):
        prt.block_dp(*_card(arrays), c, bandwidth=w, chunk=256, widen=1,
                     staircase=False, kernel="cuda")
    assert fake_card.launches == []


def _resident_on_card(w):
    """A resident engine at band w whose tensors claim the card."""
    eng = prd.DeviceResidentRealigner(make_msa(3, rows=16, tlen=240),
                                      bandwidth=w, block_rows=8, chunk=32,
                                      device="cpu")
    eng.ent_al_gapper()
    eng._ensure_order()
    eng._msa_d = eng._msa_d.as_subclass(_CardTyped)
    eng._counts_d = eng._counts_d.as_subclass(_CardTyped)
    eng.device = torch.device("cuda", 0)
    return eng


def test_resident_card_route_by_band(fake_card, monkeypatch):
    """The resident engine's exact blocks on the card: bands 4,200 and
    16,392 run on F and G (route cuda; the wide layout at 16,392); under
    a memory budget that one row's codes pass, the block raises and no
    other engine runs it, and engines made on the card refuse the band.
    On the CPU the band runs on the host native engine (route native,
    counted) and equals it."""
    cls = prd.DeviceResidentRealigner
    monkeypatch.setattr(cls, "exact_blocks_run",
                        dict.fromkeys(cls.ROUTES, 0))
    monkeypatch.setattr(cls, "exact_block_s",
                        dict.fromkeys(cls.ROUTES, 0.0))
    w = pce.MAX_W + 8
    for n, band in enumerate((4200, w)):
        eng = _resident_on_card(band)
        eng._exact_block(eng._ord_host[:8], [])
        assert cls.exact_blocks_run["cuda"] == n + 1
        assert fake_card.launches[2 * n][1][4] == band
    assert fake_card.launches[2][1][8] == 2      # the wide layout's groups
    msa = make_msa(3, rows=16, tlen=240)
    longest = int(prt.row_lengths(msa).max())
    monkeypatch.setenv("RR_DEVICE_HBM_BUDGET",
                       str(pce.codes_bytes(longest, w) - 1))
    with pytest.raises(ValueError, match="device memory budget"):
        eng._exact_block(eng._ord_host[:8], [])
    assert len(fake_card.launches) == 4
    assert cls.exact_blocks_run == {"cuda": 2, "native": 0, "torch": 0}
    # "cuda" resolves without a card
    monkeypatch.setattr(prd, "resolve_device", torch.device)
    monkeypatch.setattr(prt, "resolve_device", torch.device)
    with pytest.raises(ValueError, match="device memory budget"):
        cls(msa, bandwidth=w, block_rows=8, device="cuda")
    for mode, kernel in (("staircase", "cuda"), ("exact", "torch"),
                         ("exact", "cuda")):
        with pytest.raises(ValueError, match="device memory budget"):
            prt.BatchedRealigner(msa, bandwidth=w, block_rows=8, mode=mode,
                                 kernel=kernel, device="cuda")
    monkeypatch.setenv("RR_DEVICE_HBM_BUDGET", str(AMPLE))
    cls(msa, bandwidth=w, block_rows=8, device="cuda")
    prt.BatchedRealigner(msa, bandwidth=w, block_rows=8, mode="exact",
                         kernel="cuda", device="cuda")
    cls.exact_blocks_run["cuda"] = 0
    eng = cls(msa, bandwidth=w, block_rows=8, chunk=32, device="cpu")
    eng.ent_al_gapper()
    eng._ensure_order()
    rows = eng._ord_host[:8]
    c = eng._ncols
    before = eng._msa_d[:, :c].numpy().copy()
    counts = eng._counts_d[:c].numpy().copy()
    pending = []
    eng._exact_block(rows, pending)
    assert cls.exact_blocks_run == {"cuda": 0, "native": 1, "torch": 0}
    seqs, ways, lengths = prt.compact_rows(before[rows])
    ref = prt.realign_block_native(native, counts, before[rows], seqs, ways,
                                   lengths, w)
    np.testing.assert_array_equal(eng._msa_d[rows, :c].numpy(), ref[0])
    assert len(pending) == int(ref[4].sum())


def test_exact_insert_bound_on_kernel_b_route():
    """A row of exactly MAX_INSERTS inserts through block_dp's staircase
    route (kernel B's rebuild, cuda_backtrack.moves_to_outputs, here its
    plain version): complete, equal to the host native engine, and
    _check_inserts takes it (the JAX package raises at >=)."""
    msa, order = insert_heavy_block(n=pbr.MAX_INSERTS + 1)
    w, chunk = 64, 32
    counts = prt.symbol_counts(msa).astype(np.int32)
    rows = msa[order]
    seqs, ways, lengths = prt.compact_rows(rows)
    widen = -(-prt.chunk_drift(ways, chunk) // chunk) + 1
    anf, eb = prt.band_starts(ways, lengths, w, chunk, True)
    ref = prt.realign_block_native(native, counts, rows, seqs, ways,
                                   lengths, w)
    assert ref[4].max() == pbr.MAX_INSERTS
    out = prt.block_dp(*(T(a) for a in (counts, rows, seqs, ways, lengths,
                                        anf, eb)), msa.shape[1],
                       bandwidth=w, chunk=chunk, widen=widen, staircase=True,
                       kernel="cuda")
    assert out[2].shape[1] == pbr.MAX_INSERTS
    prt._check_inserts(out[4].numpy(), out[2].shape[1])
    _same([t.numpy() for t in out], ref)
