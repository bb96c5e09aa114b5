"""Realign's block 1 on the card (models/realigner.py::BatchedRealigner.
_sweep_serial_card): the reference's serial Gauss-Seidel sweep a row at
a time through kernels F and G, over a column store held on the device.
Here its tensors are CPU tensors, where F and G run their plain versions
(ops/cuda_exact.py: the torch exact band), or tensors of a stood-in card
whose F and G libraries compute those plain versions. Inputs are numpy
arrays from a seed; every comparison is exact (integer DP, byte-equal
MSAs and histograms), against the port's host serial sweep
(`_sweep_serial_indirect` on the native engine) and the JAX package's
block-1 sweep (its BatchedRealigner, mode "exact", kernel "native").

  * 1 and 2 sweeps at bands 96 and 800;
  * a store with little slack (0 and 1 spare columns), so that its free
    slots run out and it compacts and regrows;
  * rows without bases (all ' ', and '-' that become ' ');
  * an insert at the MSA's last gap, whose fill reads the last column,
    beside rows that end early (their fill is ' ');
  * the `rows=` hook: the first rows of a sweep equal on both routes;
  * the anneal 16 -> 4 -> 1 on the stood-in card through
    realign_batched: score log and final MSA equal the JAX package's,
    every sweep on the card's route; realign_batched(block_rows=1) on a
    CUDA device takes the card's sweep; a failing kernel raises, and no
    host engine runs instead.

The kernels themselves run on the card: tests/test_torch_cuda_kernels.py
(`-k serial`) and chip_smoke.py (phases 4-6).
"""
import ctypes

import numpy as np
import pytest
import torch
from repeatresolver_tpu.config import RealignerConfig as JCfg
from repeatresolver_tpu.models import realigner as jr

from repeatresolver_tpu_torch.config import RealignerConfig
from repeatresolver_tpu_torch.models import realigner as prt
from repeatresolver_tpu_torch.models import realigner_device as prd
from repeatresolver_tpu_torch.ops import _build
from repeatresolver_tpu_torch.ops import cuda_exact as pce
from tests.test_realigner_device import make_msa
from tests.test_torch_exact_kernels import AMPLE, _FakeCard

torch.set_num_threads(2)
Engine = prt.BatchedRealigner


@pytest.fixture(autouse=True)
def counts_at_zero(monkeypatch):
    for name, keys in (("host_sweeps_by_route", None),
                       ("host_sweep_s_by_route", None),
                       ("card_tail_split", Engine.CARD_SPLIT),
                       ("card_serial_split", Engine.SERIAL_SPLIT)):
        monkeypatch.setattr(Engine, name, {} if keys is None
                            else dict.fromkeys(keys, 0))


def _engines(msa, w):
    """The card's engine on CPU tensors, the port's host native engine
    and the JAX package's, all at block 1 over the same MSA."""
    card = Engine(msa.copy(), bandwidth=w, block_rows=1, mode="exact",
                  kernel="cuda", device="cpu")
    host = Engine(msa.copy(), bandwidth=w, block_rows=1, mode="exact",
                  kernel="native", device="cpu")
    jax = jr.BatchedRealigner(msa.copy(), bandwidth=w, block_rows=1,
                              mode="exact", kernel="native")
    return card, host, jax


def _same(card, *others):
    for o in others:
        np.testing.assert_array_equal(card.msa, o.msa)
        np.testing.assert_array_equal(card.counts, o.counts)
    prt.validate_counts(card.msa, card.counts)


@pytest.mark.parametrize("w,rows,tlen", [(96, 36, 260), (800, 18, 900)])
@pytest.mark.parametrize("sweeps", [1, 2])
def test_serial_card_matches_host_and_jax(w, rows, tlen, sweeps):
    """After each sweep the card's route equals the port's host serial
    sweep and the JAX package's block-1 sweep; the split counts the
    rows, and one host read a row with bases (the walk's insert lists
    are sized by the row's bases, so the wrapper reads nothing)."""
    msa = make_msa(11, rows=rows, tlen=tlen)
    engines = _engines(msa, w)
    for e in engines:
        e.ent_al_gapper()
    for _ in range(sweeps):
        for e in engines:
            e.sweep()
        _same(*engines)
    split = Engine.card_serial_split
    assert split["sweeps"] == sweeps and split["rows"] == sweeps * rows
    assert split["host_reads"] == sweeps * int(
        (prt.row_lengths(msa) > 0).sum())
    assert split["splices"] > 0 and split["regrows"] == 0
    assert Engine.host_sweeps_by_route == {"cuda": {1: sweeps},
                                           "native": {1: sweeps}}


@pytest.mark.parametrize("slack", [0, 1])
def test_serial_card_regrows(slack):
    """A store with `slack` spare columns runs out of free slots: it
    compacts and regrows by the host sweep's rule, and the sweeps equal
    the host's and the JAX package's."""
    msa = make_msa(5, rows=24, tlen=240)
    card, host, jax = _engines(msa, 96)
    for _ in range(2):
        card._sweep_serial_card(slack=slack)
        host.sweep()
        jax.sweep()
        _same(card, host, jax)
    split = Engine.card_serial_split
    assert split["regrows"] >= 1 and split["splices"] >= split["regrows"]


def test_serial_card_rows_without_bases():
    """A row of ' ' only and a row of '-' and ' ' only stay without a
    DP and become all ' '; the columns that only they touched empty and
    drop."""
    msa = make_msa(7, rows=20, tlen=240)
    msa[3] = 5
    msa[8] = 5
    msa[8, 40:90:3] = 4
    card, host, jax = _engines(msa, 96)
    for _ in range(2):
        for e in (card, host, jax):
            e.sweep()
        _same(card, host, jax)
        assert (card.msa[3] == 5).all() and (card.msa[8] == 5).all()


def test_serial_card_insert_at_the_last_gap():
    """A row whose base belongs between the last two columns inserts a
    column at the MSA's last gap (the exact band inserts only at
    0 < y < C-1); its fill reads the last column, where two rows that end
    early hold ' '."""
    rng = np.random.default_rng(2)
    c = 60
    tpl = rng.integers(0, 4, c).astype(np.int8)
    msa = np.tile(tpl, (8, 1))
    x = (tpl[c - 2] + 1) % 4
    if x == tpl[c - 1]:
        x = (x + 1) % 4
    msa[2] = np.concatenate([tpl[1:c - 1], [x], tpl[c - 1:]])
    msa[5:7, c - 3:] = 5
    counts = prt.symbol_counts(msa).astype(np.int32)
    seqs, ways, lengths = prt.compact_rows(msa[2:3])
    dp = prt.realign_block_native(prt._native(), counts, msa[2:3], seqs,
                                  ways, lengths, 96)
    assert dp[4][0] == 1 and dp[2][0, 0] == c - 2
    card, host, jax = _engines(msa, 96)
    for e in (card, host, jax):
        e.sweep()
    _same(card, host, jax)
    assert card.msa.shape[1] == c + 1
    assert card.msa[2, c - 1] == x and (card.msa[5:7, c - 1] == 5).all()


@pytest.mark.parametrize("rows", [1, 5, 40])
def test_serial_card_rows_hook(rows):
    """sweep(rows=n) ends the serial sweep after its first n rows, on
    both routes alike (the check that paper_card and chip_smoke.py make
    on the card); other block sizes refuse the hook."""
    msa = make_msa(13, rows=24, tlen=260)
    card, host, _ = _engines(msa, 96)
    card.sweep(rows=rows)
    host.sweep(rows=rows)
    _same(card, host)
    assert Engine.card_serial_split["rows"] == min(rows, 24)
    host.block_rows = 4
    with pytest.raises(ValueError, match="rows="):
        host.sweep(rows=2)


# ---- the stood-in card: tensors that claim the card stay on the CPU, and
# kernels F and G's libraries compute their plain versions

def _view(p, dtype, shape):
    n = int(np.prod(shape))
    buf = (ctypes.c_byte * (n * np.dtype(dtype).itemsize)).from_address(
        p.value)
    return torch.from_numpy(np.frombuffer(buf, dtype).reshape(shape))


class _PlainExactKernels:
    """Kernels F and G's libraries on the stood-in card: each launch runs
    the plain version on the launch's buffers and counts itself."""

    def __init__(self):
        self.launches = {"fill": 0, "walk": 0}
        self.fail = False

    def exact_fill_launch(self, *a):
        b, c, l, ncols, w = a[9:14]
        if self.fail:
            return 700
        counts, rows, seqs, ways, lengths = (
            _view(a[0], np.int32, (c, 6)), _view(a[1], np.int8, (b, c)),
            _view(a[2], np.int8, (b, l)), _view(a[3], np.int32, (b, l)),
            _view(a[4], np.int32, (b,)))
        out = pce.exact_fill_plain(counts, rows, seqs, ways, lengths, ncols,
                                   bandwidth=w)
        for p, t in zip(a[6:9], out):
            _view(p, np.int32, tuple(t.shape)).copy_(t)
        self.launches["fill"] += 1
        return 0

    def exact_walk_launch(self, *a):
        b, w, nw, l, ncols, cpad = a[9:15]
        i32 = np.int32
        out = pce.exact_walk_plain(
            _view(a[0], i32, (nw, b, w)), _view(a[1], i32, (b, w)),
            _view(a[2], i32, (b,)), _view(a[3], i32, (b,)),
            _view(a[4], i32, (b, l)), _view(a[5], i32, (b,)), ncols,
            cpad=cpad)
        for p, t in zip(a[6:9], out):
            _view(p, i32, tuple(t.shape)).copy_(t)
        self.launches["walk"] += 1
        return 0

    def exact_fill_error_string(self, err):
        return b"stand-in error"

    exact_walk_error_string = exact_fill_error_string


@pytest.fixture
def plain_card(monkeypatch):
    """A stood-in card on which "cuda" resolves, syncs are no-ops and F
    and G compute their plain versions."""
    lib = _PlainExactKernels()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: ctypes.c_void_p())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(prd, "resolve_device", torch.device)
    monkeypatch.setattr(prt, "resolve_device", torch.device)
    monkeypatch.setenv("RR_DEVICE_HBM_BUDGET", str(AMPLE))
    monkeypatch.setenv("RR_FLUSH_CAP", str(1 << 30))
    monkeypatch.setattr(pce.exact_fill, "launches", 0)
    with _FakeCard():
        yield lib


def test_anneal_on_the_stood_in_card_matches_jax(plain_card):
    """The anneal's tail 16 -> 4 -> 1 through realign_batched on the
    stood-in card (every sweep on the card's engine, block 1 its serial
    sweep): the score log and the final MSA equal the JAX package's
    exact native route line for line and byte for byte."""
    msa = make_msa(17, rows=30, tlen=240)
    log_c, log_j = [], []
    out_c = prt.realign_batched(msa.copy(), RealignerConfig(
        bandwidth=96, block_rows=16), score_log=log_c, mode="exact",
        kernel="cuda", device="cuda")
    out_j = jr.realign_batched(msa.copy(), JCfg(bandwidth=96,
                                                block_rows=16),
                               score_log=log_j, mode="exact",
                               kernel="native")
    assert log_c == log_j and min(log_c) < log_c[0]
    np.testing.assert_array_equal(out_c, np.asarray(out_j))
    sweeps = Engine.host_sweeps_by_route
    assert list(sweeps) == ["cuda"] and sorted(sweeps["cuda"]) == [1, 4, 16]
    serial = Engine.card_serial_split
    assert serial["sweeps"] == sweeps["cuda"][1] > 0
    assert plain_card.launches["fill"] == plain_card.launches["walk"] \
        == pce.exact_fill.launches > serial["rows"] > 0


def test_block_1_auto_on_the_card_takes_the_card_sweep(plain_card):
    """realign_batched(block_rows=1) with kernel and mode "auto" on a
    CUDA device runs block 1 on the card's serial sweep (not the host
    native engine), with the JAX package's block-1 trajectory."""
    msa = make_msa(19, rows=16, tlen=240)
    cfg = dict(bandwidth=96, block_rows=1, max_rounds=2)
    log_c, log_j = [], []
    out_c = prt.realign_batched(msa.copy(), RealignerConfig(**cfg),
                                score_log=log_c, device="cuda")
    out_j = jr.realign_batched(msa.copy(), JCfg(**cfg), score_log=log_j,
                               mode="exact", kernel="native")
    assert log_c == log_j
    np.testing.assert_array_equal(out_c, np.asarray(out_j))
    assert Engine.host_sweeps_by_route == {"cuda": {1: 2}}
    assert Engine.card_serial_split["rows"] == 2 * msa.shape[0]


def test_failing_kernel_raises_on_the_card(plain_card, monkeypatch):
    """A kernel that fails in the card's serial sweep raises; the sweep
    never hands the row to the host native engine."""
    ran = []
    monkeypatch.setattr(Engine, "_sweep_serial_indirect",
                        lambda self, *a, **k: ran.append(1))
    eng = Engine(make_msa(3, rows=8, tlen=200), bandwidth=96, block_rows=1,
                 mode="exact", kernel="cuda", device="cuda")
    plain_card.fail = True
    with pytest.raises(RuntimeError, match="exact_fill launch failed"):
        eng.sweep()
    assert ran == [] and Engine.host_sweeps_by_route == {}
