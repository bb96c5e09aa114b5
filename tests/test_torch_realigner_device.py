"""The port's resident engine against the JAX resident engine, on the CPU.

The port's DeviceResidentRealigner runs with device="cpu" (the kernels'
plain torch versions); the JAX DeviceResidentRealigner runs with Pallas
in interpret mode, as tests/test_realigner_device.py runs it. Both see
the same MSA, made with numpy from a seed, and must give the same
per-sweep (mille, uno) trajectory and the same final MSA (exact
equality). The cases are those of test_realigner_device.py: trajectory,
widen neutrality, the exact fallback, insert-fetch overflow, mid-sweep
cap flushes, and the drift ladder across block sizes.
"""
import os

import numpy as np
import pytest
import torch

from tests.test_realigner_device import make_msa

torch.set_num_threads(1)

BAND, CHUNK = 96, 32


def _jax_run(msa, sweeps, bs, *, widen=None, ins_fetch=None,
             flush_cap=None, chunk=CHUNK):
    from repeatresolver_tpu.models.realigner_device import (
        DeviceResidentRealigner,
    )
    env = {"RR_RESIDENT_WIDEN": widen, "RR_INS_FETCH": ins_fetch}
    for k, v in env.items():
        if v is not None:
            os.environ[k] = str(v)
    try:
        eng = DeviceResidentRealigner(
            msa.copy(), bandwidth=BAND, block_rows=bs, mode="staircase",
            chunk=chunk, kernel="pallas", interpret=True)
    finally:
        for k in env:
            os.environ.pop(k, None)
    if flush_cap is not None:
        eng._flush_cap = flush_cap
    eng.ent_al_gapper()
    log = []
    for _ in range(sweeps):
        eng.sweep()
        log.append(eng.overall_pair())
    eng._sync_host()
    return log, eng.msa.copy()


def _port_engine(msa, bs, chunk=CHUNK, **kw):
    from repeatresolver_tpu_torch.models.realigner_device import (
        DeviceResidentRealigner,
    )
    return DeviceResidentRealigner(msa.copy(), bandwidth=BAND,
                                   block_rows=bs, chunk=chunk,
                                   device="cpu", **kw)


def _port_run(msa, sweeps, bs, *, widen=None, ins_fetch=None,
              flush_cap=None, validate=False, chunk=CHUNK):
    eng = _port_engine(msa, bs, chunk=chunk)
    if widen is not None:
        eng._widen = widen
    if ins_fetch is not None:
        eng._maxf = ins_fetch
    if flush_cap is not None:
        eng._flush_cap = flush_cap
    eng.ent_al_gapper()
    log = []
    for _ in range(sweeps):
        eng.sweep()
        if validate:
            eng.validate()
        log.append(eng.overall_pair())
    return log, eng.best_snapshot(), eng


@pytest.fixture(scope="module")
def jax_msa3():
    """The JAX resident engine's 3-sweep run on make_msa(3), block 8
    (16 rows: one block shape, one JAX compile per slack)."""
    msa = make_msa(3, rows=16, tlen=240)
    return msa, _jax_run(msa, 3, 8)


def test_resident_matches_jax_trajectory(jax_msa3):
    msa, (log_j, msa_j) = jax_msa3
    log_p, msa_p, _ = _port_run(msa, 3, 8)
    assert log_p == log_j
    np.testing.assert_array_equal(msa_p, msa_j)


def test_insert_overflow_routes_exact(jax_msa3):
    """An insert list overflowing the fetched window (1 slot) reroutes
    its block through the exact host fallback, and the trajectory stays
    the JAX engine's (exact band == covering staircase)."""
    msa, (log_j, msa_j) = jax_msa3
    log_p, msa_p, eng = _port_run(msa, 3, 8, ins_fetch=1)
    assert eng._overflow_events > 0
    assert log_p == log_j
    np.testing.assert_array_equal(msa_p, msa_j)


@pytest.mark.parametrize("widen", [4, 8, 16])
def test_widen_is_result_neutral(jax_msa3, widen):
    """The staircase slack is drift headroom, not band: any covering
    value gives the JAX engine's default-slack result."""
    msa, (log_j, msa_j) = jax_msa3
    log_p, msa_p, _ = _port_run(msa, 3, 8, widen=widen)
    assert log_p == log_j
    np.testing.assert_array_equal(msa_p, msa_j)


def test_exact_fallback_parity():
    """A row whose bases are spread thinner than any staircase slack
    (one base every 20 columns: drift > 16 rungs x chunk 16) routes
    its block through the exact host fallback for good, after a first
    pass that violated the starting slack; the result matches the JAX
    engine's."""
    msa = make_msa(5, rows=8, tlen=280)
    sparse = np.full(280, 5, np.int8)
    rng = np.random.default_rng(0)
    sparse[::20] = rng.integers(0, 4, len(sparse[::20]))
    msa[3] = sparse
    log_j, msa_j = _jax_run(msa, 2, 4, widen=4, chunk=16)
    log_p, msa_p, eng = _port_run(msa, 2, 4, widen=4, chunk=16)
    assert eng._exact_blocks
    assert log_p == log_j
    np.testing.assert_array_equal(msa_p, msa_j)


def test_cap_crossing_flushes_match_jax(monkeypatch):
    """Mid-sweep flushes (pending-insert cap crossed, read 3 blocks
    behind the dispatch) land where the JAX engine's do: same
    trajectory, and the count invariant holds across every flush."""
    from repeatresolver_tpu_torch.models.realigner_device import (
        DeviceResidentRealigner,
    )
    flushes = []
    orig = DeviceResidentRealigner._flush_device

    def counted(self, pending, drop_empty):
        flushes.append(len(pending))
        return orig(self, pending, drop_empty)

    monkeypatch.setattr(DeviceResidentRealigner, "_flush_device", counted)
    msa = make_msa(9, rows=12, tlen=240)
    log_j, msa_j = _jax_run(msa, 2, 2, flush_cap=1)
    log_p, msa_p, _ = _port_run(msa, 2, 2, flush_cap=1, validate=True)
    assert len(flushes) > 2              # mid-sweep flushes happened
    assert log_p == log_j
    np.testing.assert_array_equal(msa_p, msa_j)


def test_widen_state_adopted_and_converted():
    """The learned drift ladder survives a respawn or checkpoint: the
    same block size adopts it verbatim; a smaller one inherits the max
    slack of the covering old blocks; below the threshold the anneal
    hands over to the host native engine."""
    from repeatresolver_tpu_torch.models import realigner as prt
    from repeatresolver_tpu_torch.models.realigner_device import (
        DeviceResidentRealigner,
    )
    msa = make_msa(5, rows=16, tlen=300)
    bs = 8
    _, _, eng = _port_run(msa, 2, bs)
    ws = eng.widen_state()
    assert ws is not None and ws[0] == bs
    b = _port_engine(msa, bs, widen_state=ws)
    b._ensure_order()
    np.testing.assert_array_equal(b._block_widen, ws[1])
    b2 = _port_engine(msa, bs // 2, widen_state=ws)
    b2._ensure_order()
    per_row = np.repeat(ws[1], bs)[:msa.shape[0]]
    expect = [per_row[i:i + bs // 2].max()
              for i in range(0, msa.shape[0], bs // 2)]
    np.testing.assert_array_equal(b2._block_widen, expect)
    old_min = DeviceResidentRealigner.RESIDENT_MIN_BS
    DeviceResidentRealigner.RESIDENT_MIN_BS = 2
    try:
        b3 = eng.respawn(msa.copy(), bs // 2)
        assert eng._msa_d is None         # freed before b3 uploads
        b3._ensure_order()
        np.testing.assert_array_equal(b3._block_widen, expect)
    finally:
        DeviceResidentRealigner.RESIDENT_MIN_BS = old_min
    b4 = eng.respawn(msa.copy(), bs // 2)
    assert type(b4) is prt.BatchedRealigner


def test_block_step_counts_and_rows_consistent():
    """One block step updates the resident MSA and histogram together
    (the W_Con_Checker invariant over the capacity) and reports the
    block's drift."""
    from repeatresolver_tpu_torch.models import realigner_device as rd
    msa = make_msa(2, rows=6, tlen=200)
    eng = _port_engine(msa, 6)
    eng.ent_al_gapper()
    eng._ensure_order()
    before = eng.msa                     # the block's input, on the host
    lengths = eng._len_d
    out = rd.block_step(eng._msa_d, eng._counts_d, eng._order_d, lengths,
                        eng._ncols, bandwidth=BAND, chunk=CHUNK, widen=12,
                        lpad=256, maxf=8)
    c = eng._ncols
    hist = rd._hist(eng._msa_d)
    assert torch.equal(hist[:c], eng._counts_d[:c])
    assert not hist[c:, :5].any() and not eng._counts_d[c:].any()
    ways = [np.flatnonzero(r < 4) for r in before[eng._ord_host]]
    drift = max(int(w[min(s + CHUNK - 1, len(w) - 1)] - w[s])
                for w in ways for s in range(0, len(w), CHUNK))
    assert int(out[-1]) == drift


def _crafted_msa(case):
    """make_msa's rows (' ' outside a row's span, '-' inside it) with the
    case's features; "every" holds all of them."""
    msa = make_msa(4, rows=12, tlen=160)
    every = case == "every"
    if case in ("row_without_bases", "every"):
        msa[5] = 4                        # '-' only: every one converted
        msa[6] = 5
    if case in ("gaps_outside_the_bases", "every"):
        b = np.flatnonzero(msa[2] < 4)
        msa[2, :b[0]] = 4                 # only '-' before the bases
        b = np.flatnonzero(msa[3] < 4)
        msa[3, b[-1] + 1:] = 4            # only '-' after them
    if case in ("columns_the_conversion_empties", "every"):
        msa[:, 150:] = 5                  # '-' outside each row's bases
        msa[0:4, 150:] = 4
    if case in ("columns_already_empty", "every"):
        msa[:, 70:73] = 5
        msa[8, 71] = 4                    # '-' inside a row's span
    assert every or (msa != make_msa(4, rows=12, tlen=160)).any()
    return msa


@pytest.mark.parametrize("case,chunk_rows,laid_out", [
    ("row_without_bases", None, False),
    ("gaps_outside_the_bases", None, False),
    ("columns_the_conversion_empties", None, False),
    ("columns_already_empty", None, False),
    ("every", 5, False),                  # row chunks of 5, 5 and 2
    ("every", 1, False),
    ("every", 5, True),                   # a respawn's layout, in place
])
def test_device_msa_passes_equal_the_host(case, chunk_rows, laid_out,
                                          monkeypatch):
    """The resident engine's whole-MSA passes on its device, bit for bit
    against the host's: the set-up's histogram and row lengths against
    `symbol_counts` and `row_lengths`; EntAlGapper's conversion, its
    count, the columns it keeps, the MSA and the histogram against
    `RealignEngine.ent_al_gapper`, both from the set-up's upload (the
    gather into the [R, CPAD] buffer sized from the width kept) and in
    place on a laid-out buffer; a second call converts nothing."""
    from repeatresolver_tpu_torch.models import realigner as prt
    from repeatresolver_tpu_torch.models import realigner_device as rd
    if chunk_rows:                        # row chunks of this many rows
        monkeypatch.setattr(rd, "pass_rows", lambda dev, cols: chunk_rows)
    msa = _crafted_msa(case)
    cpu = torch.device("cpu")
    msa_d, counts_d, lengths_d = rd.upload_msa(msa, cpu)
    np.testing.assert_array_equal(msa_d.numpy(), msa)
    np.testing.assert_array_equal(counts_d.numpy(), prt.symbol_counts(msa))
    np.testing.assert_array_equal(lengths_d.numpy(), prt.row_lengths(msa))
    ref = prt.RealignEngine(msa.copy(), BAND)
    keep = np.flatnonzero(ref.counts[:, :4].sum(axis=1) > 0)
    converted = ref.ent_al_gapper()
    assert converted > 0 and ref.msa.shape[1] < msa.shape[1]
    c = msa.shape[1]
    assert rd.ent_al_gapper_device(msa_d, counts_d, c) == converted
    np.testing.assert_array_equal(
        rd.kept_columns(counts_d, c).numpy(), keep)
    np.testing.assert_array_equal(msa_d.numpy()[:, keep], ref.msa)
    np.testing.assert_array_equal(counts_d.numpy()[keep], ref.counts)

    eng = _port_engine(msa, 4)
    np.testing.assert_array_equal(eng.counts, prt.symbol_counts(msa))
    np.testing.assert_array_equal(eng._lengths_all, prt.row_lengths(msa))
    if laid_out:
        eng._lay_out()
    cpad = eng._cpad
    assert eng.ent_al_gapper() == converted
    n = len(keep)
    assert eng.width() == n
    assert eng._cpad == (cpad if laid_out
                         else -(-(n + 32768) // 1024) * 1024)
    np.testing.assert_array_equal(eng.msa, ref.msa)
    np.testing.assert_array_equal(eng.counts, ref.counts)
    assert (eng._msa_d[:, n:] == 5).all() and not eng._counts_d[n:].any()
    eng.validate()
    assert eng.ent_al_gapper() == 0 and eng.width() == n
    np.testing.assert_array_equal(eng.msa, ref.msa)


def test_resident_call_makes_no_host_msa_pass():
    """A resident `realign_batched` call with the recorder on: no
    whole-MSA pass on the host between its entry and its return
    (`realign.host_msa_passes`, which the host engine's call counts),
    the set-up's upload inside `realign.setup`, and the score log and
    MSA of the JAX package's resident engine."""
    from repeatresolver_tpu.config import RealignerConfig as JCfg
    from repeatresolver_tpu.models import realigner as jr
    from repeatresolver_tpu_torch.config import RealignerConfig
    from repeatresolver_tpu_torch.models import realigner as prt
    from repeatresolver_tpu_torch.utils import trace
    msa = make_msa(6, rows=24, tlen=240)
    msa[3, :40] = 4                       # '-' before a row's bases
    log_j: list = []
    out_j = jr.realign_batched(msa.copy(), JCfg(bandwidth=BAND,
                                                max_rounds=3),
                               block_rows=8, mode="staircase",
                               kernel="pallas", score_log=log_j,
                               anneal=False)
    trace.reset()
    trace.enable()
    try:
        log_p: list = []
        out_p = prt.realign_batched(
            msa.copy(), RealignerConfig(bandwidth=BAND, block_rows=8,
                                        max_rounds=3),
            score_log=log_p, anneal=False, device="cpu")
        passes = trace.totals()["counts"].get("realign.host_msa_passes", 0)
        tree = {i: (n, p) for n, i, p, *_ in trace.timeline()}
        trace.reset()
        prt.realign_batched(msa.copy(), RealignerConfig(bandwidth=BAND,
                                                        block_rows=8,
                                                        max_rounds=3),
                            anneal=False, mode="exact", kernel="native",
                            device="cpu")
        host_passes = trace.totals()["counts"]["realign.host_msa_passes"]
    finally:
        trace.disable()
        trace.reset()
    assert passes == 0
    # symbol_counts, the bases, EntAlGapper twice
    assert host_passes >= 4
    uploads = [p for n, p in tree.values() if n == "resident.upload"]
    assert len(uploads) == 1
    assert tree[uploads[0]][0] == "realign.setup"
    assert tree[tree[uploads[0]][1]][0] == "realign.call"
    assert log_p == log_j and len(log_p) > 2
    np.testing.assert_array_equal(out_p, out_j)
