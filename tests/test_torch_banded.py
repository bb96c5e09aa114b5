"""The port's exact band (ops/banded_realign.py) and the engines that use
it, against the JAX package on the CPU. Inputs are numpy arrays from a
seed; every comparison is exact (tolerance 0: integer DP).

  * banded_fill / entry_and_backtrack against the JAX functions;
  * staircase == exact on the port, the property of
    tests/test_staircase_exact_parity.py (seeds 1, 3, 11, 26, 27, 29 x
    chunk 16, 32), through the port's plain staircase fill with its
    packed codes unpacked for the lockstep backtrack, and through the
    walk (kernel B's plain version) on the packed codes;
  * the serial `realign()` against the JAX `realign()`;
  * BatchedRealigner(mode, kernel="torch" | "cuda") against
    kernel="native", to convergence with the anneal;
  * the resident engine's exact blocks through the torch exact band when
    the host library cannot be built.
"""
import numpy as np
import pytest
import torch

from repeatresolver_tpu_torch.config import RealignerConfig
from repeatresolver_tpu_torch.ops import banded_realign as pbr
from repeatresolver_tpu_torch.ops import cuda_backtrack as pcb
from repeatresolver_tpu_torch.ops import staircase_realign as psr
from repeatresolver_tpu_torch.utils import native
from tests.test_realigner_device import make_msa
from tests.test_staircase_exact_parity import W, _case

torch.set_num_threads(1)
NAMES = ("rows", "best", "iy", "ib", "inn")


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bounds(ways, lengths, w):
    b = len(lengths)
    anf = np.maximum(0, ways - w // 2).astype(np.int32)
    last_way = ways[np.arange(b), np.maximum(lengths - 1, 0)]
    return anf, np.maximum(-1, last_way - w // 2).astype(np.int32)


def _same_outputs(got, ref, inn):
    """(rows, best, iy, ib, inn) equal; insert slots up to inn a row."""
    for name, g, r in zip(NAMES, got, ref, strict=True):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        r = r.numpy() if isinstance(r, torch.Tensor) else np.asarray(r)
        if name in ("iy", "ib"):
            for i, n in enumerate(inn):
                np.testing.assert_array_equal(g[i, :n], r[i, :n],
                                              err_msg=f"{name} row {i}")
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)


@pytest.mark.parametrize("seed,chunk", [(1, 16), (3, 256), (26, 48)])
def test_banded_fill_and_backtrack_match_jax(seed, chunk):
    """Codes, final band and band start of the fill, then rows, best and
    insert lists of the backtrack, whole arrays; a chunk that does not
    divide L pads the last one."""
    from repeatresolver_tpu.ops import banded_realign as jbr
    counts, rows_old, seqs, ways, lengths, c = _case(seed)
    lengths[0] = 1                       # a one-base row
    ways[0, 1:] = ways[0, 0]
    jf = jbr.banded_fill(counts, rows_old, seqs, ways, lengths, np.int32(c),
                         bandwidth=W)
    pf = pbr.banded_fill(T(counts), T(rows_old), T(seqs), T(ways),
                         T(lengths), c, bandwidth=W, chunk=chunk)
    assert pf[0].dtype == torch.uint8 and pf[0].shape == (4, 64, W)
    for g, r in zip(pf, jf, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    anf, eb = _bounds(ways, lengths, W)
    jo = jbr.entry_and_backtrack(*jf, seqs, anf, eb, lengths, np.int32(c),
                                 cpad=c + 8, bandwidth=W)
    po = pbr.entry_and_backtrack(*pf, T(seqs), T(anf), T(eb), T(lengths), c,
                                 cpad=c + 8, bandwidth=W)
    assert po[0].shape == (4, c + 8) and po[2].shape == (4, pbr.MAX_INSERTS)
    for name, g, r in zip(NAMES, po, jo, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    # time-major codes: the same walk
    pt = pbr.entry_and_backtrack(
        pf[0].permute(1, 0, 2).contiguous(), pf[1], pf[2], T(seqs), T(anf),
        T(eb), T(lengths), c, cpad=c + 8, bandwidth=W, time_major=True)
    for g, r in zip(pt, po, strict=True):
        assert torch.equal(g, r)
    assert (po[0].numpy()[:, :c] != rows_old).any()   # the DP moved rows


@pytest.mark.parametrize("seed", [1, 3, 11, 26, 27, 29])
@pytest.mark.parametrize("chunk", [16, 32])
def test_staircase_matches_exact_any_chunk(seed, chunk):
    counts, rows_old, seqs, ways, lengths, c = _case(seed)
    b, l = seqs.shape
    args = (T(counts), T(rows_old), T(seqs), T(ways), T(lengths), c)
    anf, eb = _bounds(ways, lengths, W)
    exact = pbr.entry_and_backtrack(
        *pbr.banded_fill(*args, bandwidth=W), T(seqs), T(anf), T(eb),
        T(lengths), c, cpad=c, bandwidth=W)
    inn = exact[4].numpy()
    starts = np.arange(0, l, chunk)
    ends = np.minimum(starts + chunk - 1, l - 1)
    drift = int((ways[:, ends] - ways[:, starts]).max())
    widen = -(-max(1, drift) // chunk)
    w2 = W + widen * chunk
    codes, fband, fanf = psr.staircase_fill(*args, bandwidth=W, chunk=chunk,
                                            widen=widen)
    anf_s = psr.staircase_anf(T(ways), W, chunk)
    stair = pbr.entry_and_backtrack(
        psr.unpack_codes(codes, l), fband, fanf, T(seqs), anf_s, T(eb),
        T(lengths), c, cpad=c, bandwidth=w2)
    _same_outputs(stair, exact, inn)
    walk = pcb.entry_and_backtrack(codes, fband, fanf, T(seqs), anf_s, T(eb),
                                   T(lengths), c, cpad=c, bandwidth=w2,
                                   chunk=chunk)
    _same_outputs(walk, exact, inn)


def test_serial_realign_matches_jax():
    """`realign()`, the numpy serial oracle, and its row score."""
    from repeatresolver_tpu.models import realigner as jr
    from repeatresolver_tpu_torch.models import realigner as pr
    msa = make_msa(3, rows=8, tlen=160)
    cfg = RealignerConfig(bandwidth=64)
    log_j: list = []
    log_p: list = []
    out_j = jr.realign(msa.copy(), cfg, score_log=log_j)
    out_p = pr.realign(msa.copy(), cfg, score_log=log_p)
    assert log_p == log_j and min(log_p) < log_p[0]
    np.testing.assert_array_equal(out_p, out_j)
    counts = pr.symbol_counts(out_p)
    assert [pr.row_score(out_p, counts, k) for k in range(8)] == \
        [jr.row_score(out_j, counts, k) for k in range(8)]
    # block 1 of the batched engine is the same trajectory
    log_b: list = []
    out_b = pr.realign_batched(msa.copy(), cfg, score_log=log_b,
                               block_rows=1, device="cpu")
    assert log_b == log_p
    np.testing.assert_array_equal(out_b, out_p)


@pytest.fixture(scope="module")
def native_run():
    from repeatresolver_tpu_torch.models import realigner as pr
    msa = make_msa(7, rows=14, tlen=260)
    log: list = []
    out = pr.realign_batched(msa.copy(),
                             RealignerConfig(bandwidth=96, block_rows=8),
                             score_log=log, mode="exact", kernel="native",
                             device="cpu")
    return msa, log, out


@pytest.mark.parametrize("mode,kernel", [("exact", "torch"),
                                         ("staircase", "torch"),
                                         ("staircase", "cuda")])
def test_batched_torch_routes_match_native(native_run, monkeypatch, mode,
                                           kernel):
    """The non-resident engine's device routes on CPU tensors, anneal
    tail at block 2 and 1 included, against the host native engine."""
    from repeatresolver_tpu_torch.models import realigner as pr
    msa, log_n, out_n = native_run
    monkeypatch.setenv("RR_RESIDENT", "0")
    log: list = []
    out = pr.realign_batched(msa.copy(),
                             RealignerConfig(bandwidth=96, block_rows=8),
                             score_log=log, mode=mode, kernel=kernel,
                             device="cpu", validate=True)
    assert log == log_n and min(log) < log[0]
    np.testing.assert_array_equal(out, out_n)
    eng = pr.BatchedRealigner(msa, mode=mode, kernel=kernel, device="cpu")
    assert (eng.mode, eng.kernel, eng.device) == (mode, kernel,
                                                  torch.device("cpu"))
    with pytest.raises(ValueError):
        pr.BatchedRealigner(msa, kernel="xla")


def test_exact_block_torch_degrade_route(monkeypatch):
    """With the host library unavailable, the resident engine's exact
    blocks (here forced by an insert fetch of one slot) run the torch
    exact band, counted apart, and the trajectory is the native
    route's."""
    from repeatresolver_tpu_torch.models import realigner_device as prd

    def run():
        eng = prd.DeviceResidentRealigner(
            make_msa(3, rows=16, tlen=240), bandwidth=96, block_rows=8,
            chunk=32, device="cpu")
        eng._maxf = 1
        eng.ent_al_gapper()
        log = []
        for _ in range(3):
            eng.sweep()
            log.append(eng.overall_pair())
        return log, eng.best_snapshot(), eng

    cls = prd.DeviceResidentRealigner
    n0, t0 = cls.exact_blocks_run["native"], cls.exact_blocks_run["torch"]
    log_n, msa_n, eng = run()
    assert eng._overflow_events > 0
    assert cls.exact_blocks_run["native"] > n0
    assert cls.exact_blocks_run["torch"] == t0
    n1 = cls.exact_blocks_run["native"]

    def no_library():
        raise native.NativeBuildError(
            "native host library: cannot run g++")

    monkeypatch.setattr(prd, "_native", no_library)
    with pytest.warns(RuntimeWarning, match="torch exact band"):
        log_t, msa_t, _ = run()
    assert cls.exact_blocks_run["native"] == n1
    assert cls.exact_blocks_run["torch"] - t0 == n1 - n0
    assert log_t == log_n
    np.testing.assert_array_equal(msa_t, msa_n)


def test_memory_budget_depends_on_the_device_model_alone(monkeypatch):
    """The block halving's budget: RR_DEVICE_HBM_BUDGET when set, else
    the JAX package's 4 GiB on the CPU (on a card a share of its total
    memory, never of the free memory): the same on every call."""
    from repeatresolver_tpu_torch.models import realigner as prt
    monkeypatch.delenv("RR_DEVICE_HBM_BUDGET", raising=False)
    cpu = torch.device("cpu")
    assert prt.device_memory_budget(cpu) == 4 << 30
    assert prt.device_memory_budget(cpu) == prt.device_memory_budget(cpu)
    monkeypatch.setenv("RR_DEVICE_HBM_BUDGET", "12345")
    assert prt.device_memory_budget(cpu) == 12345


def test_cli_reports_the_exact_blocks_routes(monkeypatch, capsys):
    """`cli realign` and `cli pipeline` say on stderr how many exact
    blocks took each route, and nothing when none ran."""
    from repeatresolver_tpu_torch import cli
    from repeatresolver_tpu_torch.models import realigner_device as prd
    cls = prd.DeviceResidentRealigner
    monkeypatch.setattr(cls, "exact_blocks_run",
                        {"cuda": 0, "native": 0, "torch": 0})
    cli._report_exact_blocks()
    assert capsys.readouterr().err == ""
    monkeypatch.setattr(cls, "exact_blocks_run",
                        {"cuda": 4, "native": 3, "torch": 2})
    cli._report_exact_blocks()
    err = capsys.readouterr().err
    assert "4 through kernels F and G" in err
    assert "3 through the host library" in err
    assert "2 through the torch exact band" in err
