"""The anneal's tail on the card (models/realigner.py::tail_kernel): below
the resident engine's smallest block, every block runs on the
non-resident exact engine through kernels F and G (block 1 as the serial
sweep over a column store on the card, `_sweep_serial_card`), and an
engine on the CPU keeps the host native engine. Inputs are numpy arrays
from a seed; every comparison is exact (integer DP, byte-equal MSAs).

  * the route function at blocks 31, 16, 4, 2 and 1 on "cuda" and on
    "cpu", and the three places that choose the tail's engine through
    it: the resident engine's shrink() and respawn() and a resume of
    realign_batched inside the tail (at checkpoint blocks 16 and 1, on
    the card and on the CPU), on a stood-in card (F and G's libraries
    stood in for, tensors that claim the card stay on the CPU);
  * the tail 16 -> 4 -> 1 through the card's engine class
    (BatchedRealigner(mode="exact", kernel="cuda")) on CPU tensors, where
    kernels F and G run their plain versions: score log and final MSA
    byte-equal to the port's native engine and to the JAX package's
    realign_batched(mode="exact", kernel="native"), at band 96 and at
    band 800 (where the engine's chunk is 128: the exact band's starts
    do not read it);
  * a block whose codes pass a low RR_DEVICE_HBM_BUDGET runs in row
    groups against the block's one histogram, never halved, and the
    trajectory is still the native engine's.

The kernels themselves run on the card: tests/test_torch_cuda_kernels.py
and chip_smoke.py (phase 4 runs the tail of tpu_converge on F and G).
"""
import numpy as np
import pytest
import torch

from repeatresolver_tpu_torch.config import RealignerConfig
from repeatresolver_tpu_torch.models import realigner as prt
from repeatresolver_tpu_torch.models import realigner_device as prd
from repeatresolver_tpu_torch.ops import cuda_exact as pce
from tests.test_realigner_device import make_msa
from tests.test_torch_exact_kernels import fake_card  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("bs", [31, 16, 4, 2, 1])
def test_tail_kernel_route(bs, device):
    want = "cuda" if device == "cuda" else "native"
    assert prt.tail_kernel(bs, device) == want
    assert prt.tail_kernel(bs, torch.device(device)) == want


def _kind(eng):
    return type(eng).__name__, eng.mode, eng.kernel, eng.block_rows


@pytest.fixture
def on_card(fake_card, monkeypatch):  # noqa: F811
    """A stood-in card on which "cuda" resolves without a card."""
    monkeypatch.setattr(prd, "resolve_device", torch.device)
    monkeypatch.setattr(prt, "resolve_device", torch.device)
    return fake_card


def test_resident_hands_the_tail_to_f_and_g(on_card):
    """shrink() and respawn() of the resident engine on the card take
    the non-resident exact engine on the card at blocks 16, 4 and 1 (its
    own shrink and respawn keep it there, block 1 included); on the CPU
    every tail block takes the host native engine."""
    msa = make_msa(3, rows=40, tlen=240)
    eng = prd.DeviceResidentRealigner(msa, bandwidth=96, block_rows=64,
                                      device="cuda")
    assert eng.RESIDENT_MIN_BS == 32
    assert eng.shrink(32) is eng
    tail = eng.shrink(16)
    assert _kind(tail) == ("BatchedRealigner", "exact", "cuda", 16)
    assert tail.device == torch.device("cuda")
    assert _kind(eng.respawn(msa, 4)) == ("BatchedRealigner", "exact",
                                          "cuda", 4)
    assert _kind(eng.respawn(msa, 1)) == ("BatchedRealigner", "exact",
                                          "cuda", 1)
    assert tail.shrink(4) is tail and tail.block_rows == 4
    assert _kind(tail.respawn(msa, 2)) == ("BatchedRealigner", "exact",
                                           "cuda", 2)
    assert tail.shrink(1) is tail
    assert _kind(tail) == ("BatchedRealigner", "exact", "cuda", 1)
    cpu = prd.DeviceResidentRealigner(msa, bandwidth=96, block_rows=64,
                                      device="cpu")
    for bs in (16, 4, 1):
        assert _kind(cpu.respawn(msa, bs)) == ("BatchedRealigner", "exact",
                                               "native", bs)
    assert _kind(cpu.shrink(16)) == ("BatchedRealigner", "exact", "native",
                                     16)


class _Started(Exception):
    pass


@pytest.mark.parametrize("ck_bs,kernel", [(16, "cuda"), (1, "native"),
                                         (1, "cuda"), (16, "native")])
def test_resume_inside_the_tail(on_card, monkeypatch, tmp_path, ck_bs,
                                kernel):
    """realign_batched resumed from a checkpoint inside the tail makes
    the tail's engine: F and G on the card at blocks 16 and 1 (kernel
    "cuda"), the host native engine on the CPU (kernel "native")."""
    from repeatresolver_tpu_torch.utils import checkpoint as ckpt
    msa = make_msa(3, rows=24, tlen=240)
    path = str(tmp_path / "ck")
    ckpt.RealignCheckpoint(msa=msa, round=5, best_mille=0, best_uno=1,
                           bandwidth=96, block_rows=ck_bs).save(path)
    made = []

    class Recording(prt.BatchedRealigner):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(_kind(self) + (self.device,))
            raise _Started

    monkeypatch.setattr(prt, "BatchedRealigner", Recording)
    with pytest.raises(_Started):
        prt.realign_batched(msa, RealignerConfig(bandwidth=96,
                                                 block_rows=64),
                            checkpoint_path=path, resume=True,
                            device="cuda" if kernel == "cuda" else "cpu")
    device = torch.device("cuda") if kernel == "cuda" else "cpu"
    assert made == [("Recording", "exact", kernel, ck_bs, device)]


def _run(msa, w, kernel, log, **kw):
    return prt.realign_batched(msa.copy(), RealignerConfig(
        bandwidth=w, block_rows=16), score_log=log, mode="exact",
        kernel=kernel, device="cpu", **kw)


@pytest.mark.parametrize("w,tlen", [(96, 260), (800, 900)])
def test_tail_on_the_card_engine_matches_native(monkeypatch, w, tlen):
    """The tail 16 -> 4 -> 1 through the card's engine class on CPU
    tensors (block 1: its serial sweep over the column store) equals the
    port's native engine and the JAX package's native route, score log
    and final MSA, byte for byte (RR_FLUSH_CAP high for the JAX run, as
    for the port's; the cap is shared code)."""
    from repeatresolver_tpu.config import RealignerConfig as JCfg
    from repeatresolver_tpu.models import realigner as jr
    monkeypatch.setenv("RR_FLUSH_CAP", str(1 << 30))
    cls = prt.BatchedRealigner
    monkeypatch.setattr(cls, "host_sweeps_by_route", {})
    monkeypatch.setattr(cls, "card_tail_split",
                        dict.fromkeys(cls.CARD_SPLIT, 0))
    monkeypatch.setattr(cls, "card_serial_split",
                        dict.fromkeys(cls.SERIAL_SPLIT, 0))
    msa = make_msa(17, rows=36, tlen=tlen)
    log_c, log_n, log_j = [], [], []
    out_c = _run(msa, w, "cuda", log_c)
    sweeps = {r: dict(by) for r, by in cls.host_sweeps_by_route.items()}
    out_n = _run(msa, w, "native", log_n)
    out_j = jr.realign_batched(msa.copy(), JCfg(bandwidth=w, block_rows=16),
                               score_log=log_j, mode="exact",
                               kernel="native")
    assert log_c == log_n == log_j and min(log_c) < log_c[0]
    np.testing.assert_array_equal(out_c, out_n)
    np.testing.assert_array_equal(out_c, np.asarray(out_j))
    # blocks 16, 4 and 1 on the card's engine, none on the host's
    assert sorted(sweeps["cuda"]) == [1, 4, 16] and "native" not in sweeps
    split = cls.card_tail_split
    assert split["blocks"] > 0 and split["s"] >= split["device_s"] > 0
    serial = cls.card_serial_split
    assert serial["sweeps"] == sweeps["cuda"][1]
    assert serial["rows"] == serial["sweeps"] * msa.shape[0]
    # the engine's chunk (128 at band 800) does not enter the exact band
    eng = cls(msa, bandwidth=w, block_rows=16, mode="exact", kernel="cuda",
              device="cpu")
    assert eng.chunk == (128 if w >= 768 else 256)
    seqs, ways, lengths = prt.compact_rows(msa)
    for a, b in zip(prt.band_starts(ways, lengths, w, 128, False),
                    prt.band_starts(ways, lengths, w, 256, False)):
        np.testing.assert_array_equal(a, b)


def test_low_budget_runs_row_groups_not_halves(monkeypatch):
    """A block of 16 whose kernel-F codes pass RR_DEVICE_HBM_BUDGET runs
    in groups of 3 rows against the block's one histogram: no block is
    split into two Jacobi blocks (the native engine never halves), and
    the trajectory equals the native engine's."""
    monkeypatch.setenv("RR_FLUSH_CAP", str(1 << 30))
    msa = make_msa(5, rows=34, tlen=260)
    w = 96
    lpad = prt._bucket(int(prt.row_lengths(msa).max()))
    monkeypatch.setenv("RR_DEVICE_HBM_BUDGET",
                       str(3 * pce.codes_bytes(lpad, w) + 7))
    blocks, groups = [], []
    realign_block = prt.BatchedRealigner._realign_block
    block_dp = prt.block_dp

    def counted_block(self, rows):
        blocks.append((self.kernel, self.block_rows, len(rows)))
        return realign_block(self, rows)

    def counted_dp(counts, rows_old, *a, **k):
        groups.append(rows_old.shape[0])
        return block_dp(counts, rows_old, *a, **k)

    monkeypatch.setattr(prt.BatchedRealigner, "_realign_block",
                        counted_block)
    monkeypatch.setattr(prt, "block_dp", counted_dp)
    log_c, log_n = [], []
    out_c = _run(msa, w, "cuda", log_c)
    card_blocks = [b for b in blocks if b[0] == "cuda"]
    monkeypatch.setattr(prt, "block_dp", block_dp)
    out_n = _run(msa, w, "native", log_n)
    assert log_c == log_n
    np.testing.assert_array_equal(out_c, out_n)
    # every block of 16 whole: 34 rows are two blocks of 16 and one of 2
    assert {(bs, n) for _, bs, n in card_blocks if bs == 16} == {(16, 16),
                                                                 (16, 2)}
    assert max(groups) == 3 and groups.count(3) > 0
