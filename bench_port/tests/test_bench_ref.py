"""The plain reference against the port's plain routes at tiny sizes:
the serial engine (`RealignEngine`) and the host native engine's Jacobi
sweep; and the control's tie order departs from both."""
import numpy as np
import pytest

from bench_port.gen import msa as gm
from bench_port.ref import compare
from bench_port.ref import realign as rr

CFG = dict(structure="Tree", coverage=6, difference=0.01, repeatlength=3000,
           flank=500)
BW = 200


@pytest.fixture(scope="module")
def msa0():
    return gm.make_cell_input(CFG, 2, 2 ** 31 + 21).msa


def test_serial_rows_are_the_serial_engine(msa0):
    from repeatresolver_tpu_torch.models.realigner import RealignEngine
    n = 6
    eng = RealignEngine(msa0.copy(), bandwidth=BW)
    eng.ent_al_gapper()
    for k in range(n):
        eng.realign_row(k)
    eng._drop_empty_columns()
    ref = rr.drop_empty(rr.serial_rows(msa0, BW, n))
    assert np.array_equal(ref, eng.msa)
    assert not np.array_equal(rr.serial_rows(msa0, BW, n, ties="diag")[:n],
                              rr.serial_rows(msa0, BW, n)[:n])


@pytest.mark.parametrize("bs", [16, 4])
def test_first_jacobi_block_is_the_native_sweeps(msa0, bs):
    from repeatresolver_tpu_torch.config import RealignerConfig
    from repeatresolver_tpu_torch.models.realigner import realign_batched
    out = realign_batched(msa0.copy(), RealignerConfig(
        bandwidth=BW, block_rows=bs, max_rounds=1), mode="exact",
        kernel="native", anneal=False, device="cpu")
    msa_g, counts, rows = rr.first_block(msa0, bs, range(bs))
    res = [rr.jacobi_row(counts, msa_g[k], BW) for k in rows]
    ins = [(y, k, o, b) for k, (_, i) in zip(rows, res)
           for o, (y, b) in enumerate(i)]
    ref = compare._subset_rows([r for r, _ in res], rows, ins)
    assert compare.moved_bases(out[rows], ref) == 0
    diag = [rr.jacobi_row(counts, msa_g[k], BW, "diag") for k in rows]
    dins = [(y, k, o, b) for k, (_, i) in zip(rows, diag)
            for o, (y, b) in enumerate(i)]
    ctrl = compare._subset_rows([r for r, _ in diag], rows, dins)
    assert compare.moved_bases(ctrl, ref) > 0


def test_projection_ignores_columns_of_other_rows():
    a = np.array([[0, 4, 1, 5], [5, 2, 4, 3]], np.int8)
    # a column of another row's insert and an empty column in between
    b = np.array([[0, 4, 4, 4, 1, 5], [5, 4, 2, 4, 4, 3]], np.int8)
    assert compare.moved_bases(a, b) == 0
    c = np.array([[0, 1, 4, 5], [5, 2, 4, 3]], np.int8)
    assert compare.moved_bases(a, c) == 2


def test_score_and_checks_of_the_layout(msa0):
    from repeatresolver_tpu_torch.models.realigner import (
        overall_score_pair, symbol_counts)
    m = rr.ent_al_gapper(msa0)
    mille, uno = overall_score_pair(symbol_counts(m))
    assert rr.score(m) == mille * 1000000 + uno
    assert compare.layout_faults(m) == 0
    assert compare.layout_faults(msa0) > 0       # '-' outside spans


def test_maxcorr_reference_is_the_ports_host_scan():
    import torch
    from repeatresolver_tpu_torch.config import MaxCorrConfig
    from repeatresolver_tpu_torch.models.maxcorr import compute_maxcorrs

    from bench_port.ref.maxcorr import MaxCorrRef
    msa = gm.make_cell_input(dict(CFG, coverage=8), 8, 5).msa
    mc = MaxCorrConfig()
    host = compute_maxcorrs(msa, mc, fast=True, native="never")
    ref = MaxCorrRef(msa, mc.mincov, mc.min_col_gap, torch.device("cpu"))
    cols = range(0, msa.shape[1], 97)
    got = np.stack([ref.column(i) for i in cols])
    want = host.reshape(-1, 5)[list(cols)]
    assert (want > 0).any()
    # the host scan keeps float32 maxima
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
