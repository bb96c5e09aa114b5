"""The generator: deterministic from the seed, the port's simulator's
draws, and InitialAligner's layout."""
import numpy as np

from bench_port.gen import msa as gm
from bench_port.gen import simulator as gs

CFG = dict(structure="Tree", coverage=6, difference=0.01, repeatlength=3000,
           flank=500)


def test_same_seed_same_inputs_other_seed_other():
    a = gm.make_cell_input(CFG, 3, 2 ** 31 + 5)
    b = gm.make_cell_input(CFG, 3, 2 ** 31 + 5)
    c = gm.make_cell_input(CFG, 3, 2 ** 31 + 6)
    assert np.array_equal(a.msa, b.msa)
    assert not (a.msa.shape == c.msa.shape and np.array_equal(a.msa, c.msa))


def test_rows_are_the_reads_repeat_parts():
    _, _, reads = gs.simulate("Distributed", 6, 3, 0.01, 3000, 500, 9)
    parts = gm.repeat_parts(reads)
    ci = gm.layout(np.zeros(3000, np.uint8), parts)
    assert len(parts) == ci.msa.shape[0] > 0
    for row, (seq, cols, _) in zip(ci.msa, parts):
        assert np.array_equal(row[row < 4].astype(np.uint8), seq)
        # a part runs from a repeat base to a repeat base
        assert (cols >= 0).any()


def test_layout_rules():
    ci = gm.make_cell_input(CFG, 2, 3)
    m = ci.msa
    isb = m < 4
    c = m.shape[1]
    first = isb.argmax(axis=1)
    last = c - 1 - isb[:, ::-1].argmax(axis=1)
    cols = np.arange(c)[None, :]
    outside = (cols < first[:, None]) | (cols > last[:, None])
    # coverage gaps outside a row's span, '-' inside it
    assert (m[outside] == 5).all()
    assert (m[~outside & ~isb] == 4).all()


def test_template_columns_and_runs():
    tpl = np.zeros(4, np.uint8)
    # row 0: bases on columns 0..3 with a run of 2 after column 1;
    # row 1: a leading run of 1 before column 2, then 2, 3
    parts = [(np.array([0, 1, 2, 2, 3, 0], np.uint8),
              np.array([0, 1, -1, -1, 2, 3]), 0),
             (np.array([1, 2, 3], np.uint8), np.array([-1, 2, 3]), 1)]
    ci = gm.layout(tpl, parts)
    # slot 2 holds the longest run before column 2: 2 gap columns
    assert ci.msa.shape[1] == 4 + 2
    assert ci.msa[0].tolist() == [0, 1, 2, 2, 3, 0]
    assert ci.msa[1].tolist() == [5, 5, 1, 4, 2, 3]


def test_copies_and_reads_are_the_ports_simulator():
    from repeatresolver_tpu_torch.config import SimulatorConfig
    from repeatresolver_tpu_torch.models import simulator as ps
    for structure in ("Tree", "Distributed"):
        d = ps.simulate(SimulatorConfig(
            copynumber=4, seed=7, repeatlength=3000, flank=500, coverage=4,
            structure=structure))
        tpl, copies, reads = gs.simulate(structure, 4, 4, 0.01, 3000, 500, 7)
        assert np.array_equal(tpl, d.template)
        assert len(reads) == len(d.reads)
        assert all(np.array_equal(a, r.seq) for a, r in zip(d.reads, reads))
        for c, g in zip(copies, d.copies):
            assert bytes(c.seq) == g[500:-500].tobytes()


def test_true_paths_follow_the_template():
    tpl, copies, reads = gs.simulate("Tree", 4, 2, 0.01, 3000, 500, 3)
    for c in copies:
        tm = np.frombuffer(c.tmap, np.int64)
        seq = np.frombuffer(bytes(c.seq), np.uint8)
        placed = tm >= 0
        assert (np.diff(tm[placed]) > 0).all()
        # most copy bases keep their template base (1% divergence)
        assert (seq[placed] == tpl[tm[placed]]).mean() > 0.97
    for r in reads:
        placed = r.cols >= 0
        assert (np.diff(r.cols[placed]) > 0).all()
