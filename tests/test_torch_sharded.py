"""The port's mesh path (parallel/sharded.py on torch.distributed) on the
CPU: two gloo ranks, each a process of its own.

One spawn runs every scenario in both ranks (`_rank_work`); the tests
then hold what the ranks wrote against the port's single-process run and
against the JAX package's mesh run on its virtual 8-device CPU mesh.
Integer results (score log, final MSA, files) are compared exactly. The
striped MaxCorrs scan is bit-equal to the port's single scan (a max is
exact) and within 1e-5 of the JAX mesh scan, the float32 tolerance
tests/test_torch_maxcorr.py states for the two frameworks.
"""
import os

import numpy as np
import pytest
import torch

from repeatresolver_tpu_torch.config import MaxCorrConfig, RealignerConfig

torch.set_num_threads(1)

RANK_TIMEOUT_S = 420.0
MC_CFG = dict(mincov=20)


def make_msa(seed=0, rows=12, tlen=220):
    """tests/test_batched_realigner.make_msa (copied: the ranks import
    this module, and must not import jax)."""
    rng = np.random.default_rng(seed)
    tpl = rng.integers(0, 4, tlen)
    msa = np.full((rows, tlen), 5, np.int8)
    for r in range(rows):
        lo = rng.integers(0, 25)
        hi = tlen - rng.integers(0, 25)
        seg = tpl[lo:hi].copy()
        sub = rng.random(len(seg)) < 0.08
        seg[sub] = rng.integers(0, 4, sub.sum())
        gap = rng.random(len(seg)) < 0.10
        seg[gap] = 4
        msa[r, lo:hi] = seg
    return msa


def maxcorr_msa():
    """tests/test_sharded.py's MaxCorrs fixture: 60 rows, 2 copy groups,
    6 planted SNP columns, ragged coverage."""
    rng = np.random.default_rng(5)
    rows, cols = 60, 400
    consensus = rng.integers(0, 4, cols)
    msa = np.tile(consensus, (rows, 1)).astype(np.int8)
    group = np.arange(rows) % 2
    for cc in [50, 90, 140, 200, 260, 330]:
        msa[group == 1, cc] = (consensus[cc] + 1) % 4
    for rr in range(rows):
        lo = rng.integers(0, 25)
        hi = cols - rng.integers(0, 25)
        msa[rr, :lo] = 5
        msa[rr, hi:] = 5
    return msa


def wide_drift_msa():
    """Six rows whose bases lie in two clusters more than 16 chunks of
    columns apart (no ladder rung covers their drift at chunk 256), over
    22 shorter rows that tile the span between the clusters, so that its
    columns stay. The six are the longest rows: the first block of 6."""
    rng = np.random.default_rng(21)
    cols = 4700
    tpl = rng.integers(0, 4, cols)
    msa = np.full((28, cols), 5, np.int8)

    def place(r, lo, hi):
        seg = tpl[lo:hi].copy()
        sub = rng.random(len(seg)) < 0.1
        seg[sub] = rng.integers(0, 4, int(sub.sum()))
        msa[r, lo:hi] = seg

    for r in range(6):
        place(r, 10 + r, 130)
        place(r, 4500, 4640 - r)
        msa[r, 130:4500] = 4
    for i in range(22):
        place(6 + i, 130 + i * 199, 130 + i * 199 + 200)
    return msa


# name -> (msa, RealignerConfig kwargs, realign_batched kwargs)
SCENARIOS = {
    "exact": (lambda: make_msa(7, rows=20, tlen=300),
              dict(bandwidth=96, block_rows=16),
              dict(mode="exact", kernel="native")),
    "staircase": (lambda: make_msa(7, rows=20, tlen=300),
                  dict(bandwidth=96, block_rows=16),
                  dict(mode="staircase", kernel="torch")),
    "staircase_kernels": (lambda: make_msa(11, rows=18, tlen=280),
                          dict(bandwidth=96, block_rows=16),
                          dict(mode="staircase", kernel="cuda")),
    "uneven": (lambda: make_msa(9, rows=13, tlen=260),
               dict(bandwidth=96, block_rows=5),
               dict(mode="exact", kernel="native")),
    "wide_drift": (wide_drift_msa, dict(bandwidth=64, block_rows=6,
                                        max_rounds=2),
                   dict(mode="staircase", kernel="torch", anneal=False)),
}


def run_scenario(name, mesh=None, **extra):
    from repeatresolver_tpu_torch.models import realigner as pr
    make, cfg_kw, kw = SCENARIOS[name]
    log: list = []
    out = pr.realign_batched(make(), RealignerConfig(**cfg_kw),
                             score_log=log, mesh=mesh, device="cpu",
                             **{**kw, **extra})
    return np.array(log, np.int64), out


def _rank_work(rank, n, outdir):
    """Everything a rank does, in one process group."""
    torch.set_num_threads(1)
    from repeatresolver_tpu_torch.models import maxcorr as pmc
    from repeatresolver_tpu_torch.models import realigner as pr
    from repeatresolver_tpu_torch.parallel import sharded
    mesh = sharded.make_mesh(n, backend="gloo", device="cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (rank, n, "gloo")
    res = {}
    for name in SCENARIOS:
        extra = {}
        if name == "exact":          # rank 0 alone writes these
            extra = dict(out_path=os.path.join(outdir, "exact_MSAreal"),
                         score_log_path=os.path.join(outdir, "exact_log"),
                         checkpoint_path=os.path.join(outdir, "exact.ckpt"))
        res[name + "_log"], res[name + "_out"] = run_scenario(
            name, mesh, **extra)
    # a budget of one byte halves every block above 8 rows
    sizes = []
    orig = pr.BatchedRealigner._realign_block_mesh

    def counting(self, rows, *a):
        sizes.append(len(rows))
        return orig(self, rows, *a)

    pr.BatchedRealigner._realign_block_mesh = counting
    os.environ["RR_DEVICE_HBM_BUDGET"] = "1"
    try:
        res["budget_log"], res["budget_out"] = run_scenario("exact", mesh)
    finally:
        del os.environ["RR_DEVICE_HBM_BUDGET"]
        pr.BatchedRealigner._realign_block_mesh = orig
    res["budget_sizes"] = np.array(sizes)
    res["maxcorr"] = pmc.compute_maxcorrs_device(
        maxcorr_msa(), MaxCorrConfig(**MC_CFG), tile=64, mesh=mesh)
    res["staged"] = np.array(mesh.staged)
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **res)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repeatresolver_tpu_torch.parallel import sharded
    outdir = str(tmp_path_factory.mktemp("mesh"))
    sharded.spawn(_rank_work, 2, (outdir,), backend="gloo",
                  timeout=RANK_TIMEOUT_S)
    out = [dict(np.load(os.path.join(outdir, f"rank{r}.npz")))
           for r in range(2)]
    for key in out[0]:               # the host state stayed replicated
        np.testing.assert_array_equal(out[0][key], out[1][key], err_msg=key)
    return outdir, out[0]


def _jax_mesh_run(name):
    from repeatresolver_tpu.config import RealignerConfig as JCfg
    from repeatresolver_tpu.models import realigner as jr
    from repeatresolver_tpu.parallel import sharded as jsharded
    make, cfg_kw, kw = SCENARIOS[name]
    kw = dict(kw)
    kw["kernel"] = {"torch": "xla", "cuda": "pallas"}.get(kw["kernel"],
                                                          kw["kernel"])
    log: list = []
    out = jr.realign_batched(make(), JCfg(**cfg_kw), score_log=log,
                             mesh=jsharded.make_mesh(8), **kw)
    return np.array(log, np.int64), out


@pytest.mark.parametrize("name", ["exact", "staircase", "staircase_kernels",
                                  "uneven"])
def test_mesh_realign_matches_single_process_and_jax_mesh(ranks, name):
    """Score log and final MSA of realign_batched(mesh=...) on two gloo
    ranks == the port's single-process run == the JAX package's run on
    its 8-device mesh (its Pallas pair in interpret mode for
    "staircase_kernels"; "uneven": 13 rows in blocks of 5, padded to the
    mesh size in both)."""
    _, res = ranks
    log_s, out_s = run_scenario(name)
    np.testing.assert_array_equal(res[name + "_log"], log_s)
    np.testing.assert_array_equal(res[name + "_out"], out_s)
    assert log_s.tolist() and min(map(tuple, log_s)) < tuple(log_s[0])
    log_j, out_j = _jax_mesh_run(name)
    np.testing.assert_array_equal(res[name + "_log"], log_j)
    np.testing.assert_array_equal(res[name + "_out"], out_j)


def test_rank_0_alone_writes_the_files(ranks):
    from repeatresolver_tpu_torch.utils import checkpoint as ckpt
    from repeatresolver_tpu_torch.utils import io as rio
    outdir, res = ranks
    np.testing.assert_array_equal(
        rio.read_msa(os.path.join(outdir, "exact_MSAreal")),
        res["exact_out"])
    with open(os.path.join(outdir, "exact_log")) as f:
        lines = f.read().splitlines()
    # one line a check, written once: "round score width"
    assert [int(ln.split()[1]) for ln in lines] == \
        [int(m) * 1000000 + int(u) for m, u in res["exact_log"]]
    ck = ckpt.RealignCheckpoint.load(os.path.join(outdir, "exact.ckpt"))
    assert (ck.best_mille, ck.best_uno) == min(
        map(tuple, res["exact_log"].tolist()))


def test_mesh_blocks_respect_memory_budget(ranks, monkeypatch):
    """With a budget of one byte every block above 8 rows is halved, on
    the mesh (bound per rank) and in the single process alike."""
    _, res = ranks
    assert len(res["budget_sizes"]) and res["budget_sizes"].max() <= 8
    monkeypatch.setenv("RR_DEVICE_HBM_BUDGET", "1")
    log_s, out_s = run_scenario("exact", kernel="torch")
    np.testing.assert_array_equal(res["budget_log"], log_s)
    np.testing.assert_array_equal(res["budget_out"], out_s)


def test_mesh_widen_quirk_top_rung_against_exact_switch(ranks):
    """Where no ladder rung covers a block's drift, the port's mesh step
    switches the block to the exact band, as its single-process step
    does: the port's mesh run equals its single-process run and the JAX
    package's single-process run, bit for bit. The JAX package's mesh
    step takes the top rung instead (a window that does not cover the
    drift); the last assertion records that its mesh run differs from
    the three."""
    from repeatresolver_tpu.config import RealignerConfig as JCfg
    from repeatresolver_tpu.models import realigner as jr
    from repeatresolver_tpu_torch.models.realigner import (
        BatchedRealigner, chunk_drift, compact_rows)
    _, res = ranks
    msa = wide_drift_msa()
    _, ways, _ = compact_rows(msa)
    assert chunk_drift(ways, 256) > BatchedRealigner.WIDEN_LADDER[-1] * 256
    log_s, out_s = run_scenario("wide_drift")
    np.testing.assert_array_equal(res["wide_drift_log"], log_s)
    np.testing.assert_array_equal(res["wide_drift_out"], out_s)
    log_e, out_e = run_scenario("wide_drift", mode="exact")
    np.testing.assert_array_equal(log_s, log_e)     # the exact switch
    np.testing.assert_array_equal(out_s, out_e)
    _, cfg_kw, kw = SCENARIOS["wide_drift"]
    log_j: list = []
    out_j = jr.realign_batched(msa, JCfg(**cfg_kw), score_log=log_j,
                               **{**kw, "kernel": "xla"})
    np.testing.assert_array_equal(res["wide_drift_log"],
                                  np.array(log_j, np.int64))
    np.testing.assert_array_equal(res["wide_drift_out"], out_j)
    log_jm, _ = _jax_mesh_run("wide_drift")
    assert log_jm.tolist() != res["wide_drift_log"].tolist()


def test_mesh_maxcorrs_striped_scan(ranks):
    from repeatresolver_tpu.config import MaxCorrConfig as JCfg
    from repeatresolver_tpu.models import maxcorr as jmc
    from repeatresolver_tpu.parallel import sharded as jsharded
    from repeatresolver_tpu_torch.models import maxcorr as pmc
    _, res = ranks
    msa = maxcorr_msa()
    cfg = MaxCorrConfig(**MC_CFG)
    single = pmc.compute_maxcorrs_device(msa, cfg, tile=64, device="cpu")
    np.testing.assert_array_equal(res["maxcorr"], single)
    jax_mesh = jmc.compute_maxcorrs_device(msa, JCfg(**MC_CFG), tile=64,
                                           mesh=jsharded.make_mesh(4))
    np.testing.assert_allclose(res["maxcorr"], jax_mesh, rtol=0, atol=1e-5)
    cutoff = cfg.resolved_cutoff(msa.shape[1])
    assert (res["maxcorr"].reshape(-1, 5).max(axis=1)[
        [50, 90, 140, 200, 260, 330]] > cutoff).all()


def test_gloo_takes_cpu_tensors_unstaged(ranks):
    _, res = ranks
    assert int(res["staged"]) == 0


def test_sharded_realign_step_counts_consistent():
    """The summed histogram delta equals a recount of the rewritten
    rows (single-rank mesh; the two-rank step runs in dryrun)."""
    from repeatresolver_tpu_torch.parallel import sharded
    mesh = sharded.make_mesh(1, device="cpu")
    assert (mesh.size, mesh.backend) == (1, "none")
    with pytest.raises(ValueError, match="need 2 ranks"):
        sharded.make_mesh(2, device="cpu")
    rng = np.random.default_rng(1)
    r, c, l, w = 4, 300, 256, 128
    msa = np.full((r, c), 5, np.int8)
    for k in range(r):
        seg = rng.integers(0, 4, c - 60).astype(np.int8)
        seg[rng.random(c - 60) < 0.1] = 4
        msa[k, 30:c - 30] = seg
    counts = np.stack([(msa == s).sum(axis=0) for s in range(6)],
                      axis=1).astype(np.int32)
    from repeatresolver_tpu_torch.models.realigner import compact_rows
    seqs, ways, lengths = compact_rows(msa, l)
    step = sharded.sharded_realign_step(mesh, ncols=c, bandwidth=w)
    new_rows, new_counts, best = step(counts, msa, seqs, ways, lengths)
    expect = counts.copy()
    for s in range(6):
        expect[:, s] += (new_rows == s).sum(axis=0) - (msa == s).sum(axis=0)
    np.testing.assert_array_equal(new_counts, expect)
    assert best.shape == (r,)
