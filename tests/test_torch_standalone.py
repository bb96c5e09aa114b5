"""The port stands alone, and its copies still equal their originals.

Independence:
  * a fresh interpreter imports every module of repeatresolver_tpu_torch
    and runs the tiny CPU pipeline (`cli pipeline -c 8 -n 4 -l 2000 -b
    200 --device cpu`); afterwards no module named `jax`,
    `repeatresolver_tpu` or below either is loaded;
  * no source file of the port, and not chip_smoke.py, names the JAX
    package in an import;
  * the run leaves native/libhostops.so as it was (same mtime, same
    bytes): the port builds its own host library under build/host/;
  * every subcommand the two CLIs share takes the same flags with the
    same defaults, apart from the port's --device.

Copies: the port keeps its own copy of the JAX package's jax-free host
modules. Each copy gets the same numpy inputs from a seed as its
original and must return the same result: files byte for byte, integers
and float64 values exactly (tolerance 0: the code is the same).
"""
import hashlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_SO = os.path.join(REPO, "native", "libhostops.so")
IMPORT_OF_JAX_PACKAGE = re.compile(
    r"^\s*(from|import)\s+(repeatresolver_tpu|jax)(\.|\s|$)", re.M)


def _so_state():
    st = os.stat(HOST_SO)
    with open(HOST_SO, "rb") as f:
        return st.st_mtime_ns, hashlib.sha1(f.read()).hexdigest()


@pytest.fixture(scope="module")
def standalone_run(tmp_path_factory):
    """The tiny CPU pipeline through the port's CLI in a fresh
    interpreter; returns (work directory, completed process,
    libhostops.so state before, after)."""
    work = tmp_path_factory.mktemp("standalone")
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {REPO!r})
import torch
torch.set_num_threads(1)
import repeatresolver_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                              pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
print("PORT-MODULES", " ".join(sorted(mods)))
from repeatresolver_tpu_torch import cli
cli.main(["pipeline", "-c", "8", "-n", "4", "-l", "2000", "-b", "200",
          "-w", {str(work / "run")!r}, "--device", "cpu"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "repeatresolver_tpu"))
print("FOREIGN-MODULES", bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    # the JAX package's own binding rebuilds a stale library in place at
    # first use: let that happen before the state is taken
    from repeatresolver_tpu.utils import native as jn
    jn.get_lib()
    before = _so_state()
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600, cwd=str(work))
    return work / "run", res, before, _so_state()


def test_fresh_interpreter_loads_no_jax_and_no_jax_package(standalone_run):
    _, res, _, _ = standalone_run
    assert res.returncode == 0, res.stderr[-3000:]
    assert "[assess multi]" in res.stdout
    assert "FOREIGN-MODULES []" in res.stdout, res.stdout[-500:]
    mods = next(ln for ln in res.stdout.splitlines()
                if ln.startswith("PORT-MODULES")).split()[1:]
    for name in ("parallel.sharded", "parallel.multihost", "graft_entry",
                 "ops.myers", "ops.banded_realign"):
        assert "repeatresolver_tpu_torch." + name in mods, name


def test_no_source_file_imports_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "repeatresolver_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    hits = []
    for path in files:
        with open(path) as f:
            for m in IMPORT_OF_JAX_PACKAGE.finditer(f.read()):
                hits.append((os.path.relpath(path, REPO), m.group(0).strip()))
    assert not hits, hits


def test_run_leaves_the_old_host_library_alone(standalone_run):
    _, res, before, after = standalone_run
    assert res.returncode == 0, res.stderr[-3000:]
    assert before == after
    from repeatresolver_tpu_torch.utils import native as pnat
    so = pnat._build()
    assert os.path.dirname(so) == os.path.join(REPO, "build", "host")
    assert os.path.exists(so)


# ---------------------------------------------------------------- copies

def _files(d):
    out = {}
    for n in sorted(os.listdir(d)):
        with open(os.path.join(d, n), "rb") as f:
            out[n] = f.read()
    return out


def _small_msa(seed, rows=24, cols=600):
    rng = np.random.default_rng(seed)
    cons = rng.integers(0, 4, cols)
    msa = np.tile(cons, (rows, 1)).astype(np.int8)
    half = rows // 2
    snps = rng.choice(cols, 12, replace=False)
    msa[half:, snps] = (msa[half:, snps] + 1) % 4
    noise = rng.random(msa.shape) < 0.04
    msa[noise] = rng.integers(0, 5, int(noise.sum()))
    for r in range(rows):
        a, b = rng.integers(0, 40), rng.integers(0, 40)
        msa[r, :a] = 5
        msa[r, cols - b:] = 5
    return msa


def _case_io(tmp_path, run_dir):
    from repeatresolver_tpu.utils import io as jio
    from repeatresolver_tpu_torch.utils import io as pio
    rng = np.random.default_rng(1)
    seqs = [rng.integers(0, 4, n).astype(np.int8) for n in (1, 99, 100, 257)]
    msa = _small_msa(2)
    mc = rng.random(40) * 30
    sub = rng.integers(-1, 4, 30)
    info = [3, 1, 0, 2]
    for mod, d in ((jio, tmp_path / "j"), (pio, tmp_path / "p")):
        d.mkdir()
        mod.write_fasta(d / "x.fasta", seqs)
        mod.write_msa(d / "x_MSA", msa)
        mod.write_msa(d / "x_MSAreal", msa, upper=True)
        mod.write_maxcorrs(d / "mc", mc)
        mod.write_subdivision(d / "sub", sub)
        mod.write_ints(d / "ints", sub)
        mod.write_readseqinfo(d / "rsi", info)
    assert _files(tmp_path / "j") == _files(tmp_path / "p")
    d = tmp_path / "j"
    for a, b in zip(jio.read_fasta(d / "x.fasta"), pio.read_fasta(
            d / "x.fasta"), strict=True):
        np.testing.assert_array_equal(a, b)
    for name in ("x_MSA", "x_MSAreal"):
        got = pio.read_msa(d / name)
        np.testing.assert_array_equal(got, jio.read_msa(d / name))
        np.testing.assert_array_equal(got, msa)
    np.testing.assert_array_equal(pio.read_maxcorrs(d / "mc"),
                                  jio.read_maxcorrs(d / "mc"))
    np.testing.assert_array_equal(pio.read_ints(d / "sub"),
                                  jio.read_ints(d / "sub"))
    np.testing.assert_array_equal(pio.read_readseqinfo(d / "rsi"),
                                  jio.read_readseqinfo(d / "rsi"))
    np.testing.assert_array_equal(pio.read_template(d / "x.fasta"),
                                  jio.read_template(d / "x.fasta"))
    assert pio.derived_paths("a/N_Template.fasta") == \
        jio.derived_paths("a/N_Template.fasta")
    assert pio.maxcorrs_path("a/N_MSAreal") == jio.maxcorrs_path("a/N_MSAreal")
    assert pio.subdivision_path("Kmeans", 3, 9, "a/N") == \
        jio.subdivision_path("Kmeans", 3, 9, "a/N")
    assert pio.encode_seq("acgt-x").tolist() == jio.encode_seq(
        "acgt-x").tolist()


def _case_config(tmp_path, run_dir):
    import dataclasses

    from repeatresolver_tpu import config as jc
    from repeatresolver_tpu_torch import config as pc
    import repeatresolver_tpu as jpkg
    import repeatresolver_tpu_torch as ppkg
    for name in ("A", "C", "G", "T", "GAP", "SPACE", "SYMBOLS",
                 "SYMBOLS_UPPER"):
        assert getattr(ppkg, name) == getattr(jpkg, name)
    assert dataclasses.asdict(pc.PipelineConfig()) == \
        dataclasses.asdict(jc.PipelineConfig())
    assert dataclasses.asdict(pc.small_sim()) == \
        dataclasses.asdict(jc.small_sim())
    for d in (0.01, 0.005, 0.1, 0.025):
        assert pc.SimulatorConfig(difference=d).dataset_name == \
            jc.SimulatorConfig(difference=d).dataset_name
    assert pc.MaxCorrConfig().resolved_cutoff(777) == \
        jc.MaxCorrConfig().resolved_cutoff(777)
    assert pc.ResolverConfig(cov=9).mingroup == jc.ResolverConfig(
        cov=9).mingroup


def _case_checkpoint(tmp_path, run_dir):
    from repeatresolver_tpu.utils import checkpoint as jck
    from repeatresolver_tpu_torch.utils import checkpoint as pck
    msa = _small_msa(3, rows=7, cols=101)
    kw = dict(msa=msa, round=4, best_mille=12, best_uno=345678,
              bandwidth=200, block_rows=16, widen_bs=16,
              widen=np.array([6, 8], np.int32),
              exact_blocks=np.array([1], np.int64))
    jck.RealignCheckpoint(**kw).save(str(tmp_path / "j.npz"))
    pck.RealignCheckpoint(**kw).save(str(tmp_path / "p.npz"))
    for mod in (jck, pck):                # each reads the other's file
        for name in ("j.npz", "p.npz"):
            c = mod.RealignCheckpoint.load(str(tmp_path / name))
            np.testing.assert_array_equal(c.msa, msa)
            assert (c.round, c.best_mille, c.best_uno, c.bandwidth,
                    c.block_rows, c.widen_bs) == (4, 12, 345678, 200, 16, 16)
            assert c.widen.tolist() == [6, 8]
            assert c.exact_blocks.tolist() == [1]


def _case_simulator(tmp_path, run_dir):
    from repeatresolver_tpu.config import SimulatorConfig as JCfg
    from repeatresolver_tpu.models import simulator as jsim
    from repeatresolver_tpu_torch.config import SimulatorConfig as PCfg
    from repeatresolver_tpu_torch.models import simulator as psim
    for structure in ("Tree", "Distributed", "EquiDistant"):
        kw = dict(coverage=5, copynumber=4, repeatlength=1500,
                  difference=0.02, flank=800, seed=13, structure=structure)
        dj, dp = tmp_path / ("j" + structure), tmp_path / ("p" + structure)
        dj.mkdir()
        dp.mkdir()
        jsim.simulate(JCfg(**kw)).write(dj)
        psim.simulate(PCfg(**kw)).write(dp)
        fj = _files(dj)
        assert len(fj) == 4 and fj == _files(dp), structure


def _case_window(tmp_path, run_dir):
    from repeatresolver_tpu.config import WindowConfig
    from repeatresolver_tpu.models.window import window_boundaries as jw
    from repeatresolver_tpu_torch.models.window import \
        window_boundaries as pw
    msa = _small_msa(4, rows=12, cols=5000)
    msa[:9, :700] = 5
    msa[:10, 4400:] = 5
    for parts in (4, 6):
        cfg = WindowConfig(parts=parts)
        assert pw(msa, cfg) == jw(msa, cfg)
    assert len(pw(msa, WindowConfig())) == 7


def _case_assessment(tmp_path, run_dir):
    from repeatresolver_tpu.models import assessment as ja
    from repeatresolver_tpu_torch.models import assessment as pa
    sj, mj = ja.assess_directory(str(run_dir), str(run_dir))
    sp, mp = pa.assess_directory(str(run_dir), str(run_dir))
    assert len(sp) == len(sj) == 6
    for a, b in zip(sp + [mp], sj + [mj]):
        assert (a.truepositives, a.falsepositives) == \
            (b.truepositives, b.falsepositives)
    rng = np.random.default_rng(5)
    gt = rng.integers(0, 3, 40)
    sigs = rng.integers(0, 4, (40, 60)).astype(np.int8)
    for fn in ("resolvability", "half_resolvability"):
        rj, rp = getattr(ja, fn)(gt, sigs), getattr(pa, fn)(gt, sigs)
        for a, b in zip(rp, rj):
            if isinstance(a, dict):
                assert a == b
            else:
                np.testing.assert_array_equal(a, b)


def _case_hypergeom(tmp_path, run_dir):
    from repeatresolver_tpu.ops import hypergeom as jh
    from repeatresolver_tpu_torch.ops import hypergeom as ph
    rng = np.random.default_rng(6)
    n = 400
    cov = rng.integers(8, 300, n)
    gr1 = (rng.random(n) * cov).astype(np.int64) + 1
    gr2 = (rng.random(n) * cov).astype(np.int64) + 1
    s = np.minimum((rng.random(n) * np.minimum(gr1, gr2)).astype(np.int64)
                   + 1, np.minimum(gr1, gr2))
    sz1 = gr1 + rng.integers(0, 20, n)
    sz2 = gr2 + rng.integers(0, 20, n)
    for fn, args in (("positive_cum_hyp_geo_log", (s, gr1, gr2, cov)),
                     ("cum_hyp_geo_log", (s, gr1, gr2, cov)),
                     ("positive_significance", (s, gr1, gr2, cov, sz1, sz2)),
                     ("positive_significance_fast",
                      (s, gr1, gr2, cov, sz1, sz2)),
                     ("f_beta", (s, sz1, sz2)),
                     ("hyp_q", (s, gr2, cov - gr2, gr1)),
                     ("hyp_p", (s, gr2, cov - gr2, gr1)),
                     ("binom_q", (int(s[0]), 0.25, int(cov[0])))):
        got = np.asarray(getattr(ph, fn)(*args))
        ref = np.asarray(getattr(jh, fn)(*args))
        assert got.dtype == ref.dtype and got.shape == ref.shape, fn
        np.testing.assert_array_equal(got, ref, err_msg=fn)
    assert np.isfinite(ph.positive_significance(s, gr1, gr2, cov, sz1,
                                                sz2)).all()


def _case_maxcorr_host(tmp_path, run_dir):
    from repeatresolver_tpu.config import MaxCorrConfig
    from repeatresolver_tpu.models import maxcorr as jm
    from repeatresolver_tpu_torch.models import maxcorr as pm
    msa = _small_msa(7)
    cfg = MaxCorrConfig(mincov=8)
    for a, b in zip(pm.group_matrices(msa), jm.group_matrices(msa),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    for fast in (False, True):
        got = pm.compute_maxcorrs(msa, cfg, tile=128, fast=fast,
                                  native="never")
        ref = jm.compute_maxcorrs(msa, cfg, tile=128, fast=fast,
                                  native="never")
        np.testing.assert_array_equal(got, ref)
    assert (ref > cfg.resolved_cutoff(msa.shape[1])).any()
    got = pm.compute_maxcorrs_native(msa, cfg, threads=2, progress=False)
    ref = jm.compute_maxcorrs_native(msa, cfg, threads=2, progress=False)
    np.testing.assert_array_equal(got, ref)
    pm.run(str(run_dir / "Tree_1perc_2000kb_MSAreal"), cfg,
           out_path=str(tmp_path / "p"), native="never")
    jm.run(str(run_dir / "Tree_1perc_2000kb_MSAreal"), cfg,
           out_path=str(tmp_path / "j"), native="never")
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()


def _case_realigner_host(tmp_path, run_dir):
    from repeatresolver_tpu.models import realigner as jr
    from repeatresolver_tpu_torch.models import realigner as pr
    msa = _small_msa(8)
    msa[:, 100:103] = 5                   # empty columns to drop
    msa[3, 40:60] = 4                     # an inner gap run
    cj, cp = jr.symbol_counts(msa), pr.symbol_counts(msa)
    np.testing.assert_array_equal(cp, cj)
    assert pr.overall_score_pair(cp) == jr.overall_score_pair(cj)
    pr.validate_counts(msa, cp)
    with pytest.raises(AssertionError):
        pr.validate_counts(msa, cp + 1)
    ej, ep = jr.RealignEngine(msa.copy(), 64), pr.RealignEngine(
        msa.copy(), 64)
    assert ep.ent_al_gapper() == ej.ent_al_gapper() > 0
    np.testing.assert_array_equal(ep.msa, ej.msa)
    np.testing.assert_array_equal(ep.counts, ej.counts)
    assert ep.overall_pair() == ej.overall_pair()
    assert ep.msa.shape[1] < msa.shape[1]
    rng = np.random.default_rng(9)
    for n in (3, 90):                     # slice copies; the native merge
        pos = np.sort(rng.integers(0, msa.shape[1] + 1, n)).tolist()
        cols = rng.integers(0, 6, (n, msa.shape[0])).astype(np.int8)
        ref = np.insert(msa, pos, cols.T, axis=1)
        np.testing.assert_array_equal(jr._splice_cols(msa, pos, cols), ref)
        np.testing.assert_array_equal(pr._splice_cols(msa, pos, cols), ref)
        rows = rng.integers(0, 9, (n, 6))
        posr = np.sort(rng.integers(0, len(cj) + 1, n)).tolist()
        np.testing.assert_array_equal(pr._splice_rows(cj, posr, rows),
                                      jr._splice_rows(cj, posr, rows))


def _case_resolver_host(tmp_path, run_dir):
    from repeatresolver_tpu.config import ResolverConfig
    from repeatresolver_tpu.models import maxcorr as jm
    from repeatresolver_tpu.models import resolver as jres
    from repeatresolver_tpu.ops import devmm as jdevmm
    from repeatresolver_tpu_torch.models import resolver as pres
    msa = _small_msa(10, rows=32, cols=400)
    cov = 8
    mc = np.asarray(jm.compute_maxcorrs(msa, jm.MaxCorrConfig(mincov=cov),
                                        native="never"))
    cfg = ResolverConfig(cov=cov)
    von, bis = 50, 349
    wj, wp = jres.extract_window(msa, von, bis), pres.extract_window(
        msa, von, bis)
    np.testing.assert_array_equal(wp.signatures, wj.signatures)
    np.testing.assert_array_equal(wp.ausgelassen, wj.ausgelassen)
    assert (wp.von, wp.bis, wp.signumber) == (wj.von, wj.bis, wj.signumber)
    gj, gp = jres.GroupData.from_window(wj), pres.GroupData.from_window(wp)
    for name in ("groups", "coverage", "sizes", "covcount"):
        np.testing.assert_array_equal(getattr(gp, name), getattr(gj, name))
    mcw = mc.reshape(-1, 5)[von:wj.bis + 1].reshape(-1).copy()
    cutoff = cfg.resolved_cutoff(wj.siglength)
    state = dict(jdevmm._state)
    jdevmm._state["on"] = False           # the JAX package's host products
    try:
        rj = jres.group_refinement(gj, mcw, cutoff, cfg.cov, cfg.maxclique,
                                   cutoff, cfg.min_clique_size)
    finally:
        jdevmm._state.clear()
        jdevmm._state.update(state)
    rp = pres.group_refinement(gp, mcw, cutoff, cfg.cov, cfg.maxclique,
                               cutoff, cfg.min_clique_size, device="cpu")
    assert rp.cliques == rj.cliques and len(rj.cliques) > 0
    assert rp.sizes == rj.sizes and rp.cutoffs == rj.cutoffs
    assert rp.dropoff == rj.dropoff
    seed = next(iter(rj.cliques))
    cl = rj.cliques[seed]
    upto = pres.sizes_trunc(cl)
    assert upto == jres.sizes_trunc(cl) > 0
    mj = jres.membership_counts(gj, cl, upto)
    np.testing.assert_array_equal(pres.membership_counts(gp, cl, upto), mj)
    np.testing.assert_array_equal(pres._cutoff_sizes(mj, upto),
                                  jres._cutoff_sizes(mj, upto))
    c = rj.cutoffs[seed]
    np.testing.assert_array_equal(pres.clique_group(gp, cl, c),
                                  jres.clique_group(gj, cl, c))
    np.testing.assert_array_equal(pres.clique_coverage(gp, cl, c),
                                  jres.clique_coverage(gj, cl, c))
    sz = np.sort(np.random.default_rng(3).integers(1, 30, 12))[::-1].astype(
        np.float64)
    assert pres.dropoff_cutoff(sz, wj.signumber, 2) == \
        jres.dropoff_cutoff(sz, wj.signumber, 2)
    cand = np.arange(3, 40, 3)
    z = np.random.default_rng(4).random(len(cand)) * 10
    assert pres._cliquer_from_stats(cand, z, 7, 6, 2.0) == \
        jres._cliquer_from_stats(cand, z, 7, 6, 2.0)
    args = (cutoff, cfg.dropoffcutoff, cfg.sizecutoff, cfg.mingroup)
    uj = jres.dropoff_subdivision(rj, *args, wj.signumber)
    up = pres.dropoff_subdivision(rp, *args, wp.signumber)
    np.testing.assert_array_equal(up, uj)
    assert uj.max() >= 1                  # the window really subdivides
    jres.relative_dropoff_subdivision(gj, rj, uj, *args)
    pres.relative_dropoff_subdivision(gp, rp, up, *args)
    np.testing.assert_array_equal(up, uj)
    assert rp.dropoff == rj.dropoff
    a, b = up.copy() + 3, uj.copy() + 3
    assert pres.komprimierung(a) == jres.komprimierung(b)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pres.komplettierung(a, wp.ausgelassen),
                                  jres.komplettierung(b, wj.ausgelassen))


def _case_resolver_leftovers(tmp_path, run_dir):
    """The nine functions the product path leaves aside."""
    from repeatresolver_tpu.models import resolver as jres
    from repeatresolver_tpu_torch.models import resolver as pres
    msa = _small_msa(10, rows=32, cols=400)
    wj, wp = jres.extract_window(msa, 50, 349), pres.extract_window(
        msa, 50, 349)
    gj, gp = jres.GroupData.from_window(wj), pres.GroupData.from_window(wp)
    rng = np.random.default_rng(14)
    n = gj.groups.shape[1]
    for _ in range(4):
        vecs = [(rng.random(n) < q).astype(np.float64)
                for q in (0.4, 0.5, 0.9, 0.9)]
        assert pres.group_positive_significance(*vecs) == \
            jres.group_positive_significance(*vecs)
    zero = np.zeros(n)
    assert pres.group_positive_significance(zero, vecs[1], zero, zero) == 0.0
    # seeds: the groups of about half the rows (the planted SNPs)
    seeds = [int(i) for i in np.nonzero((gj.sizes > 8)
                                        & (gj.sizes < 24))[0][:6]]
    cliques = []
    for seed in seeds:
        cj = jres.cliquer(gj, 8, 7, 1.5, seed)
        assert pres.cliquer(gp, 8, 7, 1.5, seed) == cj
        cliques.append(cj)
    assert any(jres.clique_len(c) > 1 for c in cliques)
    for gr in (5, 99, 100, 999, 1000, 1999, 2000, 31337):
        assert pres.core_cutoff(gr) == jres.core_cutoff(gr)
    u = rng.integers(0, 3, n)
    for seed, cl in zip(seeds, cliques):
        upto = jres.sizes_trunc(cl)
        for c in (0, 1, 5, 20):
            np.testing.assert_array_equal(pres.core_group(gp, cl, c),
                                          jres.core_group(gj, cl, c))
        assert pres.korrmax_cutoff(gp, cl, upto, 0, seed) == \
            jres.korrmax_cutoff(gj, cl, upto, 0, seed)
        for k in range(3):
            assert pres.relative_dropoff_cutoff(gp, cl, upto, u, k, n) == \
                jres.relative_dropoff_cutoff(gj, cl, upto, u, k, n)
    for args in ((40, 60, 6, 0.8, 0.3), (10, 10, 4, 0.5, 0.5)):
        assert pres.best_cutoff(*args) == jres.best_cutoff(*args)
    subs = [rng.integers(-1, 4, 50) for _ in range(4)]
    np.testing.assert_array_equal(pres.probability_chain(subs),
                                  jres.probability_chain(subs))
    bf = pres.back_and_forth(subs)
    np.testing.assert_array_equal(bf, jres.back_and_forth(subs))
    assert bf.shape == (4, 4) and bf.max() > 0


def _case_myers(tmp_path, run_dir):
    from repeatresolver_tpu.ops import myers as jm
    from repeatresolver_tpu_torch.ops import myers as pm
    rng = np.random.default_rng(3)
    pattern = rng.integers(0, 4, 40).astype(np.int16)
    texts = rng.integers(0, 4, (5, 200)).astype(np.int16)
    texts[2, 60:100] = pattern            # a planted exact occurrence
    texts[4, 150:] = 100                  # padding past a short text
    got = pm.last_rows_batch(pattern, texts)
    np.testing.assert_array_equal(got, jm.last_rows_batch(pattern, texts))
    assert got[2, 99] == 0
    for i in (0, 2):
        np.testing.assert_array_equal(pm.last_row(pattern, texts[i]),
                                      jm.last_row(pattern, texts[i]))
        np.testing.assert_array_equal(pm.last_row(pattern, texts[i]), got[i])


def _case_realigner_serial(tmp_path, run_dir):
    """The serial engine's numpy row DP, row by row, and `realign`."""
    from repeatresolver_tpu.config import RealignerConfig
    from repeatresolver_tpu.models import realigner as jr
    from repeatresolver_tpu_torch.models import realigner as pr
    assert pr.HUGE == jr.HUGE
    msa = _small_msa(15, rows=10, cols=180)
    ej, ep = jr.RealignEngine(msa.copy(), 48), pr.RealignEngine(
        msa.copy(), 48)
    ej.ent_al_gapper()
    ep.ent_al_gapper()
    for k in range(10):
        assert ep.realign_row(k) == ej.realign_row(k)
        np.testing.assert_array_equal(ep.msa, ej.msa)
        np.testing.assert_array_equal(ep.counts, ej.counts)
        assert pr.row_score(ep.msa, ep.counts, k) == \
            jr.row_score(ej.msa, ej.counts, k)
    assert ep.msa.shape[1] != msa.shape[1] or (ep.msa != msa).any()
    assert ep.overall_pair() == ej.overall_pair()
    cfg = RealignerConfig(bandwidth=48)
    lj: list = []
    lp: list = []
    oj = jr.realign(msa.copy(), cfg, out_path=str(tmp_path / "j"),
                    score_log=lj)
    op = pr.realign(msa.copy(), cfg, out_path=str(tmp_path / "p"),
                    score_log=lp)
    assert lp == lj and len(lp) > 2
    np.testing.assert_array_equal(op, oj)
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()


def _case_native(tmp_path, run_dir):
    from repeatresolver_tpu.utils import native as jn
    from repeatresolver_tpu_torch.models.realigner import compact_rows
    from repeatresolver_tpu_torch.utils import native as pn
    assert jn.get_lib() is not None
    assert pn.get_lib()._name != jn.get_lib()._name
    assert pn.get_lib()._name.startswith(os.path.join(REPO, "build", "host"))
    msa = _small_msa(11, rows=10, cols=500)
    counts = np.stack([(msa == s).sum(axis=0) for s in range(6)],
                      axis=1).astype(np.int32)
    rows_old = msa[2:8]
    seqs, ways, lengths = compact_rows(rows_old)
    ref = jn.realign_block(counts, rows_old, seqs, ways, lengths, 64)
    got = pn.realign_block(counts, rows_old, seqs, ways, lengths, 64)
    for a, b in zip(got, ref, strict=True):
        np.testing.assert_array_equal(a, b)
    assert (got[0] != rows_old).any()     # the DP really moved something
    rng = np.random.default_rng(12)
    tpl = rng.integers(0, 4, 300).astype(np.int8)
    reads = np.full((3, 330), 100, np.int8)
    lens = np.array([280, 330, 0], np.int32)
    for i, n in enumerate(lens):
        reads[i, :n] = np.resize(tpl, n)
        flip = rng.random(n) < 0.1
        reads[i, :n][flip] = rng.integers(0, 4, int(flip.sum()))
    for a, b in zip(pn.initial_align(tpl, reads, lens),
                    jn.initial_align(tpl, reads, lens), strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        pn.occurrence_rows(tpl[:50], reads, lens),
        jn.occurrence_rows(tpl[:50], reads, lens))
    pos = np.sort(rng.integers(0, 501, 80))
    cols = rng.integers(0, 6, (80, 10)).astype(np.int8)
    np.testing.assert_array_equal(pn.splice_cols(msa, pos, cols),
                                  jn.splice_cols(msa, pos, cols))
    mj, mp = np.zeros(2500), np.zeros(2500)
    jn.MaxCorrBitsets(msa).scan(mj, 0, 500, 4, 20, 10, True, True, 2)
    pn.MaxCorrBitsets(msa).scan(mp, 0, 500, 4, 20, 10, True, True, 2)
    np.testing.assert_array_equal(mp, mj)


COPIES = {
    "config": _case_config,
    "utils/io": _case_io,
    "utils/checkpoint": _case_checkpoint,
    "utils/native": _case_native,
    "ops/hypergeom": _case_hypergeom,
    "models/simulator": _case_simulator,
    "models/window": _case_window,
    "models/assessment": _case_assessment,
    "models/maxcorr (host scans)": _case_maxcorr_host,
    "models/realigner (host helpers)": _case_realigner_host,
    "models/resolver (host functions)": _case_resolver_host,
    "models/resolver (functions off the product path)":
        _case_resolver_leftovers,
    "models/realigner (serial engine)": _case_realigner_serial,
    "ops/myers": _case_myers,
}


@pytest.mark.parametrize("module", sorted(COPIES))
def test_copy_equals_original(module, tmp_path, standalone_run):
    run_dir, res, _, _ = standalone_run
    assert res.returncode == 0, res.stderr[-3000:]
    COPIES[module](tmp_path, run_dir)


def _cli_parser(cli_main):
    """The argparse parser that a CLI's main() builds."""
    import argparse

    class Caught(Exception):
        pass

    def grab(self, args=None, namespace=None):
        raise Caught(self)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        cli_main([])
    except Caught as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError("main() parsed no arguments")


def _subcommands(parser):
    """{subcommand: {flag or positional: (default, type, nargs, choices,
    required)}}"""
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    out = {}
    for name, sp in sub.choices.items():
        out[name] = {
            " ".join(a.option_strings) or a.dest:
                (a.default, a.type, a.nargs, a.choices and tuple(a.choices),
                 a.required)
            for a in sp._actions if a.dest != "help"}
    return out


def test_shared_cli_subcommands_take_the_same_flags_and_defaults():
    from repeatresolver_tpu import cli as jcli
    from repeatresolver_tpu_torch import cli as pcli
    jsub, psub = _subcommands(_cli_parser(jcli.main)), _subcommands(
        _cli_parser(pcli.main))
    assert set(psub) == set(jsub) and len(jsub) == 11
    assert jsub["realign"]["-B --block-rows"][0] == 16
    for name, flags in jsub.items():
        port = dict(psub[name])
        device = port.pop("--device", None)
        assert port == flags, name
        if device is not None:
            assert device == ("cuda", None, None, ("cuda", "cpu"), False)
    assert sorted(n for n in psub if "--device" in psub[n]) == [
        "align", "cut", "pipeline", "realign", "resolve", "resolve-windows"]
