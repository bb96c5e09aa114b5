"""The port's realign stage as a whole against the JAX package, on the CPU.

  * realign_batched, staircase + the kernels' plain versions on the
    CPU, against JAX realign_batched(mode="staircase", kernel="pallas")
    (the resident engine with Pallas in interpret mode): same score log,
    same final MSA, anneal tail included;
  * a checkpoint written by the JAX package, resumed by the port and by
    the JAX package: same continuation, learned drift ladder included;
  * the port's CLI `realign --device cpu` against the JAX CLI: same
    OverallScore lines and byte-equal MSAreal;
  * a port run in a fresh interpreter leaves jax out of sys.modules.

Integer results are compared exactly.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repeatresolver_tpu.config import RealignerConfig
from tests.test_realigner_device import make_msa

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_realign_batched_matches_jax():
    from repeatresolver_tpu.models import realigner as jr
    from repeatresolver_tpu_torch.models import realigner as pr
    from repeatresolver_tpu_torch.models.realigner_device import (
        DeviceResidentRealigner,
    )
    msa = make_msa(11, rows=8, tlen=200)
    cfg = RealignerConfig(bandwidth=96)
    log_j: list = []
    out_j = jr.realign_batched(msa.copy(), cfg, block_rows=4,
                               mode="staircase", kernel="pallas",
                               score_log=log_j)
    sweeps0 = pr.BatchedRealigner.host_sweeps
    log_p: list = []
    out_p = pr.realign_batched(msa.copy(), cfg, block_rows=4,
                               kernel="cuda", device="cpu",
                               score_log=log_p,
                               validate=True)
    assert log_p == log_j
    np.testing.assert_array_equal(out_p, out_j)
    # the anneal tail ran on the host native engine
    assert pr.BatchedRealigner.host_sweeps > sweeps0
    assert DeviceResidentRealigner.RESIDENT_MIN_BS > 4


def test_resume_from_jax_checkpoint(tmp_path):
    """A JAX checkpoint (MSA, round, best, anneal block size, learned
    drift ladder) resumes in the port on the same trajectory as in the
    JAX package. Block 4, as in test_realign_batched_matches_jax, so
    the two share the JAX compiles."""
    from repeatresolver_tpu.models import realigner as jr
    from repeatresolver_tpu.utils import checkpoint as ck
    from repeatresolver_tpu_torch.models import realigner as pr
    msa = make_msa(13, rows=8, tlen=200)
    ckp = str(tmp_path / "jax.npz")
    jr.realign_batched(msa.copy(), RealignerConfig(bandwidth=96,
                                                   max_rounds=2),
                       block_rows=4, mode="staircase", kernel="pallas",
                       checkpoint_path=ckp)
    c = ck.RealignCheckpoint.load(ckp)
    assert c.widen is not None and c.widen_bs == 4 and c.block_rows == 4
    ckp_p = str(tmp_path / "port.npz")
    shutil.copy(ckp, ckp_p)
    cfg = RealignerConfig(bandwidth=96)
    log_j: list = []
    out_j = jr.realign_batched(msa.copy(), cfg, block_rows=4,
                               mode="staircase", kernel="pallas",
                               checkpoint_path=ckp, resume=True,
                               score_log=log_j)
    log_p: list = []
    out_p = pr.realign_batched(msa.copy(), cfg, block_rows=4,
                               kernel="cuda", device="cpu",
                               checkpoint_path=ckp_p,
                               resume=True, score_log=log_p)
    assert log_p == log_j
    np.testing.assert_array_equal(out_p, out_j)
    pr.validate_counts(out_p, pr.symbol_counts(out_p))
    assert min(log_p) <= (c.best_mille, c.best_uno)


def _write_msa(path, msa):
    from repeatresolver_tpu.utils import io as rio
    rio.write_msa(path, msa)


@pytest.mark.parametrize("block_rows", ["1", "4"])
def test_cli_realign_matches_jax_cli(tmp_path, capsys, block_rows):
    """-B 4: the JAX CLI's realign_batched; -B 1: its serial reference
    loop, which the port runs on the host native engine."""
    from repeatresolver_tpu import cli as jcli
    from repeatresolver_tpu_torch import cli as pcli
    msa_path = str(tmp_path / "X_MSA")
    _write_msa(msa_path, make_msa(17, rows=10, tlen=220))
    jcli.main(["realign", msa_path, "-o", str(tmp_path / "jax_real"),
               "-b", "96", "-B", block_rows])
    out_j = capsys.readouterr().out
    pcli.main(["realign", msa_path, "-o", str(tmp_path / "port_real"),
               "-b", "96", "-B", block_rows, "--device", "cpu"])
    out_p = capsys.readouterr().out
    scores_j = [l for l in out_j.splitlines() if l.startswith("Overall")]
    scores_p = [l for l in out_p.splitlines() if l.startswith("Overall")]
    assert scores_j and scores_p == scores_j
    with open(tmp_path / "jax_real", "rb") as fj, \
            open(tmp_path / "port_real", "rb") as fp:
        assert fp.read() == fj.read()


def test_device_is_explicit(monkeypatch, tmp_path):
    """"cuda" raises where torch sees no GPU (no silent CPU fallback),
    also through the CLI's default; "cpu" only when named."""
    from repeatresolver_tpu_torch import cli as pcli
    from repeatresolver_tpu_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    msa_path = str(tmp_path / "X_MSA")
    _write_msa(msa_path, make_msa(17, rows=6, tlen=120))
    with pytest.raises(RuntimeError, match="CUDA"):
        pcli.main(["realign", msa_path, "-o", str(tmp_path / "real"),
                   "-b", "64", "-B", "4"])


def test_port_run_does_not_import_jax(tmp_path):
    """Every module of the port imports, and simulate, cut, align (the
    native and the device route), realign, window, maxcorr and resolve
    run through the port's CLI, in a fresh interpreter (the test process
    has jax loaded by conftest)."""
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {REPO!r})
import torch
torch.set_num_threads(1)
import repeatresolver_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
assert "repeatresolver_tpu_torch.pipeline" in mods, mods
from repeatresolver_tpu_torch import cli
from repeatresolver_tpu_torch.models import read_cutter
d = {str(tmp_path)!r}
cli.main(["simulate", "-c", "4", "-n", "2", "-l", "1500", "--seed", "3",
          "--outdir", d])
name = "Tree_1perc_1500kb"
tpl = f"{{d}}/{{name}}_Template.fasta"
cli.main(["cut", tpl, f"{{d}}/{{name}}.fasta", "--device", "cpu"])
cli.main(["align", tpl, f"{{d}}/{{name}}_Seq.fasta", "--device", "cpu"])
cli.main(["realign", f"{{d}}/{{name}}_MSA", "-o", f"{{d}}/{{name}}_MSAreal",
          "-b", "64", "-B", "4", "--device", "cpu"])
import os
os.chdir(d)                  # MaxCorrsOf_ is a prefix on the path string
real = f"{{name}}_MSAreal"
cli.main(["window", real])
cli.main(["maxcorr", real, "-c", "4"])
cli.main(["resolve", real, "-f", "100", "300", "-c", "4", "--device", "cpu"])
from repeatresolver_tpu_torch.config import ReadCutterConfig
from repeatresolver_tpu_torch.utils import io as rio
read_cutter.cut_reads(rio.read_template(tpl).astype("int16"),
                      [r.astype("int16") for r in rio.read_fasta(
                          f"{{d}}/{{name}}.fasta")][:2],
                      ReadCutterConfig(), device="cpu", use_native=False)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "repeatresolver_tpu")]
assert not bad, f"imported {{bad}}"
print("NOJAX-OK")
"""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NOJAX-OK" in res.stdout
    assert "OverallScore:" in res.stdout


def _anneal_in_fresh_interpreter(min_bs, out):
    """Start a fresh interpreter that runs realign_batched with the
    anneal (block 64 -> 16 -> 4 -> 1), in the JAX package (its resident
    engine, Pallas in interpret mode) and in the port (the resident
    engine's plain versions on the CPU), on one MSA, and saves both score
    logs and final MSAs to `out`. RR_RESIDENT_MIN_BS (unless None) and
    RR_FLUSH_CAP=4 (mid-sweep flushes, where the two engines of the
    anneal differ) are set before either package is imported."""
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
import numpy as np
import torch
torch.set_num_threads(1)
from repeatresolver_tpu.config import RealignerConfig as JCfg
from repeatresolver_tpu.models import realigner as jr
from repeatresolver_tpu.models.realigner_device import (
    DeviceResidentRealigner as JD)
from repeatresolver_tpu_torch.config import RealignerConfig
from repeatresolver_tpu_torch.models import realigner as pr
from repeatresolver_tpu_torch.models.realigner_device import (
    DeviceResidentRealigner as PD)
from tests.test_realigner_device import make_msa
msa = make_msa(1, rows=72, tlen=240, d=0.2)
log_j, log_p = [], []
out_j = jr.realign_batched(msa.copy(), JCfg(bandwidth=48), block_rows=64,
                           score_log=log_j, mode="staircase",
                           kernel="pallas")
out_p = pr.realign_batched(msa.copy(), RealignerConfig(bandwidth=48),
                           block_rows=64, score_log=log_p, kernel="cuda",
                           device="cpu")
np.savez({out!r}, min_bs=[JD.RESIDENT_MIN_BS, PD.RESIDENT_MIN_BS],
         log_j=log_j, log_p=log_p, out_j=out_j, out_p=out_p)
"""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "RR_FLUSH_CAP": "4"}
    env.pop("RR_RESIDENT_MIN_BS", None)
    if min_bs is not None:
        env["RR_RESIDENT_MIN_BS"] = str(min_bs)
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def test_resident_min_bs_read_from_environment(tmp_path):
    """RR_RESIDENT_MIN_BS, the block size below which the anneal leaves
    the resident engine for the host native engine, is read by the port
    as by the JAX package: with it at 16 (block 16 stays resident) and
    at its default of 32 (block 16 runs on the host), the port's score
    log and final MSA equal the JAX package's. On this input the two
    thresholds give different final MSAs, so a port that ignored the
    variable would fail the first comparison."""
    runs = {m: (_anneal_in_fresh_interpreter(m, str(tmp_path / f"{m}.npz")),
                str(tmp_path / f"{m}.npz")) for m in (16, None)}
    res = {}
    for m, (proc, path) in runs.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-3000:]
        res[m] = dict(np.load(path))
    for m, want in ((16, 16), (None, 32)):
        r = res[m]
        assert r["min_bs"].tolist() == [want, want]
        np.testing.assert_array_equal(r["log_p"], r["log_j"])
        np.testing.assert_array_equal(r["out_p"], r["out_j"])
    assert not np.array_equal(res[16]["out_p"], res[None]["out_p"])


@pytest.mark.parametrize("interval", ["0", None])
def test_best_write_interval_matches_jax(tmp_path, monkeypatch, interval):
    """RR_BEST_WRITE_S as the JAX package keys it: the resident engine
    writes its best MSA at most once an interval (600 s unset), the
    host engine of the anneal's tail every improving round, and the
    final best always. The same checkpoints, in the same order, and the
    same files as the JAX resident engine's run."""
    from repeatresolver_tpu.models import realigner as jr
    from repeatresolver_tpu.utils import checkpoint as jck
    from repeatresolver_tpu_torch.models import realigner as pr
    from repeatresolver_tpu_torch.utils import checkpoint as pck
    if interval is None:
        monkeypatch.delenv("RR_BEST_WRITE_S", raising=False)
    else:
        monkeypatch.setenv("RR_BEST_WRITE_S", interval)
    saves = {"jax": [], "port": []}
    for key, mod in (("jax", jck), ("port", pck)):
        orig = mod.RealignCheckpoint.save

        def save(self, path, key=key, orig=orig):
            saves[key].append((self.round, self.best_mille, self.best_uno,
                               self.block_rows))
            orig(self, path)
        monkeypatch.setattr(mod.RealignCheckpoint, "save", save)
    msa = make_msa(11, rows=8, tlen=200)
    cfg = RealignerConfig(bandwidth=96)
    kw = {}
    for key in ("jax", "port"):
        (tmp_path / key).mkdir()
        kw[key] = dict(out_path=str(tmp_path / key / "MSAreal"),
                       checkpoint_path=str(tmp_path / key / "ckpt"),
                       score_log_path=str(tmp_path / key / "scorelog"))
    out_j = jr.realign_batched(msa.copy(), cfg, block_rows=4,
                               mode="staircase", kernel="pallas", **kw["jax"])
    out_p = pr.realign_batched(msa.copy(), cfg, block_rows=4, kernel="cuda",
                               device="cpu", **kw["port"])
    np.testing.assert_array_equal(out_p, out_j)
    assert saves["port"] == saves["jax"]
    rounds = [s[0] for s in saves["jax"]]
    if interval is None:
        # the first improving resident round, then the host tail's
        assert 1 in rounds and 2 not in rounds
    else:
        assert rounds[:3] == [0, 1, 2]
    for name in ("MSAreal", "scorelog"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
