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
assert "jax" not in sys.modules, "jax was imported"
print("NOJAX-OK")
"""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NOJAX-OK" in res.stdout
    assert "OverallScore:" in res.stdout
