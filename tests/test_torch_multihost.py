"""The port's multi-process window resolve (parallel/multihost.py, CLI
`resolve-windows`): a 2-process torch.distributed run over gloo on the
CPU writes subdivision files byte-identical to the single-process run
and to the JAX package's CLI. The counterpart of tests/test_multihost.py.
"""
import os
import shutil
import socket
import subprocess
import sys

import numpy as np

from repeatresolver_tpu_torch.config import (MaxCorrConfig, ResolverConfig,
                                             WindowConfig)
from repeatresolver_tpu_torch.models import maxcorr
from repeatresolver_tpu_torch.parallel import multihost
from repeatresolver_tpu_torch.utils import io as rio
from tests.test_torch_sharded import maxcorr_msa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT_S = 300


def _make_dataset(d: str) -> str:
    msa = maxcorr_msa()
    path = os.path.join(d, "MSAreal_mh")
    rio.write_msa(path, msa, upper=True)
    mc = maxcorr.compute_maxcorrs(msa, MaxCorrConfig(mincov=20))
    rio.write_maxcorrs(os.path.join(d, "MaxCorrsOf_MSAreal_mh"), mc)
    return path


def _copy_dataset(src: str, dst: str) -> str:
    for name in ("MSAreal_mh", "MaxCorrsOf_MSAreal_mh"):
        shutil.copy(os.path.join(src, name), os.path.join(dst, name))
    return os.path.join(dst, "MSAreal_mh")


def test_window_slice_partition():
    n = 7
    slices = [multihost.window_slice(n, p, 3) for p in range(3)]
    flat = sorted(w for s in slices for w in s)
    assert flat == list(range(n))
    assert multihost.initialize() == (0, 1)      # no coordinator: alone


def test_two_process_distributed_resolve(tmp_path):
    dirs = {k: tmp_path / k for k in ("single", "dist", "jax")}
    for d in dirs.values():
        d.mkdir()
    msa_a = _make_dataset(str(dirs["single"]))
    msa_b = _copy_dataset(str(dirs["single"]), str(dirs["dist"]))
    msa_j = _copy_dataset(str(dirs["single"]), str(dirs["jax"]))

    written = multihost.resolve_windows(
        msa_a, ResolverConfig(cov=20), WindowConfig(coverage=0.9, parts=2),
        progress=lambda *_: None, device="cpu")
    assert len(written) == 6          # 2 windows x 3 clusterings

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = REPO
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "repeatresolver_tpu_torch.cli",
             "resolve-windows", msa_b, "-c", "20", "-p", "2",
             "--coordinator", f"127.0.0.1:{port}",
             "--procs", "2", "--proc-id", str(pid), "--device", "cpu"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for pid in range(2)]
    try:
        outs = [p.communicate(timeout=PROC_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    # each process owned a disjoint non-empty slice
    assert all("-> " in out for out, _ in outs)

    # the JAX package's CLI, single process, on the same files
    from repeatresolver_tpu import cli as jcli
    jcli.main(["resolve-windows", msa_j, "-c", "20", "-p", "2"])

    names = sorted(os.path.basename(w) for w in written)
    for name in names:
        ref = (dirs["single"] / name).read_bytes()
        for k in ("dist", "jax"):
            assert (dirs[k] / name).exists(), f"{k} run missing {name}"
            assert (dirs[k] / name).read_bytes() == ref, (k, name)
    assert len(np.loadtxt(dirs["single"] / names[-1])) == 60   # a row each
