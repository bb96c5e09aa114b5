"""The port's graft entry (repeatresolver_tpu_torch/graft_entry.py)
against the repository root's __graft_entry__.py: `entry()` gives the
same seed-0 arguments, and its function the same codes, final band and
final band start (tolerance 0); `dryrun_multichip(2)` starts two gloo
ranks on the CPU and runs every sharded step.
"""
import importlib.util
import os

import numpy as np
import torch

from repeatresolver_tpu_torch import graft_entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


def _jax_graft_entry():
    spec = importlib.util.spec_from_file_location(
        "_jax_graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_matches_jax_entry():
    import jax
    jfn, jargs = _jax_graft_entry().entry()
    pfn, pargs = graft_entry.entry("cpu")
    assert len(pargs) == len(jargs) == 5
    for a, b in zip(pargs, jargs):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b)
    ref = jax.jit(jfn)(*jargs)
    got = pfn(*pargs)
    assert [tuple(o.shape) for o in got] == [(4, 256, 128), (4, 128), (4,)]
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert len(np.unique(got[0].numpy())) == 3   # all three move codes


def test_main_runs_entry_and_dryrun(capsys):
    """`python -m repeatresolver_tpu_torch.graft_entry --device cpu
    --ranks 2`: the entry's function once, then dryrun_multichip(2),
    which starts its own two ranks."""
    assert graft_entry.main(["--device", "cpu", "--ranks", "2"]) == 0
    out = capsys.readouterr().out
    assert "entry ok: [(4, 256, 128), (4, 128), (4,)]" in out
    assert "dryrun_multichip(2) ok" in out
