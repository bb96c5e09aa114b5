"""The port's resolver against the JAX package's, on the CPU.

test_devmm's window (4 planted copies x 8 rows, 5% noise) goes through
the JAX package's resolve_window on its host route and through the
port's with every exact product forced to the device route on CPU
tensors (RR_RESOLVER_DEVICE=1, RR_DEVICE_MM_MIN=0) and on its host
route. The subdivisions are integer labels and must be identical
(tolerance 0); the port's CLI resolve / window / maxcorr must write the
JAX CLI's files byte for byte.
"""
import numpy as np
import pytest

from repeatresolver_tpu import config as C


@pytest.fixture(scope="module")
def window_case():
    from repeatresolver_tpu.models import maxcorr
    rng = np.random.default_rng(7)
    n_copies, cov, w = 4, 8, 400
    tpl = rng.integers(0, 4, w)
    copies = [tpl.copy() for _ in range(n_copies)]
    for cp in copies:
        snps = rng.choice(w, 6, replace=False)
        cp[snps] = (cp[snps] + 1 + rng.integers(0, 3, 6)) % 4
    rows = []
    for cp in copies:
        for _ in range(cov):
            r = cp.copy()
            err = rng.random(w) < 0.05
            r[err] = rng.integers(0, 4, err.sum())
            rows.append(r)
    msa = np.array(rows, np.int8)
    mc = np.asarray(maxcorr.compute_maxcorrs(
        msa, maxcorr.MaxCorrConfig(mincov=cov)))
    return msa, mc, cov


def test_resolve_window_routes_match_jax(window_case, monkeypatch):
    from repeatresolver_tpu.models import resolver as jres
    from repeatresolver_tpu.ops import devmm as jdevmm
    from repeatresolver_tpu_torch.models import resolver as pres
    from repeatresolver_tpu_torch.ops import devmm
    msa, mc, cov = window_case
    w = msa.shape[1]
    cfg = C.ResolverConfig(cov=cov)
    monkeypatch.setitem(jdevmm._state, "on", False)
    ref = jres.resolve_window(msa, mc.copy(), 0, w - 1, cfg)
    assert ref["Kmeans"].max() >= 1       # the window really resolves
    monkeypatch.setenv("RR_RESOLVER_DEVICE", "0")
    host = pres.resolve_window(msa, mc.copy(), 0, w - 1, cfg, "cpu")
    calls = devmm.matmul_t.device_calls
    monkeypatch.setenv("RR_RESOLVER_DEVICE", "1")
    monkeypatch.setenv("RR_DEVICE_MM_MIN", "0")
    dev = pres.resolve_window(msa, mc.copy(), 0, w - 1, cfg, "cpu")
    assert devmm.matmul_t.device_calls > calls
    for out in (host, dev):
        assert out.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_kmeans_python_fallback_matches_native(window_case):
    """kmeans without the native helpers (the literal loops) labels the
    cluster as the native path does."""
    from repeatresolver_tpu.models.resolver import (GroupData,
                                                    extract_window)
    from repeatresolver_tpu_torch.models import resolver as pres
    msa, mc, cov = window_case
    gd = GroupData.from_window(extract_window(msa, 0, msa.shape[1] - 1))
    u0 = np.zeros(msa.shape[0], np.int64)
    cutoff = C.ResolverConfig(cov=cov).resolved_cutoff(msa.shape[1])
    vars_ = pres.relative_vars(gd, u0, 0, mc, cutoff, cov // 2)
    assert vars_
    labels = []
    for native in (True, False):
        u = u0.copy()
        n = pres.kmeans(gd, u, 0, vars_, cov // 2, use_native=native)
        labels.append((n, u))
    assert labels[0][0] == labels[1][0]
    np.testing.assert_array_equal(labels[0][1], labels[1][1])


def test_cli_window_maxcorr_resolve_match_jax(window_case, tmp_path,
                                              capsys, monkeypatch):
    from repeatresolver_tpu import cli as jcli
    from repeatresolver_tpu.ops import devmm as jdevmm
    from repeatresolver_tpu.utils import io as rio
    from repeatresolver_tpu_torch import cli as pcli
    msa, _, cov = window_case
    monkeypatch.setitem(jdevmm._state, "on", False)
    outs = {}
    for tag, cli, dev in (("jax", jcli, []),
                          ("port", pcli, ["--device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        monkeypatch.chdir(d)
        rio.write_msa("X_MSAreal", msa, upper=True)
        cli.main(["window", "X_MSAreal", "-c", "0.5", "-p", "2"])
        cli.main(["maxcorr", "X_MSAreal", "-c", str(cov)])
        cli.main(["resolve", "X_MSAreal", "-f", "0", "399", "-c",
                  str(cov)] + dev)
        outs[tag] = capsys.readouterr().out
    assert outs["port"] == outs["jax"]
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 5
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
