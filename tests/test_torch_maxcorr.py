"""The port's MaxCorrs device scan against the JAX package's, on the CPU.

test_golden_maxcorr's planted MSA (60 rows, 2 copy groups, 2% noise, 3%
gaps, ragged coverage) goes through the JAX device scan (JAX on the CPU)
and through the port's (CPU tensors). Tolerances: identical decisions at
the MaxCorrs cutoff; values within 1e-5 of JAX's (float32 in two
frameworks); and, against the exact host scan, the JAX package's own
device tolerances (rtol 2e-3, atol 5e-3 where significant,
test_golden_maxcorr.py:68-80).
"""
import numpy as np
import pytest

from repeatresolver_tpu.config import MaxCorrConfig
from repeatresolver_tpu_torch.models import maxcorr as pmc
from tests.test_golden_maxcorr import planted_msa  # noqa: F401 (fixture)

TILE = 128


@pytest.fixture(scope="module")
def jax_device_scan(planted_msa):  # noqa: F811
    from repeatresolver_tpu.models import maxcorr as jmc
    _, _, msa = planted_msa
    return jmc.compute_maxcorrs_device(msa, MaxCorrConfig(mincov=20),
                                       tile=TILE)


def test_device_scan_matches_jax_and_host(planted_msa, jax_device_scan):  # noqa: F811
    _, _, msa = planted_msa
    cfg = MaxCorrConfig(mincov=20)
    calls = pmc.compute_maxcorrs_device.calls
    dev = pmc.compute_maxcorrs_device(msa, cfg, tile=TILE, device="cpu")
    assert pmc.compute_maxcorrs_device.calls == calls + 1
    assert dev.dtype == np.float64 and dev.shape == (msa.shape[1] * 5,)
    cutoff = cfg.resolved_cutoff(msa.shape[1])
    np.testing.assert_array_equal(dev > cutoff, jax_device_scan > cutoff)
    np.testing.assert_allclose(dev, jax_device_scan, rtol=0, atol=1e-5)
    host = pmc.compute_maxcorrs(msa, cfg, fast=True)
    sig = host > cutoff
    assert sig.sum() >= 6
    np.testing.assert_array_equal(dev > cutoff, sig)
    np.testing.assert_allclose(dev[sig], host[sig], rtol=2e-3, atol=5e-3)


def test_seed_tile_stripes_with_padding(planted_msa, jax_device_scan):  # noqa: F811
    """The scan over given seed tiles, striped as the JAX package's mesh
    path stripes them (entries past the last tile are padding and scan
    nothing): the max over the stripes is the full scan, bit for bit."""
    _, _, msa = planted_msa
    cfg = MaxCorrConfig(mincov=20)
    full = pmc.compute_maxcorrs_device(msa, cfg, tile=64, device="cpu")
    stripes = []
    for w in range(3):
        sc = pmc.MaxCorrScan(msa, cfg, 64, pmc.resolve_device("cpu"))
        i_tiles = w + 3 * np.arange(-(-sc.nt // 3))      # padded stripe
        assert w > 0 or i_tiles.max() < sc.nt
        stripes.append(sc.scan(i_tiles).numpy()[:msa.shape[1] * 5])
    merged = np.maximum.reduce(stripes).astype(np.float64)
    np.testing.assert_array_equal(merged, full)
    # tile size changes nothing beyond float32 rounding
    np.testing.assert_allclose(full, jax_device_scan, rtol=0, atol=1e-5)
    # padding only: nothing scanned
    sc = pmc.MaxCorrScan(msa, cfg, 64, pmc.resolve_device("cpu"))
    assert not sc.scan([sc.nt, sc.nt + 2]).any() and sc.tile_pairs == 0


def test_mesh_not_ported(planted_msa):  # noqa: F811
    """mesh= was refused until parallel/ was ported; now a mesh of one
    rank scans every tile itself and gives the single scan, and a mesh
    of more ranks than this process has joined is refused by make_mesh
    (two ranks: tests/test_torch_sharded.py)."""
    from repeatresolver_tpu_torch.parallel import sharded
    _, _, msa = planted_msa
    cfg = MaxCorrConfig(mincov=20)
    mesh = sharded.make_mesh(1, device="cpu")
    np.testing.assert_array_equal(
        pmc.compute_maxcorrs_device(msa, cfg, tile=64, mesh=mesh),
        pmc.compute_maxcorrs_device(msa, cfg, tile=64, device="cpu"))
    with pytest.raises(ValueError, match="need 2 ranks"):
        sharded.make_mesh(2, device="cpu")
