"""The port's float32 device significance (ops/hypergeom_device)
against the JAX package's, on the CPU.

The same integer counts, made with numpy from a seed, go through both
(JAX on the CPU, the port on CPU tensors), with the double-float
log-factorial tables. Tolerance: the same relevant mask and exact zeros
elsewhere; relevant values within 1e-5 relative (float32 arithmetic in
two frameworks; the module's accuracy contract is ~1e-5 for Z).
"""
import numpy as np
import torch

from repeatresolver_tpu.ops import hypergeom as hg
from repeatresolver_tpu_torch.ops import hypergeom_device as phd
from tests.test_hypergeom import _cases


def _jax_z(args, table):
    import jax.numpy as jnp

    from repeatresolver_tpu.ops import hypergeom_device as jhd
    lf = [jnp.asarray(v) for v in table]
    return np.asarray(jhd.positive_significance_f32(
        *[jnp.asarray(a, jnp.int32) for a in args], *lf))


def _port_z(args, table):
    lf = [torch.from_numpy(v) for v in table]
    return phd.positive_significance_f32(
        *[torch.from_numpy(np.asarray(a, np.int32)) for a in args],
        *lf).numpy()


def test_significance_matches_jax():
    """Random counts, and pairs placed just above the mode (slow tails:
    many series terms before the batch-wide stop) in one batch."""
    rng = np.random.default_rng(3)
    k, K, n, N = _cases(rng, 500)
    hi = np.minimum(K, n)
    mode = ((n + 1) * (K + 1)) // (N + 2)
    near = np.minimum(mode + 1 + rng.integers(0, 3, len(k)), hi)
    s = np.concatenate([k, near])
    gr1, gr2, cov = (np.concatenate([v, v]) for v in (n, K, N))
    sz1, sz2 = gr1 + rng.integers(0, 3, len(s)), gr2 + 1
    args = (s, gr1, gr2, cov, sz1, sz2)
    table = phd.log_factorial_table(int(cov.max()))
    zj = _jax_z(args, table)
    zp = _port_z(args, table)
    np.testing.assert_array_equal(zp > 0, zj > 0)
    assert (zp[zj == 0] == 0).all()
    rel = zj > 0
    assert rel.sum() > 100
    np.testing.assert_allclose(zp[rel], zj[rel], rtol=1e-5)
    # and the exact float64 host series, at the JAX package's tolerance
    exact = hg.positive_significance(*args)
    np.testing.assert_allclose(zp[rel], exact[rel], atol=5e-4)


def test_tail_immune_to_below_mode_overflow():
    """tests/test_hypergeom.py's NaN-poisoning case: a below-mode pair
    whose running product overflows to inf, batched with a slow-decaying
    relevant pair, must not truncate the relevant pair's tail."""
    rel = dict(s=1060, k=2000, n=2000, N=3800)
    sub = dict(s=1, k=16, n=3500, N=3516)
    table = phd.log_factorial_table(4096)

    def z_of(pairs):
        s, k, n, nn = (np.array([p[f] for p in pairs])
                       for f in ("s", "k", "n", "N"))
        return _port_z((s, n, k, nn, n, k), table)

    solo = z_of([rel])
    mixed = z_of([rel, sub])
    assert mixed[0] == solo[0]
    assert mixed[1] == 0.0
    exact = hg.positive_significance(
        np.array([1060]), np.array([2000]), np.array([2000]),
        np.array([3800]), np.array([2000]), np.array([2000]))
    np.testing.assert_allclose(mixed[0], exact[0], atol=5e-4)
    jz = _jax_z((np.array([1060, 1]), np.array([2000, 3500]),
                 np.array([2000, 16]), np.array([3800, 3516]),
                 np.array([2000, 3500]), np.array([2000, 16])), table)
    np.testing.assert_allclose(mixed, jz, rtol=1e-5)


def test_broadcast_tile_layout():
    """The tile step's call: [t5, t5] counts with [t5, 1] and [1, t5]
    sizes, and an empty batch."""
    rng = np.random.default_rng(8)
    k, K, n, N = _cases(rng, 64)
    args = [torch.from_numpy(np.asarray(v, np.int32)).reshape(8, 8)
            for v in (k, n, K, N)]
    sz1 = torch.from_numpy(rng.integers(1, 50, (8, 1)).astype(np.int32))
    sz2 = torch.from_numpy(rng.integers(1, 50, (1, 8)).astype(np.int32))
    table = [torch.from_numpy(v) for v in phd.log_factorial_table(400)]
    z = phd.positive_significance_f32(*args, sz1, sz2, *table)
    assert z.shape == (8, 8) and z.dtype == torch.float32
    flat = phd.positive_significance_f32(
        *[a.reshape(-1) for a in args], sz1.expand(8, 8).reshape(-1),
        sz2.expand(8, 8).reshape(-1), *table)
    np.testing.assert_array_equal(z.reshape(-1).numpy(), flat.numpy())
    empty = torch.zeros(0, dtype=torch.int32)
    assert phd.positive_significance_f32(
        empty, empty, empty, empty, empty, empty, *table).shape == (0,)
