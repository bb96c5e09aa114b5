"""The port's exact resolver matmuls (ops/devmm) against the JAX package.

The same 0/1 operands, made with numpy from a seed, go through the JAX
package's matmul_t and through the port's host route and its device
route on CPU tensors (torch._int_mm, int8 operands, int32 sums). Every
output is an integer count and is compared exactly (tolerance 0),
against an int64 reference too.
"""
import numpy as np
import pytest
import torch

from repeatresolver_tpu.ops import devmm as jdevmm
from repeatresolver_tpu_torch.ops import devmm


@pytest.mark.parametrize("m,n,k", [(300, 120, 257), (5, 3, 7), (17, 9, 0)])
def test_matmul_t_routes_equal_jax(m, n, k):
    """Shapes off the int8 product's alignment (M <= 16, K and N not
    multiples of 8, K = 0) are padded, and the result is unchanged."""
    rng = np.random.default_rng(m)
    a = rng.random((m, k)) < 0.3
    b = rng.random((n, k)) < 0.6
    ref = a.astype(np.int64) @ b.astype(np.int64).T
    jax_host = jdevmm.matmul_t(a, b, force=False)
    host = devmm.matmul_t(a, b, "cpu", force=False)
    calls = devmm.matmul_t.device_calls
    dev = devmm.matmul_t(a, b, "cpu", force=True)
    assert devmm.matmul_t.device_calls == calls + 1
    for out in (host, dev):
        assert out.dtype == np.int32 and out.shape == (m, n)
        np.testing.assert_array_equal(out, jax_host)
        np.testing.assert_array_equal(out.astype(np.int64), ref)


def test_int_matmul_t_exact_at_large_counts():
    """Sums far above float32's 2^24 exact range stay exact."""
    a = torch.ones((3, 40000), dtype=torch.int8) * 100
    b = torch.ones((2, 40000), dtype=torch.int8) * 100
    out = devmm.int_matmul_t(a, b)
    assert out.dtype == torch.int32
    assert (out == 400_000_000).all()
    with pytest.raises(TypeError):
        devmm.int_matmul_t(a.float(), b)


def test_operand_device_copy_reused():
    a = devmm.Operand(np.eye(16, dtype=bool))
    b = np.ones((4, 16), bool)
    out1 = devmm.matmul_t(a, b, "cpu", force=True)
    d1 = a._dev
    out2 = devmm.matmul_t(a, b, "cpu", force=True)
    assert a._dev is d1                  # no second copy
    np.testing.assert_array_equal(out1, out2)
    ref = a.host.astype(np.int64) @ b.astype(np.int64).T
    np.testing.assert_array_equal(out1.astype(np.int64), ref)


def test_gate_follows_env_and_device(monkeypatch):
    """RR_RESOLVER_DEVICE 0/1 decide; unset, the caller's device does;
    RR_DEVICE_MM_MIN is the size gate (read at each call)."""
    a = np.ones((8, 8), bool)
    monkeypatch.delenv("RR_RESOLVER_DEVICE", raising=False)
    assert devmm.device_enabled("cuda") and not devmm.device_enabled("cpu")
    monkeypatch.setenv("RR_RESOLVER_DEVICE", "0")
    assert not devmm.device_enabled("cuda")
    calls = devmm.matmul_t.device_calls
    devmm.matmul_t(a, a, "cuda")         # host route: no CUDA needed
    assert devmm.matmul_t.device_calls == calls
    monkeypatch.setenv("RR_RESOLVER_DEVICE", "1")
    devmm.matmul_t(a, a, "cpu")          # below the default 3e9 gate
    assert devmm.matmul_t.device_calls == calls
    monkeypatch.setenv("RR_DEVICE_MM_MIN", "0")
    np.testing.assert_array_equal(devmm.matmul_t(a, a, "cpu"),
                                  np.full((8, 8), 8, np.int32))
    assert devmm.matmul_t.device_calls == calls + 1
