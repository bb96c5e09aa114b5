"""Exact integer matmuls for the resolver's counts, on the caller's device.

Counterpart of repeatresolver_tpu/ops/devmm.py. The resolver's
clique-candidate intersections, clique coverage products and kmeans
GrMatch matrices (RepeatResolver.c:141-153, 1204-1226, 2656-2723) are
products of 0/1 matrices whose entries count MSA rows.

Precision: the device route is `torch._int_mm`, int8 operands with
int32 accumulation, exact for every sum below 2^31 (the counts are
bounded by the MSA's row count). No float, TF32 or half-precision
product is involved, so no global matmul precision setting applies.
The host route is the JAX package's: float32 BLAS, whose sums of 0/1
products are exact below 2^24.

Routing: `matmul_t(a, b, device)` computes a @ b.T on `device` when
(a) RR_RESOLVER_DEVICE=1, or the variable is unset and `device` is a
CUDA device ("0" keeps every product on the host), and (b) the product
has at least RR_DEVICE_MM_MIN element-ops (default 3e9), the JAX
package's gate; `force` overrides both. Both variables are read at
every call. `matmul_t.device_calls` counts the products that took the
device route. Operands wrapped in `Operand` keep their device copy
across calls: the resolver reuses a window's [G, R] group matrix for
every seed chunk.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device


def device_enabled(device) -> bool:
    """The route for products above the size gate: RR_RESOLVER_DEVICE
    "0" / "1" decide; otherwise the caller's device does."""
    env = os.environ.get("RR_RESOLVER_DEVICE", "auto")
    if env == "0":
        return False
    if env == "1":
        return True
    return torch.device(device).type == "cuda"


def min_device_ops() -> float:
    return float(os.environ.get("RR_DEVICE_MM_MIN", 3e9))


def _ceil8(x: int, lo: int) -> int:
    return max(lo, -(-x // 8) * 8)


def int_matmul_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.T exactly: int8 a [M, K] and b [N, K] on one device -> int32
    [M, N]. Zero-pads to the shapes `torch._int_mm` takes on CUDA (M > 16,
    K and N multiples of 8; its only int8 layout there is row-major a by
    column-major b, i.e. b.T of a row-major b). Zero rows and columns add
    nothing to any sum, so the result is unchanged."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {a.dtype}, {b.dtype}")
    m, k = a.shape
    n = b.shape[0]
    mp, kp, np_ = _ceil8(m, 24), _ceil8(k, 16), _ceil8(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        b = F.pad(b, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), b.contiguous().t())
    return out[:m, :n]


class Operand:
    """A host int8 matrix with a lazily created, cached device copy
    (all resolver operands are 0/1)."""

    def __init__(self, arr: np.ndarray):
        self.host = np.ascontiguousarray(arr, dtype=np.int8)
        self._dev: torch.Tensor | None = None

    def dev(self, device: torch.device) -> torch.Tensor:
        if self._dev is None or self._dev.device != device:
            self._dev = torch.from_numpy(self.host).to(device)
        return self._dev


def _as_operand(x) -> Operand:
    return x if isinstance(x, Operand) else Operand(np.asarray(x))


def _host(x) -> np.ndarray:
    return x.host if isinstance(x, Operand) else np.asarray(x)


def matmul_t(a, b, device, force: bool | None = None) -> np.ndarray:
    """Exact a @ b.T for 0/1 (or small-int) matrices -> int32 host
    array. a, b: Operand or ndarray, shapes [M, R] and [N, R]."""
    ah, bh = _host(a), _host(b)
    m, r = ah.shape
    n = bh.shape[0]
    use_dev = device_enabled(device) if force is None else force
    if use_dev and force is None and 2.0 * m * n * r < min_device_ops():
        use_dev = False
    if not use_dev:
        return (ah.astype(np.float32)
                @ bh.astype(np.float32).T).astype(np.int32)
    dev = resolve_device(device)
    matmul_t.device_calls += 1
    out = int_matmul_t(_as_operand(a).dev(dev), _as_operand(b).dev(dev))
    return out.cpu().numpy()


matmul_t.device_calls = 0
