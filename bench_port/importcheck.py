"""The run's check that nothing of JAX or of the JAX package was loaded.

Names are compared by their top-level part (before the first dot),
whole: the port's package name begins with the JAX package's, and is
allowed.
"""
from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repeatresolver_tpu"})


def forbidden_modules(names) -> list[str]:
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})
