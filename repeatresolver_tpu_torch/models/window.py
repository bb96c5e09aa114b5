"""Resolution-window selection (the reference's Window.py): the JAX
package's module, which imports no jax, re-exported."""
from repeatresolver_tpu.models.window import window_boundaries

__all__ = ["window_boundaries"]
