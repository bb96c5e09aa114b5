"""The native host library (native/host_ops.cpp, built with g++ at first
use): the JAX package's ctypes bindings, which import no jax,
re-exported so that callers of the port name only the port."""
from repeatresolver_tpu.utils.native import MaxCorrBitsets, get_lib

__all__ = ["MaxCorrBitsets", "get_lib"]
