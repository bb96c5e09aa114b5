"""repeatresolver_tpu_torch — the PyTorch + CUDA port of repeatresolver_tpu.

The JAX package (`repeatresolver_tpu/`) stays the reference; this
package mirrors its layout and names so every module has a counterpart:

  device.py    explicit device resolution (no silent CPU fallback)
  config.py, utils/{io,checkpoint,hostmem}.py
               the stage configurations, file formats, checkpoints and
               allocator tuning: the port's own copies of the JAX
               package's modules
  utils/native.py, csrc/host_ops.cpp
               the port's own native host library (g++ at first use
               into build/host/) and its ctypes binding
  ops/         the realign DP (plain torch versions and the hand-written
               Hopper kernels, csrc/*.cu, behind ctypes wrappers), the
               edit DP of cut and align, the exact int8 resolver
               products and the float32 MaxCorrs significance
  models/      every stage: cut and align (device edit DP or native
               host kernels), realign (resident engine + host native
               engine), the MaxCorrs device scan, the resolver, the
               simulator, window and assessment
  pipeline.py  run_pipeline: simulate -> ... -> assessment on a device
  cli.py       the JAX CLI's subcommands and flags, plus --device

It imports torch, never jax, and nothing of repeatresolver_tpu: what it
needs of that package's jax-free host code (config, utils, the
simulator, window, assessment, hypergeom, the host paths of maxcorr and
resolver, the realigner's host helpers) it keeps as its own copy, under
the same module and function names. Only the tests import both.

Symbols follow the reference encoding throughout:
  0=a 1=c 2=g 3=t 4='-' (alignment gap) 5=' ' (coverage gap)
"""
A, C, G, T, GAP, SPACE = 0, 1, 2, 3, 4, 5
SYMBOLS = "acgt- "
SYMBOLS_UPPER = "ACGT- "

__all__ = ["A", "C", "G", "T", "GAP", "SPACE", "SYMBOLS", "SYMBOLS_UPPER"]
