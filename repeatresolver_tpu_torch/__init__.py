"""repeatresolver_tpu_torch — the PyTorch + CUDA port of repeatresolver_tpu.

The JAX package (`repeatresolver_tpu/`) stays the reference; this
package mirrors its layout and names so every module has a counterpart:

  device.py    explicit device resolution (no silent CPU fallback)
  config.py, utils/{io,native}.py
               the JAX package's stage configurations, file formats and
               native host library, which import no jax, re-exported
  ops/         the realign DP (plain torch versions and the hand-written
               Hopper kernels, csrc/*.cu, behind ctypes wrappers), the
               edit DP of cut and align, the exact int8 resolver
               products and the float32 MaxCorrs significance
  models/      every stage: cut and align (device edit DP or native
               host kernels), realign (resident engine + host native
               engine), the MaxCorrs device scan, the resolver; window
               and assessment re-exported
  pipeline.py  run_pipeline: simulate -> ... -> assessment on a device
  cli.py       the JAX CLI's subcommands and flags, plus --device

It imports torch and never jax; jax-free modules of the JAX package
(config, utils, the simulator, window, assessment, hypergeom, the host
paths of maxcorr and resolver, the realigner's host helpers) are
imported instead of copied.

Symbols follow the reference encoding throughout:
  0=a 1=c 2=g 3=t 4='-' (alignment gap) 5=' ' (coverage gap)
"""
from repeatresolver_tpu import A, C, G, GAP, SPACE, SYMBOLS, SYMBOLS_UPPER, T

__all__ = ["A", "C", "G", "T", "GAP", "SPACE", "SYMBOLS", "SYMBOLS_UPPER"]
