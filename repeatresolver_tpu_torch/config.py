"""Stage configurations: the JAX package's dataclasses, which import no
jax, re-exported so that callers of the port name only the port."""
from repeatresolver_tpu.config import (InitialAlignerConfig, MaxCorrConfig,
                                       PipelineConfig, ReadCutterConfig,
                                       RealignerConfig, ResolverConfig,
                                       SimulatorConfig, WindowConfig)

__all__ = ["InitialAlignerConfig", "MaxCorrConfig", "PipelineConfig",
           "ReadCutterConfig", "RealignerConfig", "ResolverConfig",
           "SimulatorConfig", "WindowConfig"]
