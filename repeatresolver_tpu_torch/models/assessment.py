"""Assessment of a resolution against the simulated ground truth (the
reference's SimDataAssessment.py and TransposonAssessment.py): the JAX
package's module, which imports no jax, re-exported."""
from repeatresolver_tpu.models.assessment import (SimDataset, assess_directory,
                                                  half_resolvability,
                                                  multi_step_resolution,
                                                  resolution_quality,
                                                  resolvability, signatures)

__all__ = ["SimDataset", "assess_directory", "half_resolvability",
           "multi_step_resolution", "resolution_quality", "resolvability",
           "signatures"]
