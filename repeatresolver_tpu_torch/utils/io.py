"""The pipeline's file formats (FASTA, MSA, ReadSeqInfo, MaxCorrs,
subdivisions): the JAX package's readers and writers, which import no
jax, re-exported so that callers of the port name only the port."""
from repeatresolver_tpu.utils.io import (derived_paths, maxcorrs_path,
                                         read_fasta, read_ints, read_maxcorrs,
                                         read_msa, read_template,
                                         subdivision_path, write_fasta,
                                         write_maxcorrs, write_msa,
                                         write_readseqinfo, write_subdivision)

__all__ = ["derived_paths", "maxcorrs_path", "read_fasta", "read_ints",
           "read_maxcorrs", "read_msa", "read_template", "subdivision_path",
           "write_fasta", "write_maxcorrs", "write_msa", "write_readseqinfo",
           "write_subdivision"]
