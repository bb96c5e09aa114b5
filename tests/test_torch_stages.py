"""The port's cut and initial align against the JAX package's native paths.

Both run the native host kernels (the JAX package picks them on the CPU
backend); the port's numpy logic around them must write byte-equal
_Seq.fasta, _MSA and _SeqClass files for the tiny_dataset fixture, with
the full DP and with the anchored band the realign oracle's dataset
uses.
"""
import os

import numpy as np
import pytest


def _cut_and_align(cut_mod, align_mod, tiny_dataset, outdir, band, **route):
    from repeatresolver_tpu.config import (InitialAlignerConfig,
                                           ReadCutterConfig)
    from repeatresolver_tpu.utils import io as rio
    ds, paths = tiny_dataset
    template = rio.read_template(paths["template"]).astype(np.int16)
    reads = [r.astype(np.int16) for r in rio.read_fasta(paths["reads"])]
    cut = cut_mod.cut_reads(template, reads, ReadCutterConfig(), **route)
    os.makedirs(outdir, exist_ok=True)
    rio.write_fasta(os.path.join(outdir, "X_Seq.fasta"), cut.pieces,
                    line_width=None)
    seqs = [s.astype(np.int16) for s in cut.pieces]
    res = align_mod.build_initial_msa(template, seqs,
                                      InitialAlignerConfig(band=band),
                                      **route)
    align_mod.write_outputs(res, os.path.join(outdir, "X_MSA"),
                            os.path.join(outdir, "X_SeqClass"))
    return cut


@pytest.mark.parametrize("band", [0, 3000])
def test_cut_and_align_match_jax_native(tiny_dataset, tmp_path, band):
    from repeatresolver_tpu.models import initial_aligner as jia
    from repeatresolver_tpu.models import read_cutter as jrc
    from repeatresolver_tpu_torch.models import initial_aligner as pia
    from repeatresolver_tpu_torch.models import read_cutter as prc
    cut_j = _cut_and_align(jrc, jia, tiny_dataset, tmp_path / "jax", band)
    cut_p = _cut_and_align(prc, pia, tiny_dataset, tmp_path / "port", band,
                           device="cpu")
    assert cut_p.cutting_points == cut_j.cutting_points
    assert cut_p.seqs_per_read == cut_j.seqs_per_read
    for name in ("X_Seq.fasta", "X_MSA", "X_SeqClass"):
        with open(tmp_path / "jax" / name, "rb") as fj, \
                open(tmp_path / "port" / name, "rb") as fp:
            assert fp.read() == fj.read(), name


def test_stages_raise_without_native_lib(monkeypatch, tmp_path):
    """The port's own host library, with a compiler that does not exist
    and an empty build directory: cut and align raise."""
    from repeatresolver_tpu.config import ReadCutterConfig
    from repeatresolver_tpu_torch.models import initial_aligner as pia
    from repeatresolver_tpu_torch.models import read_cutter as prc
    from repeatresolver_tpu_torch.utils import native as nat
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "BUILD_DIR", str(tmp_path / "host"))
    monkeypatch.setattr(nat, "CXX", str(tmp_path / "no-such-g++"))
    seq = np.zeros(50, np.int16)
    with pytest.raises(RuntimeError, match="native"):
        prc.cut_reads(seq, [seq], ReadCutterConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="native"):
        pia.align_all(seq, [seq], device="cpu")
