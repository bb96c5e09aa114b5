"""The port's edit DP (ops/editdp) and the device routes of cut and
align against the JAX package, on the CPU.

The same queries and targets, made with numpy from a seed, go through
the JAX functions (JAX on the CPU) and the port's torch ops (CPU
tensors). Every output is an integer (final rows, move codes,
alignments, files) and is compared exactly (tolerance 0). The batches
hold rows of query length 0 and 1 and tie-heavy rows (homopolymer runs
and repeats, where the diagonal / 'i' / 'd' priority and the entry
scan's largest-column rule decide).
"""
import os

import numpy as np
import pytest
import torch

from repeatresolver_tpu.ops import editdp as jed
from repeatresolver_tpu_torch.ops import editdp as ped


def _batch(seed, lq, lt):
    """[6, lq] queries (pad 100): random, length 0, length 1, a
    homopolymer, a repeat of the target's start, a mutated slice."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, lt).astype(np.int16)
    t[10:30] = 2                                   # homopolymer run
    lens = np.array([lq, 0, 1, lq // 2, lq, lq - 3], np.int32)
    q = np.full((6, lq), 100, np.int16)
    q[0] = rng.integers(0, 4, lq)
    q[2, 0] = 2
    q[3, :lens[3]] = 2
    q[4] = np.tile(t[:lq // 3 + 1], 4)[:lq]
    src = t[5:5 + lens[5]].copy()
    mut = rng.random(lens[5]) < 0.15
    src[mut] = rng.integers(0, 4, mut.sum())
    q[5, :lens[5]] = src
    return q, lens, t


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_last_rows_matches_jax():
    q, lens, t = _batch(0, 33, 57)
    rng = np.random.default_rng(1)
    targets = np.stack([t] + [rng.integers(0, 4, 57).astype(np.int16)
                              for _ in range(5)])
    targets[3, 20:] = 200                          # a padded target
    calls = ped.last_rows.calls
    for tg in (targets, t):                        # per-row and shared
        ref = np.asarray(jed.last_rows(q, lens, tg))
        got = ped.last_rows(_t(q), _t(lens), _t(tg))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    assert ped.last_rows.calls == calls + 2


def test_align_with_codes_and_on_device_match_jax():
    q, lens, t = _batch(2, 40, 61)
    codes_j, fr_j = jed.align_with_codes(q, lens, t)
    codes_p, fr_p = ped.align_with_codes(_t(q), _t(lens), _t(t))
    np.testing.assert_array_equal(codes_p.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(fr_p.numpy(), np.asarray(fr_j))
    al_j, fr2_j = jed.align_on_device(q, lens, t)
    calls = ped.align_on_device.calls
    al_p, fr2_p = ped.align_on_device(_t(q), _t(lens), _t(t))
    assert ped.align_on_device.calls == calls + 1
    np.testing.assert_array_equal(al_p.numpy(), np.asarray(al_j))
    np.testing.assert_array_equal(fr2_p.numpy(), np.asarray(fr2_j))
    # the host backtrack over the same codes agrees, rows of length 0
    # all -1 included
    entries = np.array([ped.entry_column(r) for r in fr_p.numpy()])
    assert all(ped.entry_column(r) == jed.entry_column(r)
               for r in fr_p.numpy())
    for native in (True, False):
        host = ped.backtrack_batch(codes_p.numpy(), lens, entries,
                                   use_native=native)
        np.testing.assert_array_equal(host, al_p.numpy())
    assert (al_p[1] == -1).all()


def test_entry_column_ties():
    assert ped.entry_column(np.array([0, 5, 3, 3, 7])) == 3
    assert ped.entry_column(np.array([9, 4, 4, 4, 4])) == 4


def _cut_and_align(cut_mod, align_mod, tiny_dataset, outdir, **route):
    from repeatresolver_tpu.config import (InitialAlignerConfig,
                                           ReadCutterConfig)
    from repeatresolver_tpu.utils import io as rio
    _, paths = tiny_dataset
    template = rio.read_template(paths["template"]).astype(np.int16)
    reads = [r.astype(np.int16) for r in rio.read_fasta(paths["reads"])]
    cut = cut_mod.cut_reads(template, reads, ReadCutterConfig(), **route)
    os.makedirs(outdir, exist_ok=True)
    rio.write_fasta(os.path.join(outdir, "X_Seq.fasta"), cut.pieces,
                    line_width=None)
    rio.write_readseqinfo(os.path.join(outdir, "X_ReadSeqInfo"),
                          cut.seqs_per_read)
    seqs = [s.astype(np.int16) for s in cut.pieces]
    res = align_mod.build_initial_msa(template, seqs,
                                      InitialAlignerConfig(), **route)
    align_mod.write_outputs(res, os.path.join(outdir, "X_MSA"),
                            os.path.join(outdir, "X_SeqClass"))
    return cut, res


def test_device_route_cut_and_align_match_jax(tiny_dataset, tmp_path,
                                              monkeypatch):
    """The JAX package without the native library takes its device
    route (editdp) for cut and align; the port's device route on CPU
    tensors must write the same files, and the same as the native route
    the JAX package takes on the CPU."""
    from repeatresolver_tpu.models import initial_aligner as jia
    from repeatresolver_tpu.models import read_cutter as jrc
    from repeatresolver_tpu.utils import native as nat
    from repeatresolver_tpu_torch.models import initial_aligner as pia
    from repeatresolver_tpu_torch.models import read_cutter as prc
    _cut_and_align(prc, pia, tiny_dataset, tmp_path / "native", device="cpu")
    lib = nat.get_lib
    monkeypatch.setattr(nat, "get_lib", lambda: None)
    cut_j, res_j = _cut_and_align(jrc, jia, tiny_dataset, tmp_path / "jax")
    calls = (ped.last_rows.calls, ped.align_on_device.calls)
    cut_p, res_p = _cut_and_align(prc, pia, tiny_dataset, tmp_path / "port",
                                  device="cpu", use_native=False)
    assert ped.last_rows.calls > calls[0]
    assert ped.align_on_device.calls > calls[1]
    monkeypatch.setattr(nat, "get_lib", lib)
    assert cut_p.cutting_points == cut_j.cutting_points
    np.testing.assert_array_equal(res_p.errors, res_j.errors)
    for name in ("X_Seq.fasta", "X_ReadSeqInfo", "X_MSA", "X_SeqClass"):
        ref = (tmp_path / "jax" / name).read_bytes()
        assert (tmp_path / "port" / name).read_bytes() == ref, name
        assert (tmp_path / "native" / name).read_bytes() == ref, name


def test_cut_device_cuda_is_explicit(monkeypatch):
    from repeatresolver_tpu.config import ReadCutterConfig
    from repeatresolver_tpu_torch.models import read_cutter as prc
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seq = np.zeros(50, np.int16)
    with pytest.raises(RuntimeError, match="CUDA"):
        prc.cut_reads(seq, [seq], ReadCutterConfig(), device="cuda")
