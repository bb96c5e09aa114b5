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


def _wrapped_batch(seed, lq, lt):
    """[5, lq] queries (pad 100) of any lengths against any target:
    mutated copies of the target wrapped around (np.resize), so Lq may
    pass Lt; rows of length lq, 0, 1, and two random ones."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, lt).astype(np.int16)
    t[lt // 3:lt // 3 + min(lt // 4, 20)] = 0       # homopolymer run
    lens = np.array([lq, 0, 1, *rng.integers(1, lq + 1, 2)], np.int32)
    q = np.full((5, lq), 100, np.int16)
    for r, n in enumerate(lens):
        src = np.resize(np.roll(t, -r), n)
        mut = rng.random(n) < 0.15
        src[mut] = rng.integers(0, 4, mut.sum())
        q[r, :n] = src
    return q, lens, t


def _homopolymers(lq, lt):
    """Every query and the target one symbol: every cell a tie."""
    q = np.full((4, lq), 1, np.int16)
    lens = np.array([lq, 0, 1, lq // 2], np.int32)
    q[3, lens[3]:] = 100
    return q, lens, np.full(lt, 1, np.int16)


@pytest.mark.parametrize("case", ["lq_above_lt", "homopolymers", "lt_2",
                                  "one_query_row", "wide"])
def test_plain_edge_shapes_match_jax(case):
    """The plain versions at the shapes that strain the kernels' design:
    Lq > Lt (uncut reads against the template), tie-only homopolymers,
    the shortest target align_on_device takes, one query row, and a
    target wider than one segment of kernel C (> 8,192 columns). Codes
    cover every row, past qlen included; rows of qlen 0 and 1 are in
    every batch but one_query_row."""
    q, lens, t = {
        "lq_above_lt": lambda: _wrapped_batch(3, 90, 25),
        "homopolymers": lambda: _homopolymers(40, 33),
        "lt_2": lambda: _wrapped_batch(4, 12, 2),
        "one_query_row": lambda: (np.array([[0, 1, 2, 3, 2]], np.int16),
                                  np.array([5], np.int32),
                                  np.array([3, 0, 1, 2, 3, 2, 1], np.int16)),
        "wide": lambda: _wrapped_batch(5, 24, 8300),
    }[case]()
    codes_j, fr_j = jed.align_with_codes(q, lens, t)
    codes_p, fr_p = ped.align_with_codes(_t(q), _t(lens), _t(t))
    np.testing.assert_array_equal(codes_p.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(fr_p.numpy(), np.asarray(fr_j))
    np.testing.assert_array_equal(
        ped.last_rows(_t(q), _t(lens), _t(t)).numpy(),
        np.asarray(jed.last_rows(q, lens, t)))
    al_j, _ = jed.align_on_device(q, lens, t)
    al_p, _ = ped.align_on_device(_t(q), _t(lens), _t(t))
    np.testing.assert_array_equal(al_p.numpy(), np.asarray(al_j))


def test_cut_shape_stride0_queries_match_jax():
    """Cut's call: one template part expanded (stride 0) over the batch
    against per-read targets padded with 200, queries padded with 100."""
    rng = np.random.default_rng(6)
    reads = rng.integers(0, 4, (5, 300)).astype(np.int16)
    reads[1, 120:] = 200
    reads[3, 40:] = 200
    part = np.concatenate([reads[2, 50:80], np.full(6, 100, np.int16)])
    lens = np.full(5, len(part), np.int32)
    ref = np.asarray(jed.last_rows(np.tile(part, (5, 1)), lens, reads))
    q = torch.from_numpy(part)[None, :].expand(5, -1)
    assert q.stride(0) == 0
    got = ped.last_rows(q, _t(lens), _t(reads))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert int(ref.min()) < 10                   # the part's own read


def test_one_column_target():
    """Lt = 1: final rows as the JAX scan gives them; align_on_device
    has no column to enter from and raises, as the JAX function does."""
    q, lens, _ = _batch(7, 9, 30)
    t = np.array([2], np.int16)
    np.testing.assert_array_equal(
        ped.last_rows(_t(q), _t(lens), _t(t)).numpy(),
        np.asarray(jed.last_rows(q, lens, t)))
    with pytest.raises(ValueError):
        jed.align_on_device(q, lens, t)
    with pytest.raises(ValueError, match="2 columns"):
        ped.align_on_device(_t(q), _t(lens), _t(t))


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


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it takes the card's
    route through ops/editdp.py without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _FakeKernels:
    """Stands in for the compiled libraries of kernels C and D: records
    each launch's arguments and returns `err`."""

    def __init__(self, err=0):
        self.err = err
        self.launches = []

    def editdp_fill_launch(self, *args):
        self.launches.append(("fill", args))
        return self.err

    def editdp_walk_launch(self, *args):
        self.launches.append(("walk", args))
        return self.err

    def editdp_fill_error_string(self, err):
        return b"stand-in error"

    editdp_walk_error_string = editdp_fill_error_string


def _cuda_typed(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).as_subclass(_CudaTyped)
            for a in arrays]


@pytest.fixture
def card_route(monkeypatch):
    """editdp's card route with the kernels' libraries stood in for and
    the plain loop made to fail if it runs."""
    import ctypes

    from repeatresolver_tpu_torch.ops import _build, cuda_editdp

    def plain(*a, **k):
        raise AssertionError("the plain loop ran on the card route")
    monkeypatch.setattr(ped, "forward_plain", plain)
    monkeypatch.setattr(ped, "walk_plain", plain)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: ctypes.c_void_p())
    fake = _FakeKernels()
    monkeypatch.setattr(_build, "load", lambda name: fake)
    return fake, cuda_editdp, monkeypatch


def test_card_route_reaches_the_kernels(card_route):
    """CUDA-typed calls reach kernels C and D, never the plain loop, with
    the mode, strides and layout of each entry point: cut's stride-0
    queries (mode 0), align_with_codes (mode 1, int8 [Lq, B, Lt]) and
    align_on_device (mode 2 and the walk over its packed codes)."""
    fake, ce, _ = card_route
    q, lens, t = _batch(8, 40, 33000)              # two segments
    qd, ld, td = _cuda_typed(q, lens, t)
    n_fill, n_walk = ce.editdp_fill.launches, ce.editdp_walk.launches
    fr = ped.last_rows(qd[:1].expand(6, -1), ld, td)
    assert fr.shape == (6, 33000) and fr.dtype == torch.int32
    kind, a = fake.launches[-1]
    # query codes, qlens, target codes, target row stride (0: one row
    # for the batch), B, Lq, Lt, mode, threads, rows a CTA, segments,
    # steps, symbol table rows, int8 codes, packed codes, final rows,
    # carries
    assert kind == "fill" and a[3] == 0
    assert a[4:13] == (6, 40, 33000, 0, 544, 1, 2, 40 + 543, 8)
    assert a[13] is None and a[14] is None and a[16] is not None
    codes, _ = ped.align_with_codes(qd, ld, td)
    a = fake.launches[-1][1]
    assert a[7] == 1 and codes.shape == (6, 40, 33000)
    al, _ = ped.align_on_device(qd, ld, td)
    (k1, fill), (k2, walk) = fake.launches[-2:]
    assert (k1, fill[7], k2) == ("fill", 2, "walk") and al.shape == (6, 40)
    assert walk[5:11] == (6, 40, 33000, 544, 2, 40 + 543)
    assert ce.editdp_fill.launches == n_fill + 3
    assert ce.editdp_walk.launches == n_walk + 1


def test_card_route_raises_on_launch_and_build_errors(card_route):
    """A launch error and a failed build raise; nothing falls back to
    the plain loop (which the fixture makes fail)."""
    fake, ce, monkeypatch = card_route
    qd, ld, td = _cuda_typed(*_batch(9, 20, 50))
    fake.err = 700
    n_fill = ce.editdp_fill.launches
    with pytest.raises(RuntimeError, match="editdp_fill launch failed"):
        ped.align_on_device(qd, ld, td)
    assert ce.editdp_fill.launches == n_fill

    def no_nvcc(name):
        raise RuntimeError("nvcc failed on csrc/editdp_fill.cu")
    monkeypatch.setattr(ce._build, "load", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ped.last_rows(qd, ld, td)
    with pytest.raises(ValueError, match="int16"):
        ped.last_rows(qd.to(torch.int32), ld, td)


def test_packed_layout():
    """cuda_editdp.pack_codes (the plain version of kernel C's packed
    store) and packed_rows against the layout written out: pair [b, seg,
    x + k, k] holds the codes of columns 32*(seg*T + k) .. +31 at row x,
    plane 0 their low bits and plane 1 their high bits, column 32*j + i
    at bit i; and the layout of the widths the main path uses."""
    from repeatresolver_tpu_torch.ops import cuda_editdp as ce
    assert ce.layout(13700, 4000) == (128, 1, 13827)
    assert ce.layout(66, 25950) == (832, 1, 897)
    assert ce.layout(30693, 30000) == (960, 1, 31652)
    assert ce.layout(5, 1) == (32, 1, 36)
    rng = np.random.default_rng(3)
    lq, b, lt = 3, 2, 33000                       # two segments
    threads, nseg, steps = ce.layout(lq, lt)
    assert (threads, nseg, steps) == (544, 2, 546)
    codes = rng.integers(0, 4, (lq, b, lt)).astype(np.int8)
    got = ce.pack_codes(torch.from_numpy(codes)).numpy()
    want = np.zeros((b, nseg, steps, threads, 2), np.uint64)
    x, r, y = (a.ravel() for a in np.meshgrid(
        np.arange(lq), np.arange(b), np.arange(lt), indexing="ij"))
    seg, k = np.divmod(y // 32, threads)
    for bit in (0, 1):
        val = ((codes[x, r, y].astype(np.uint64) >> np.uint64(bit))
               & np.uint64(1)) << (y % 32).astype(np.uint64)
        np.add.at(want, (r, seg, x + k, k, bit), val)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  want.astype(np.uint32))
    rows = ce.packed_rows(lq, lt).numpy()
    s, k = 7, 5
    assert rows.shape == (steps, threads) and rows[s, k] == s - k
    assert ce.packed_bytes_per_row(13700, 4000) == 8 * 13827 * 128
    assert ped.code_bytes_per_row(13700, 4000, "cpu") == 13700 * 4000
