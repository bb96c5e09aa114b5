"""File formats — the de-facto API of the reference pipeline (SURVEY.md §1).

Copied from repeatresolver_tpu/utils/io.py (same functions, same bytes
written and read).

Every reader/writer here round-trips the exact on-disk bytes the reference
tools produce/consume, so the two implementations can be mixed stage by
stage in golden tests.

Formats:
  FASTA            '>'-header records, bases on wrapped lines
                   (DataSimulator.py:241-246 writes 100 chars/line)
  MSA              equal-width rows over {a,c,g,t,-,' '}+newline
                   (InitialAligner.c:553-663); MSAreal is uppercase
                   (PW_ReAligner.c:1556-1598)
  MaxCorrs         siglength*5 '%f' floats, one per line
                   (MaxCorrelation.c:516-532)
  subdivision      one int per row of the original MSA, -1 for rows
                   excluded from the window (RepeatResolver.c:568-585,
                   note: no trailing newline)
  ReadSeqInfo      per read: running seq indices, space-separated
                   (ReadCutter.c:917-937)
  placements/copynumbers  one int per line (DataSimulator.py:249-257)
"""
from __future__ import annotations

import os
from typing import Iterable

import numpy as np

BASE2CODE = np.full(256, -1, dtype=np.int8)
for _i, _ch in enumerate("acgt"):
    BASE2CODE[ord(_ch)] = _i
    BASE2CODE[ord(_ch.upper())] = _i
SYM2CODE = BASE2CODE.copy()
SYM2CODE[ord("-")] = 4
SYM2CODE[ord("_")] = 4
SYM2CODE[ord(" ")] = 5

CODE2BASE = np.frombuffer(b"acgt- ", dtype=np.uint8)
CODE2BASE_UPPER = np.frombuffer(b"ACGT- ", dtype=np.uint8)


# ---------------------------------------------------------------- FASTA

def encode_seq(s: str | bytes) -> np.ndarray:
    """String -> int8 codes, silently dropping non-ACGT chars.

    Matches the readers of the C tools (e.g. ReadCutter.c:107-111), which
    skip anything that is not upper/lowercase ACGT.
    """
    if isinstance(s, str):
        s = s.encode()
    arr = BASE2CODE[np.frombuffer(s, dtype=np.uint8)]
    return arr[arr >= 0]


def decode_seq(codes: np.ndarray, upper: bool = False) -> str:
    table = CODE2BASE_UPPER if upper else CODE2BASE
    return table[np.asarray(codes, dtype=np.int8)].tobytes().decode()


def read_fasta(path: str | os.PathLike) -> list[np.ndarray]:
    """All records of a FASTA file as int8 code arrays (headers dropped)."""
    records: list[list[bytes]] = []
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                records.append([])
            else:
                if not records:
                    records.append([])  # headerless leading bases
                records[-1].append(line)
    out = []
    for chunks in records:
        arr = BASE2CODE[np.frombuffer(b"".join(chunks), dtype=np.uint8)]
        out.append(np.ascontiguousarray(arr[arr >= 0]))
    return out


class FastaIndex:
    """Streaming/offset FASTA access (the reference's Offsetter,
    InitialAligner.c:99-158): one cheap pass records each record's byte
    offset; records are then read individually on demand, so a
    paper-scale reads file never has to live in RAM at once.

    Usage: idx = FastaIndex(path); idx[k] -> int8 codes of record k;
    iteration yields every record in order."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self.offsets: list[int] = []
        ends: list[int] = []
        pos = 0
        with open(self.path, "rb") as f:
            for line in f:
                if line.startswith(b">"):
                    if self.offsets:
                        ends.append(pos)
                    self.offsets.append(pos)
                pos += len(line)
            if self.offsets:
                ends.append(pos)
        self._ends = ends

    def __len__(self) -> int:
        return len(self.offsets)

    def __getitem__(self, k: int) -> np.ndarray:
        if k < 0:
            k += len(self.offsets)
        with open(self.path, "rb") as f:
            f.seek(self.offsets[k])
            raw = f.read(self._ends[k] - self.offsets[k])
        body = b"".join(line for line in raw.splitlines()
                        if not line.startswith(b">"))
        arr = BASE2CODE[np.frombuffer(body, dtype=np.uint8)]
        return np.ascontiguousarray(arr[arr >= 0])

    def __iter__(self):
        with open(self.path, "rb") as f:
            chunks: list[bytes] = []
            started = False
            for line in f:
                if line.startswith(b">"):
                    if started:
                        yield self._decode(chunks)
                    chunks = []
                    started = True
                elif started or line.strip():
                    started = True
                    chunks.append(line)
            if started:
                yield self._decode(chunks)

    @staticmethod
    def _decode(chunks: list[bytes]) -> np.ndarray:
        arr = BASE2CODE[np.frombuffer(b"".join(chunks),
                                      dtype=np.uint8)]
        return np.ascontiguousarray(arr[arr >= 0])


def write_fasta(path: str | os.PathLike, seqs: Iterable[np.ndarray],
                line_width: int | None = 100) -> None:
    """'>' headers with no names, wrapped lines (DataSimulator style)."""
    with open(path, "wb") as f:
        for seq in seqs:
            f.write(b">\n")
            raw = CODE2BASE[np.asarray(seq, dtype=np.int8)].tobytes()
            if line_width is None:
                f.write(raw + b"\n")
            else:
                for t in range(0, len(raw), line_width):
                    f.write(raw[t:t + line_width] + b"\n")


def read_template(path: str | os.PathLike) -> np.ndarray:
    """Single-record template FASTA -> int8 codes (ReadCutter.c:155-193)."""
    recs = read_fasta(path)
    return np.concatenate(recs) if len(recs) > 1 else recs[0]


# ------------------------------------------------------------------ MSA

def read_msa(path: str | os.PathLike) -> np.ndarray:
    """MSA file -> int8[rows, cols]; aborts on ragged rows like the
    reference readers (PW_ReAligner.c:134, RepeatResolver.c:326).

    Fast path: one fromfile read, newline check as a strided gather,
    chunked symbol decode — a multi-GB paper MSA costs two fresh
    buffers instead of a per-line list plus full-size temporaries
    (fresh pages fault at ~6 MB/s on this VM, utils/hostmem.py)."""
    buf = np.fromfile(path, dtype=np.uint8)
    if buf.size:
        nl = np.flatnonzero(buf[:1 << 22] == 10)
        width = int(nl[0]) if nl.size else -1
        stride = width + 1
        if width >= 0 and buf.size % stride in (0, stride - 1):
            missing_nl = buf.size % stride == stride - 1
            nrows = buf.size // stride + (1 if missing_nl else 0)
            full = nrows - (1 if missing_nl else 0)
            if (buf[width::stride][:full] == 10).all():
                msa = np.empty((nrows, width), np.int8)
                step = max(1, (1 << 24) // max(width, 1))
                ok = True
                for k0 in range(0, full, step):
                    k1 = min(full, k0 + step)
                    view = buf[k0 * stride:k1 * stride].reshape(
                        k1 - k0, stride)[:, :width]
                    msa[k0:k1] = SYM2CODE[view]
                    if (msa[k0:k1] < 0).any():
                        ok = False
                        break
                if ok and missing_nl:
                    msa[-1] = SYM2CODE[buf[full * stride:]]
                    ok = not (msa[-1] < 0).any()
                if ok:
                    return msa
    # slow path: ragged or invalid input -> per-line reader with the
    # reference's abort semantics
    rows = []
    width = None
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\n")
            if width is None:
                width = len(line)
            elif len(line) != width:
                raise ValueError(
                    f"ragged MSA row: {len(line)} != {width} in {path}")
            rows.append(SYM2CODE[np.frombuffer(line, dtype=np.uint8)])
    msa = np.asarray(rows, dtype=np.int8)
    if (msa < 0).any():
        raise ValueError(f"invalid symbol in MSA {path}")
    return msa


def write_msa(path: str | os.PathLike, msa: np.ndarray,
              upper: bool = True) -> None:
    """MSAreal style: uppercase ACGT- and space (PW_ReAligner.c:1556-1598).
    Pass upper=False for the InitialAligner-style lowercase MSA."""
    table = CODE2BASE_UPPER if upper else CODE2BASE
    msa = np.asarray(msa, dtype=np.int8)
    r, c = msa.shape
    # chunked vectorized encode: one [chunk, c+1] staging buffer reused
    # across chunks (a per-row loop pays 13k+ small writes at paper
    # scale; a full-MSA temporary is a multi-GB first-touch —
    # utils/hostmem.py)
    step = max(1, (1 << 24) // max(c + 1, 1))
    buf = np.empty((step, c + 1), np.uint8)
    buf[:, c] = ord("\n")
    with open(path, "wb") as f:
        for k0 in range(0, r, step):
            m = msa[k0:k0 + step]
            n = len(m)
            np.take(table, m, out=buf[:n, :c])
            f.write(buf[:n].tobytes())


# ----------------------------------------------------- simple int files

def read_ints(path: str | os.PathLike) -> np.ndarray:
    """One int per line (ReadPlacements / ReadCopynumbers / subdivisions)."""
    with open(path) as f:
        return np.array([int(line) for line in f if line.strip() != ""],
                        dtype=np.int64)


def write_ints(path: str | os.PathLike, values: Iterable[int]) -> None:
    with open(path, "w") as f:
        for v in values:
            f.write(f"{int(v)}\n")


def write_subdivision(path: str | os.PathLike,
                      values: Iterable[int]) -> None:
    """RepeatResolver.c:568-585: newline-separated, NO trailing newline."""
    with open(path, "w") as f:
        f.write("\n".join(str(int(v)) for v in values))


# -------------------------------------------------------------- MaxCorrs

def read_maxcorrs(path: str | os.PathLike) -> np.ndarray:
    with open(path) as f:
        return np.array([float(line) for line in f if len(line) > 1],
                        dtype=np.float64)


def write_maxcorrs(path: str | os.PathLike, maxcorrs: np.ndarray) -> None:
    """'%f' per line exactly like MaxCorrelation.c:516-532."""
    with open(path, "w") as f:
        for v in np.asarray(maxcorrs, dtype=np.float64):
            f.write("%f\n" % v)


# ------------------------------------------------------------ ReadSeqInfo

def write_readseqinfo(path: str | os.PathLike,
                      seqs_per_read: Iterable[int]) -> None:
    """ReadCutter.c:917-937: per read a line 'i i+1 ... ' of running seq
    indices (with trailing space)."""
    with open(path, "w") as f:
        count = 0
        for n in seqs_per_read:
            f.write("".join(f"{count + j} " for j in range(n)))
            f.write("\n")
            count += n


def read_readseqinfo(path: str | os.PathLike) -> np.ndarray:
    """-> seq2read: for each seq the read index it came from
    (SimDataAssessment.py:68-77)."""
    seq2read = []
    with open(path) as f:
        for read_idx, line in enumerate(f):
            seq2read.extend(read_idx for _ in line.split())
    return np.array(seq2read, dtype=np.int64)


# --------------------------------------------------- filename contract

TEMPLATE_SUFFIX = "Template.fasta"


def data_prefix(template_path: str) -> str:
    """ReadCutter.c:948-973 / InitialAligner.c:677-699: everything before
    the literal suffix 'Template.fasta' ('' if the suffix is absent)."""
    if template_path.endswith(TEMPLATE_SUFFIX):
        return template_path[: -len(TEMPLATE_SUFFIX)]
    return ""


def derived_paths(template_path: str) -> dict[str, str]:
    prefix = data_prefix(template_path)
    return {
        "seq_fasta": prefix + "Seq.fasta",
        "readseqinfo": prefix + "ReadSeqInfo",
        "msa": prefix + "MSA",
        "seqclass": prefix + "SeqClass",
        "msareal": prefix + "MSAreal",
    }


def maxcorrs_path(msa_path: str) -> str:
    """MaxCorrelation.c:992-993: literal prefix on the path string."""
    return "MaxCorrsOf_" + msa_path


def subdivision_path(kind: str, von: int, bis: int, msa_path: str) -> str:
    """RepeatResolver.c:4040-4075."""
    assert kind in ("Dropoff", "RelDrop", "Kmeans")
    return f"{kind}SubdivisionOf_{von}_{bis}_{msa_path}"
