"""Time kernels C and D (the edit DP of cut and align) on the card.

    python -m repeatresolver_tpu_torch.bench_editdp [--data DIR]

Run from a checkout's root on a machine with a GPU. Two inputs:
pipeline-615's largest align batch (256 pieces x Lq 13,700 x Lt 4,000,
chip_smoke.py's phase 3 input) and every align batch of chip_smoke.py's
phase 12 (the reads of its -l 30000 Tree dataset, cut on the host, in
the batches `initial_aligner` makes). Each kernel's time is the median
of chip_smoke.KERNEL_REPS runs after two warm-ups, each between its own
pair of CUDA events (the wrapper's work included). Prints the card's
name and power limit, then one JSON line. --data keeps the cut pieces,
so that several checkouts are timed on the same inputs in one run.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """The checkout's chip_smoke.py, for its timing and input helpers."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pieces(smoke, data):
    """(template, pieces) of phase 12's dataset, int16, cut on the host
    into `data` on first use."""
    import numpy as np

    from repeatresolver_tpu_torch import cli
    from repeatresolver_tpu_torch.utils import io as rio
    path = os.path.join(data, "pieces.npz")
    if not os.path.exists(path):
        os.makedirs(data, exist_ok=True)
        template = os.path.join(data, smoke.PAPER_NAME + "_Template.fasta")
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["simulate"] + smoke.PAPER_SIM + ["--outdir", data])
            cli.main(["cut", template,
                      os.path.join(data, smoke.PAPER_NAME + ".fasta"),
                      "--device", "cpu"])
        pieces = rio.read_fasta(rio.derived_paths(template)["seq_fasta"])
        np.savez(path, template=rio.read_template(template),
                 lens=np.array([len(p) for p in pieces]),
                 bases=np.concatenate(pieces))
    z = np.load(path)
    bounds = np.cumsum(z["lens"])[:-1]
    return (z["template"].astype(np.int16),
            [p.astype(np.int16) for p in np.split(z["bases"], bounds)])


def _time_batch(smoke, q, ql, t):
    """(C ms, D ms, longest walk) of one align batch, packed codes."""
    import torch

    from repeatresolver_tpu_torch.ops import cuda_editdp as ce
    reps = smoke.KERNEL_REPS
    (fr, packed), ms_c = smoke.time_launches(
        lambda: ce.editdp_fill(q, ql, t, codes="packed"), reps, "C")
    walked = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    _, ms_d = smoke.time_launches(
        lambda: ce.editdp_walk(packed, ql, fr, walked=walked), reps, "D")
    return ms_c, ms_d, int(walked.max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=os.path.join(REPO, "build",
                                                   "bench_editdp"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_editdp: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repeatresolver_tpu_torch.models import initial_aligner
    from repeatresolver_tpu_torch.ops import editdp
    smoke = _chip_smoke()
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    q, ql, t = (torch.from_numpy(a).to(dev) for a in
                smoke.kernel_tests().editdp_batch(1, 256, 13700, 4000))
    c3, d3, w3 = _time_batch(smoke, q, ql, t)
    del q, ql, t

    tpl, pieces = _pieces(smoke, args.data)
    batches = []

    def recording(*a):
        batches.append(a)
        return editdp.align_on_device(*a)
    initial_aligner.editdp = types.SimpleNamespace(
        **{**vars(editdp), "align_on_device": recording})
    try:
        initial_aligner.align_all(tpl, pieces, device=dev)
    finally:
        initial_aligner.editdp = editdp
    rows = []
    for q, ql, t in batches:
        c, d, w = _time_batch(smoke, q, ql, t)
        rows.append(dict(shape=[q.shape[0], q.shape[1], t.shape[0]],
                         C_ms=c, D_ms=d, longest_walk=w))
    print(json.dumps({
        "phase3_256x13700x4000": dict(C_ms=c3, D_ms=d3, longest_walk=w3),
        "phase12_align_batches": rows,
        "phase12_C_ms_sum": sum(r["C_ms"] for r in rows),
        "phase12_D_ms_sum": sum(r["D_ms"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
