"""Entry points for a compile check and a multi-rank dry run.

Counterpart of the repository root's __graft_entry__.py:

    python -m repeatresolver_tpu_torch.graft_entry [--device cuda|cpu] [--ranks N]

runs `entry()`'s function once and then `dryrun_multichip(N)`.
"""
from __future__ import annotations

import numpy as np
import torch


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args): the forward step of the flagship compute,
    the banded realignment DP fill over a block of MSA rows, with its
    seed-0 example arguments as tensors on `device`."""
    from .device import resolve_device
    from .ops.banded_realign import banded_fill

    dev = resolve_device(device)
    w = 128
    b, c, l = 4, 512, 256
    rng = np.random.default_rng(0)
    msa = rng.integers(0, 4, (b, c)).astype(np.int8)
    counts = np.zeros((c, 6), np.int32)
    for s in range(6):
        counts[:, s] = (msa == s).sum(axis=0) + 3
    seqs = rng.integers(0, 4, (b, l)).astype(np.int8)
    ways = np.sort(rng.integers(0, c, (b, l)), axis=1).astype(np.int32)
    lengths = np.full(b, l, np.int32)

    def fn(counts, rows_old, seqs, ways, lengths):
        return banded_fill(counts, rows_old, seqs, ways, lengths, c,
                           bandwidth=w)

    return fn, tuple(torch.from_numpy(a).to(dev)
                     for a in (counts, msa, seqs, ways, lengths))


def dryrun_multichip(n_devices: int,
                     device: str | torch.device = "cuda") -> None:
    """Every sharded step once over n_devices ranks
    (parallel/sharded.dryrun: rows data-parallel with the histogram
    delta summed, the striped MaxCorrs scan merged by max)."""
    from .parallel.sharded import dryrun
    dryrun(n_devices, device=device)


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="repeatresolver_tpu_torch.graft_entry")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--ranks", type=int, default=1,
                   help="ranks of the dry run (gloo; they share the card)")
    args = p.parse_args(argv)
    fn, example = entry(args.device)
    out = fn(*example)
    if args.device == "cuda":
        torch.cuda.synchronize()
    print("entry ok:", [tuple(o.shape) for o in out])
    dryrun_multichip(args.ranks, args.device)
    print(f"dryrun_multichip({args.ranks}) ok")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
