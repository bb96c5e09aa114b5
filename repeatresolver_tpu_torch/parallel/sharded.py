"""Sharding of the pipeline's two heavy phases over a process group.

Counterpart of repeatresolver_tpu/parallel/sharded.py. The JAX mesh is
one process over many devices (`shard_map`); here a mesh is one process
a device in a `torch.distributed` process group, and a `Mesh` is a small
object around that group: rank, size, this rank's device and the
backend, "nccl" where every rank has a GPU of its own and "gloo"
otherwise. The caller names the backend; nothing here guesses it.

  * realignment sweeps: every rank runs the same host loop on the same
    MSA (the loop is deterministic, so the host state stays
    replicated). In a block step a rank computes its slice of the
    block's rows; the rewritten rows and insert lists are all-gathered
    and the histogram delta is summed over the ranks, the collective
    analogue of the reference's disjoint-stripe thread writes.
  * MaxCorrs: seed tiles striped round-robin over the ranks (the
    reference's pthread seed stripes, MaxCorrelation.c:796), the
    accumulators merged by an elementwise max (the thread merge,
    :881-891): models/maxcorr.compute_maxcorrs_device(mesh=...).

gloo reduces and gathers host tensors. Where a rank's device is a GPU
and the backend is gloo (ranks that share one card), every collective
is staged through pinned host memory; `Mesh.staged` counts them.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device


@dataclass
class Mesh:
    """The default process group's view from one rank (no group at all
    when size is 1)."""
    rank: int
    size: int
    device: torch.device
    backend: str                       # "nccl", "gloo" or "none"
    staged: int = field(default=0, compare=False)
    _pinned: dict = field(default_factory=dict, compare=False, repr=False)

    def _stage(self, t: torch.Tensor, lead: int | None = None):
        """The pinned host buffer kept for t's shape and dtype (with
        `lead` rows in place of t's first dimension when given). One
        buffer a shape: a block step's shapes come from a few buckets."""
        shape = tuple(t.shape) if lead is None else (lead, *t.shape[1:])
        buf = self._pinned.get((shape, t.dtype))
        if buf is None:
            buf = torch.empty(shape, dtype=t.dtype, pin_memory=True)
            self._pinned[shape, t.dtype] = buf
        return buf

    def _through_host(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """Elementwise "sum" or "max" of t over the ranks."""
        if self.size == 1:
            return t
        import torch.distributed as dist
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if self._through_host(t):
            host = self._stage(t)
            host.copy_(t)
            self.staged += 1
            dist.all_reduce(host, op=rop)
            return host.to(t.device)
        out = t.clone()
        dist.all_reduce(out, op=rop)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' tensors (same shape on each) joined along dim 0
        in rank order."""
        if self.size == 1:
            return t
        import torch.distributed as dist
        if self._through_host(t):
            host = self._stage(t)
            host.copy_(t)
            self.staged += 1
            out = self._stage(t, self.size * t.shape[0])
            dist.all_gather(list(out.chunk(self.size)), host)
            return out.to(t.device)
        out = torch.empty((self.size * t.shape[0], *t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather(list(out.chunk(self.size)), t.contiguous())
        return out


def make_mesh(n_devices: int | None = None, *, backend: str | None = None,
              device: str | torch.device = "cuda") -> Mesh:
    """The mesh of this process: the default process group when one is
    initialized (parallel/multihost.initialize), else a single-rank
    mesh. n_devices, when given, must equal the group's size: a mesh of
    n ranks needs n processes, started by the caller.

    backend must name the initialized group's backend when given.
    device: this rank's device, "cuda" (with nccl: the GPU whose index
    is the rank modulo the visible GPUs; with gloo: the current one) or
    "cpu"."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
        have = dist.get_backend()
    else:
        rank, size, have = 0, 1, "none"
    n = n_devices or size
    if n != size:
        raise ValueError(
            f"need {n} ranks, have {size}: start {n} processes and join "
            "them with parallel.multihost.initialize")
    if backend is not None and size > 1 and backend != have:
        raise ValueError(f"backend {backend!r} named, but the process "
                         f"group runs {have!r}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and have == "nccl":
        dev = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    dev = resolve_device(dev)
    if have == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device per rank")
    return Mesh(rank=rank, size=size, device=dev, backend=have)


def _hist(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """int32 [C, 6] symbol histogram of int8 rows [B, C] over the cells
    where mask [B, C] holds."""
    return torch.stack([((rows == s) & mask).sum(dim=0, dtype=torch.int32)
                        for s in range(6)], dim=1)


def _shard(mesh: Mesh, arrays):
    """This rank's slice of each [B, ...] numpy array, as tensors on the
    rank's device; B must divide by the mesh size."""
    b = arrays[0].shape[0]
    if b % mesh.size:
        raise ValueError(f"{b} rows do not divide over {mesh.size} ranks")
    per = b // mesh.size
    sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
    return [torch.from_numpy(np.ascontiguousarray(a[sl])).to(mesh.device)
            for a in arrays]


def sharded_realign_step(mesh: Mesh, ncols: int, bandwidth: int):
    """One data-parallel realignment block step: exact-band DP and
    backtrack per row shard, the histogram delta summed over the mesh.

    Returns fn(counts [C, 6], rows_old [R, C], seqs, ways [R, L],
    lengths [R]) (numpy, the whole block on every rank) -> (new_rows
    [R, C], new_counts [C, 6], best [R]), numpy, the same on every
    rank."""
    from ..models.realigner import band_starts, block_dp

    def step(counts, rows_old, seqs, ways, lengths):
        anf_full, entry_bound = band_starts(ways, lengths, bandwidth, 1,
                                            False)
        counts_d = torch.from_numpy(
            np.ascontiguousarray(counts, np.int32)).to(mesh.device)
        rows_d, *rest = _shard(mesh, (rows_old, seqs, ways, lengths,
                                      anf_full, entry_bound))
        new_rows, best, _iy, _ib, _inn = block_dp(
            counts_d, rows_d, *rest, ncols, bandwidth=bandwidth, chunk=256,
            widen=1, staircase=False, kernel="torch")
        every = torch.ones_like(rows_d, dtype=torch.bool)
        delta = mesh.all_reduce(
            _hist(new_rows, every) - _hist(rows_d, every), "sum")
        return (mesh.all_gather(new_rows).cpu().numpy(),
                (counts_d + delta).cpu().numpy(),
                mesh.all_gather(best).cpu().numpy())

    return step


def sharded_block_realign(mesh: Mesh, bandwidth: int, mode: str = "exact",
                          chunk: int = 256, widen: int = 1,
                          kernel: str = "torch"):
    """The mesh step of BatchedRealigner: the block's rows sharded over
    the ranks, the histogram replicated, the delta summed over them.
    The DP is the one the single-process engine runs
    (models/realigner.block_dp), so the block-Jacobi trajectory is
    bit-equal to the unsharded one (tests/test_torch_sharded.py).

    Returns fn(counts [Cp, 6], rows_old [B, Cp], seqs [B, L], ways
    [B, L], lengths [B], anf_full [B, L], entry_bound [B], valid [B],
    ncols) (numpy, the whole padded block on every rank, B a multiple of
    the mesh size) -> (new_rows, iy, ib, inn, delta [Cp, 6]), numpy, the
    same on every rank. Rows with valid = 0 (padding duplicates) are
    left out of the delta.

    kernel "cuda" (staircase only) launches kernels A and B inside each
    shard, the packed time-major codes going straight into the walk; the
    exact band on CUDA tensors runs kernels F and G whatever the kernel
    (models/realigner.block_dp)."""
    from ..models.realigner import block_dp
    stair = mode == "staircase"

    def step(counts, rows_old, seqs, ways, lengths, anf_full, entry_bound,
             valid, ncols):
        counts_d = torch.from_numpy(
            np.ascontiguousarray(counts, np.int32)).to(mesh.device)
        rows_d, valid_d, *rest = _shard(
            mesh, (rows_old, valid, seqs, ways, lengths, anf_full,
                   entry_bound))
        new_rows, _best, iy, ib, inn = block_dp(
            counts_d, rows_d, *rest, int(ncols), bandwidth=bandwidth,
            chunk=chunk, widen=widen, staircase=stair, kernel=kernel)
        if not stair and rows_d.device.type == "cuda":
            # kernels F and G size a shard's insert lists by its own
            # walk: gather them at the widest shard's width
            width = int(mesh.all_reduce(torch.tensor(
                [iy.shape[1]], dtype=torch.int32, device=mesh.device),
                "max")[0])
            pad = (0, width - iy.shape[1])
            iy = torch.nn.functional.pad(iy, pad)
            ib = torch.nn.functional.pad(ib, pad)
        cols = torch.arange(rows_d.shape[1], device=mesh.device)
        mask = (valid_d > 0)[:, None] & (cols < int(ncols))[None, :]
        delta = mesh.all_reduce(
            _hist(new_rows, mask) - _hist(rows_d, mask), "sum")
        return tuple(t.cpu().numpy() for t in (
            mesh.all_gather(new_rows), mesh.all_gather(iy),
            mesh.all_gather(ib), mesh.all_gather(inn), delta))

    return step


def sharded_maxcorr_scores(mesh: Mesh):
    """Row-sharded group-intersection scores: each rank multiplies its
    shard of seed groups with the full group matrix, and the global
    maximum merges by a max over the ranks. This is the collective
    primitive; the sharded MaxCorrs proper, the whole gated scan striped
    over the mesh, is models/maxcorr.compute_maxcorrs_device(mesh=...).

    Returns fn(groups [C5, R] numpy, the same on every rank, C5 a
    multiple of the mesh size) -> (schnitt [C5, C5] float32, global max
    float), numpy."""

    def fn(groups):
        full = torch.from_numpy(
            np.ascontiguousarray(groups, np.float32)).to(mesh.device)
        shard, = _shard(mesh, (np.asarray(groups, np.float32),))
        schnitt = shard @ full.t()
        gmax = mesh.all_reduce(schnitt.max().reshape(1), "max")
        return mesh.all_gather(schnitt).cpu().numpy(), float(gmax[0])

    return fn


def dryrun(n_devices: int, bandwidth: int = 128,
           device: str | torch.device = "cuda",
           backend: str = "gloo") -> None:
    """Run every sharded step once on tiny shapes over n_devices ranks:
    the realign step, the score primitive, the striped MaxCorrs scan
    against the host scan, and a realign to convergence through the
    mesh against the single-process run.

    Inside a process group of n_devices ranks, every rank calls this
    and runs its share. Called outside any group with n_devices > 1, it
    starts the ranks itself (`spawn`, over `backend`) and waits for
    them."""
    import torch.distributed as dist
    if n_devices > 1 and not (dist.is_available()
                              and dist.is_initialized()):
        spawn(_dryrun_rank, n_devices, (bandwidth, str(device)),
              backend=backend)
        return
    _dryrun_rank(0, n_devices, bandwidth, device)


def _dryrun_rank(rank: int, n_devices: int, bandwidth: int, device) -> None:
    from ..config import MaxCorrConfig, RealignerConfig
    from ..models import maxcorr as mcx
    from ..models import realigner

    mesh = make_mesh(n_devices, device=device)
    rng = np.random.default_rng(0)
    rows_per_dev = 2
    r = n_devices * rows_per_dev
    c, l, w = 512, 256, bandwidth
    msa = np.full((r, c), 5, np.int8)
    for k in range(r):
        seg = rng.integers(0, 4, c - 40).astype(np.int8)
        gaps = rng.random(c - 40) < 0.1
        seg[gaps] = 4
        msa[k, 20:c - 20] = seg
    counts = np.zeros((c, 6), np.int32)
    for s in range(6):
        counts[:, s] = (msa == s).sum(axis=0)
    lengths = np.zeros(r, np.int32)
    seqs = np.zeros((r, l), np.int8)
    ways = np.zeros((r, l), np.int32)
    for k in range(r):
        pos = np.nonzero(msa[k] < 4)[0][:l]
        lengths[k] = len(pos)
        seqs[k, :len(pos)] = msa[k][pos]
        ways[k, :len(pos)] = pos
        if len(pos) < l:
            ways[k, len(pos):] = pos[-1] if len(pos) else 0

    step = sharded_realign_step(mesh, ncols=c, bandwidth=w)
    new_rows, new_counts, _best = step(counts, msa, seqs, ways, lengths)
    assert new_rows.shape == (r, c)
    assert new_counts.shape == (c, 6)

    c5 = 128 * n_devices
    groups = (rng.random((c5, r)) < 0.3).astype(np.float32)
    schnitt, gmax = sharded_maxcorr_scores(mesh)(groups)
    assert schnitt.shape == (c5, c5)
    assert gmax == schnitt.max()

    # the striped scan against the host scan, within float32 tolerance
    mc_cfg = MaxCorrConfig(mincov=8)
    host_mc = mcx.compute_maxcorrs(msa[:, :256], mc_cfg, native="never")
    mesh_mc = mcx.compute_maxcorrs_device(msa[:, :256], mc_cfg, tile=64,
                                          mesh=mesh)
    assert np.abs(mesh_mc - host_mc).max() < 1e-3

    # the mesh path proper: a synthetic MSA realigned to convergence
    # through the sharded block sweeps, against the single-process run
    tlen = 240
    tpl = rng.integers(0, 4, tlen)
    msa2 = np.full((16, tlen), 5, np.int8)
    for k in range(16):
        lo = int(rng.integers(0, 20))
        hi = tlen - int(rng.integers(0, 20))
        seg = tpl[lo:hi].copy()
        sub = rng.random(len(seg)) < 0.08
        seg[sub] = rng.integers(0, 4, int(sub.sum()))
        gap = rng.random(len(seg)) < 0.10
        seg[gap] = 4
        msa2[k, lo:hi] = seg
    cfg = RealignerConfig(bandwidth=96, block_rows=16)
    log_single: list = []
    ref = realigner.realign_batched(msa2.copy(), cfg, score_log=log_single,
                                    mode="exact", kernel="torch",
                                    device=mesh.device)
    log_mesh: list = []
    out = realigner.realign_batched(msa2.copy(), cfg, score_log=log_mesh,
                                    mode="exact", kernel="torch", mesh=mesh)
    assert log_mesh == log_single, (log_mesh, log_single)
    np.testing.assert_array_equal(out, ref)
    realigner.validate_counts(out, realigner.symbol_counts(out))


def spawn(fn, n: int, args=(), *, backend: str = "gloo",
          timeout: float = 600.0) -> None:
    """Run fn(rank, n, *args) in n fresh processes joined into one
    process group through a file in a temporary directory of their own
    (no port to pick, so none to lose to another process; the start
    method is spawn). A rank that fails, or that is still running after `timeout`
    seconds, makes this raise, and every rank is stopped first."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp
    rendezvous = tempfile.mkdtemp(prefix="rr_mesh_")
    ctx = mp.get_context("spawn")
    # not daemons: a rank may start workers of its own (a host scan's
    # pool); the finally below stops a rank that is left running
    procs = [ctx.Process(target=_spawned,
                         args=(fn, rank, n, rendezvous, backend, args))
             for rank in range(n)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
        bad = [(i, p.exitcode) for i, p in enumerate(procs)
               if p.is_alive() or p.exitcode != 0]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(rendezvous, ignore_errors=True)
    if bad:
        raise RuntimeError(f"ranks failed or hung (rank, exit code; None "
                           f"= still running after {timeout} s): {bad}")


def _spawned(fn, rank, n, rendezvous, backend, args):
    from . import multihost
    multihost.initialize(f"file://{rendezvous}/group", n, rank,
                         backend=backend)
    try:
        fn(rank, n, *args)
    finally:
        multihost.shutdown()

