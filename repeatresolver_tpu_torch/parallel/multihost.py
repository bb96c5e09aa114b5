"""Multi-process parallelism over windows.

Counterpart of repeatresolver_tpu/parallel/multihost.py. The
reference's outermost parallelism is an operator who launches
RepeatResolver once per window, possibly on different machines, and
merges the results through the on-disk subdivision files. Here
processes join a `torch.distributed` process group over TCP, each takes
a round-robin slice of the windows, and the merge is the same file
contract: the flank-connection chain
(models/assessment.multi_step_resolution) reads every window's
subdivision whichever process wrote it.

Windows are independent (RepeatResolver.c works on one [von, bis] range
per invocation), so no collective is needed beyond the final barrier;
realignment and MaxCorrs shard within a window instead
(parallel/sharded.py).
"""
from __future__ import annotations

import datetime
import os


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str = "gloo",
               timeout_s: float = 600.0) -> tuple[int, int]:
    """Join the process group at coordinator_address ("host:port", or
    "file://<path>" for processes of one machine) as
    process process_id of num_processes, over `backend` ("gloo", or
    "nccl" where every process has a GPU of its own); returns (rank,
    size). Without a coordinator the process stays alone: (0, 1).
    Idempotent: a process that has joined returns its rank and size."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is None:
        return 0, 1
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and "
                         "process_id")
    method = coordinator_address if coordinator_address.startswith(
        "file://") else f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend, init_method=method,
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size()


def shutdown() -> None:
    """Wait for every process at a barrier and leave the group (nothing
    to do for a process that never joined one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def window_slice(n_windows: int, process_id: int,
                 process_count: int) -> list[int]:
    """Deterministic round-robin window ownership."""
    return list(range(process_id, n_windows, process_count))


def resolve_windows(msareal_path: str, resolver_cfg, window_cfg,
                    process_id: int = 0, process_count: int = 1,
                    workdir: str | None = None,
                    progress=print, device="cuda") -> list[str]:
    """Resolve this process's window slice of the MSA, writing the
    reference-format subdivision files (RepeatResolver.c:4040-4075
    names). Every process computes the same deterministic window
    boundaries from the MSA; ownership is round-robin. `device` is where
    the resolver's exact products above the devmm gate run."""
    from ..models import resolver, window
    from ..utils import io as rio

    msareal = rio.read_msa(msareal_path)
    mc = rio.read_maxcorrs(os.path.join(
        os.path.dirname(msareal_path) or ".",
        rio.maxcorrs_path(os.path.basename(msareal_path))))
    bounds = window.window_boundaries(msareal, window_cfg)
    windows = list(zip(bounds[:-1], bounds[1:]))
    if workdir is None:
        workdir = os.path.dirname(msareal_path) or "."
    base = os.path.basename(msareal_path)
    written = []
    for w in window_slice(len(windows), process_id, process_count):
        von, bis = windows[w]
        out = resolver.resolve_window(msareal, mc, von, bis, resolver_cfg,
                                      device)
        for kind, u in out.items():
            p = os.path.join(workdir,
                             rio.subdivision_path(kind, von, bis, base))
            rio.write_subdivision(p, u)
            written.append(p)
        progress(f"[proc {process_id}/{process_count}] resolved window "
                 f"{von}-{bis}")
    return written
