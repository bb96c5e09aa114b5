#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py          # from the repository root; one GPU

Phases (each raises on failure, or when jax or any module of the JAX
package repeatresolver_tpu was imported, so any failure exits non-zero):

  1. card and build: the card's name, power limit and SM clock, torch /
     CUDA versions, the nvcc build of the eight kernels from csrc/ (one
     nvcc each, started together) and the g++ build of the port's host
     library;
  2. kernels vs plain versions, small random blocks (gap-dense paths,
     rows of length 0 and 1), on the GPU: bit-equal codes, band, moves
     and (rows, best, iy, ib, inn) of kernels A and B; for kernels C and
     D (the edit DP of cut and align), small batches with rows of length
     0 and 1 and homopolymer ties: final rows, packed and int8 codes and
     walks of align batches (shared target, Lq > Lt, two segments),
     final rows of cut batches (stride-0 queries, 200-padded targets,
     two and three segments), bit-equal to forward_plain / walk_plain;
     for kernels F and G (the exact band), blocks with shifts past the
     band, rows of length 0 and 1, padding columns, a row ending at the
     last column, ways not edge-padded past the rows' ends and bands 16
     to 16,384 (the clustered layout's cap, eight CTAs a row) and
     20,000 to 65,536 (the wide layout), F's wide layout also at bands
     16 to 2,600: codes, band and band start, moves, entry and best
     bit-equal to their plain versions; a row of more inserts than
     MAX_INSERTS, whose rows, best and insert lists equal the host
     native engine's; and a band whose one row's codes pass the device
     memory budget (RR_DEVICE_HBM_BUDGET set low), which block_dp and
     the engines on the card refuse with a ValueError;
  3. the same at the production dispatch shape (64 rows x 32,768 bases,
     band 1000, chunk 128, widen 6, MSA width 139,264), with the times
     (a kernel's: the median of KERNEL_REPS runs after two warm-ups, with
     the spread) and cells/s of each kernel and of its plain version,
     each kernel's bound (the larger of bytes over the memory rate and
     int32 operations over the card's integer rate), and kernel A's
     time at widen 1, 8, 10, 12 and 16 (W2 1,128 to 3,048); then
     kernels C and D at pipeline-615's largest align batch (256 pieces x
     Lq 13,700 x Lt 4,000) and C at cut's shape (64 x 66 x 25,950), the
     same way (all three modes of C checked), and their launches alone;
     then kernel E (the MaxCorrs group pass) at paper width: one group
     of phase 7's synthetic MSA (13,833 rows, tile 256, a seed tile
     against the 8 partner tiles from its diagonal, every seed alive)
     against its plain version (bit-equal: max |dZ| 0, the same alive
     seeds after each tile), E and the one int8 product it follows (over
     the seed tile's row window) timed queued (queued_ms), beside both
     bounds;
  4. the main path: the runs/tpu_converge dataset (Tree, c=25, n=8,
     d=1%, l=4000, seed 11) built with the port's host stages, then the
     port's CLI `realign -b 1000 -B 64 --device cuda`. Its OverallScore
     sequence must equal column 2 of runs/tpu_converge/scorelog_tpu (all
     24 lines; the JAX package's trajectory, identical on TPU and CPU),
     and both kernels must have launched. The anneal's tail runs blocks
     16 and 4 on kernels F and G (the non-resident exact engine) and
     block 1 on its serial sweep a row at a time through F and G over a
     column store on the card: the phase prints the tail's sweeps and
     seconds by route and block size, the split of its blocks on the
     card (host work, transfers, device, inside F and G, flushes) and of
     its block-1 rows (upload, download, row steps, inside F and G, host
     reads, splices, drops, regrows), and fails if a tail block (block 1
     included) took another route or F and G never launched. Then the same MSA at band 2600
     (block 64, 2 rounds), past kernel A's 4,096-lane window at the
     default slack: the resident engine on the card must equal the
     port's host native exact engine line for line, with both kernels
     launched (counts set to 0 just before that run; its exact blocks
     through kernels F and G at band 2600), and the first block step at
     each slack it ran (W2 up to 3,880) goes through both kernels and
     their plain versions, bit-equal; then at band 4200, where no
     staircase window fits kernel A and every block runs on kernels F
     and G (four CTAs a row), the same check. The runs print the exact
     blocks by route; on the card the host library's and the torch
     loop's count 0;
  5. kernels vs plain versions on the main path's own blocks: the fill
     inputs of the first block step at each slack (widen 12 first)
     recorded during phase 4, replayed through kernels A and B and their
     plain versions, bit-equal; the inputs of the anneal tail's first
     block at each of its block sizes on the card (16 and 4 rows),
     recorded during phase 4, through kernels F and G and their plain
     versions, bit-equal; then, from the MSA the resident engine handed
     to the tail, the first SERIAL_REPLAY_ROWS rows of a block-1 sweep on
     the card and on the host native engine, MSA and histogram equal
     after each row, and a sweep at each of the tail's block sizes (16,
     4 and 1) on the card's tail engine and on the host native engine
     (the median of TAIL_REPS each, the card's with its split a block or
     a row), MSA and histogram equal;
  6. the whole pipeline: the port's CLI `pipeline -c 40 -n 24 -d 1 -l
     4000 -t Tree --seed 11 -b 1000 -B 64 --device cuda` (615 MSA rows,
     so the MaxCorrs device scan's >= 512-row gate routes it to the
     card), with every resolver product sent to the card
     (RR_DEVICE_MM_MIN=0). The edit DP of cut and align (kernels C and
     D), kernels A and B, the MaxCorrs scan (one product and one call
     of kernel E a group queued, the groups' tiles summing to the tile
     pairs scanned) and the resolver products must each have run on the
     card, and the plain edit-DP loop and the plain group pass not at
     all; kernel E must equal its plain version bit for bit on groups of
     the run's MSAreal; cut and align must write the host native
     route's files byte for byte, MaxCorrs must make the host fast
     scan's decisions (within its tolerances), and one window's
     subdivisions must equal, byte for byte, a rerun with every product
     on the host. Prints each stage's seconds, each kernel's launches
     and seconds inside it (CUDA events)
     and the assessment, the exact blocks by route (the host library's
     and the torch loop's must count 0), and the anneal tail by route
     and block size (below block 32 on F and G only, block 1 included),
     then its sweeps on the card against the host native engine from
     the handoff's MSA, as in phase 5 (block 1 once on each route);
  7. the MaxCorrs device scan at the paper run's size: a synthetic MSA
     of 13,833 rows x 131,072 columns from seed 0; the band's first
     groups through kernel E and its plain version (bit-equal: max |dZ|
     0, the same alive seeds); the band of seed tiles scanned on the card
     (one product and one call of E a group queued, the groups' tiles
     summing to the pairs scanned, the plain pass never) and by the
     native host scan, same decisions within the same tolerances, with
     both times, the pairs scanned and needed, the host reads, and the
     ms a pair in the product and in E;
  8. the realign main path at the paper's repeat length: a Tree dataset
     with -l 30000 -d 1 (coverage 12, 8 copies: an MSA of 328 rows,
     more than three blocks of 64) built with the port's host stages,
     then `realign_batched` on the card, band 1000, block 64, capped at
     8 rounds so that only resident rounds run. Prints rows x columns,
     rounds, launches, the seconds in resident sweeps and, from CUDA
     events around both kernels' launches, the seconds inside kernel A,
     inside kernel B, inside kernels F and G and in the rest of the
     sweeps (torch ops and the per-block host read), the exact blocks by
     route (the host library's and the torch loop's must count 0) and
     each sweep's seconds beside its exact blocks' seconds by route. The
     score after every round must equal the
     same capped run at the same block size through the host native
     engine (exact band, independent of both kernels; RR_FLUSH_CAP high
     so that both flush once a sweep), and the first block's recorded
     inputs go through both kernels and their plain versions, bit-equal;
  9. the exact band on the card: phase 8's first block (64 rows, band
     1000) four ways: kernels F and G (block_dp's exact branch), the
     torch loop (ops/banded_realign: banded_fill + entry_and_backtrack)
     on CUDA tensors, kernels A and B, and the host native engine; rows,
     best and insert lists bit-equal, with the seconds of each. F and G
     against their plain versions on the block, bit-equal, and timed (the
     median of KERNEL_REPS runs) beside their bounds; F and G on the
     block's first 16 and first 4 rows (the anneal tail's block sizes),
     timed beside the host native engine on the same rows (the median
     of KERNEL_REPS runs each, inputs on the host before the clock
     starts), all equal; F on the block at 1, 2, 4 and 8 CTAs a row,
     each equal to the wrapper's layout and timed; F + G at band 20,000
     (the wide layout) on the block's first 4 rows, timed and equal to
     the host native engine (the median of 3 each). Then the resident
     engine on phase 4's MSA with every block forced onto the exact route
     (an insert fetch of one slot) and the host library made unavailable:
     kernels F and G must have run (counts set to 0 just before), the
     host and torch-loop routes not at all, and the score after each
     sweep must equal the host native engine's;
 10. the mesh path: two processes sharing the card, joined over gloo
     (collectives staged through pinned host memory). Each runs
     `realign_batched(mesh=..., mode="staircase", kernel="cuda")` on
     phase 8's MSA at block 64 for a few rounds: kernels A and B
     launched in both ranks (half a block's rows a launch), every
     OverallScore line equal to the single-process non-resident run
     and to phase 8's, with each rank's seconds inside kernel A, inside
     kernel B, in collectives and in the rest; each rank's launch
     counts are set to 0 just before the run and must be equal, and
     each rank replays its first shard (32 rows at the non-resident
     engine's padding) through both kernels and their plain versions,
     bit-equal; the torch loop of the exact band must not run in a rank.
     Then the MaxCorrs scan
     of phase 6's MSAreal striped over the two ranks: equal to phase
     6's single scan, tolerance 0, one product and one call of kernel E
     a group queued in both ranks and the plain group pass in neither,
     and E bit-equal to its plain version on a group of each stripe;
 11. `cli resolve-windows` on phase 6's files, two processes joined
     over gloo (`--coordinator 127.0.0.1:<port> --procs 2 --proc-id i
     --device cuda`): subdivision files byte-identical to a
     single-process run and to the pipeline's; then `python -m
     repeatresolver_tpu_torch.graft_entry --ranks 2`;
 12. cut and align at the paper's repeat length on the card: phase 8's
     reads (a copy) through `cli cut --device cuda` and `cli align
     --device cuda` (kernels C and D; the plain edit-DP loop must not
     run). Cut's _Seq.fasta and _ReadSeqInfo must equal phase 8's `cli
     cut --device cpu` byte for byte; every 10th piece by length must
     have the alignments and error of the host native full DP (band 0),
     tolerance 0. Prints each stage's seconds, the launches, the seconds
     inside C and D and the cells/s. Then the inputs recorded from the
     first cut call (whole) and from the first align call and the one
     with the most DP rows (three rows each, at the batch's Lq) go
     through C and D and their plain versions, bit-equal;
 13. the paper-run driver (`python -m repeatresolver_tpu_torch.paper_run
     ... --device cuda`) at -c 16 -n 8 -l 3000 -d 1 --seed 11, block 64:
     once --until align and then resumed to the end, and once straight,
     each in a process of its own with every count at 0. Each stage
     must stand once in stage_times.json, the resume must leave the
     earlier stages' files untouched and launch neither C nor D, and
     every file must equal the straight run's (stage_times.json: the
     same stages; .done: the same rounds; the realign checkpoint, an
     npz whose zip members carry their write time: the same arrays).
     Kernels A-D must each have launched, the plain edit-DP loop and the
     exact band's torch loop not at all;
 14. resolve on the card (kernel H, relative_vars' pair pass, and the
     card route of models/resolver.resolve_window): phase 6's windows
     through the card route, with H's launch count set to 0 before, each
     window's three subdivision files byte-equal to the host route's
     (device "cpu"), H launched, the host route's candidate statistics
     and relative_vars never called. A synthetic MSA at the paper run's
     shape (about 3,000 rows of 100 copies, 26-34 rows a copy, over
     17,733 columns, the copies from the simulator's Tree; MaxCorrs from
     the device scan): its first RESOLVE_QUARTER columns through the
     card route, timed with its split; then H at the paper-default
     run's scale, relative_vars of every copy of the whole width at once
     (`_relative_vars_card`; the significant groups cut at the group
     index where a cluster selects PAPER_SEL_ROWS of them on average, as
     in a paper-default window), its tables in shared memory as a
     paper-default window's are, its host seconds, the host route's
     relative_vars on its clusters for RELVARS_HOST_S seconds (the same
     var lists), and the same pass with every cluster's decisions in
     the hash (the same var lists); H against its plain version on
     every launch recorded (bit-equal marks and occurrence bits, the
     same hash keys); H's time (the launch alone, median of
     KERNEL_REPS) and its plain version's on the paper-scale counting
     and lookup launches of both forms, beside their bound (the
     popcount pipe's, the int32 pipes' and the bytes' times, the
     largest named).

Every process a phase starts gets a time limit and is stopped when it
passes it; a rank that fails or hangs fails the phase, and so does a
rank that imported jax or the JAX package.

The second-to-last stdout line is a JSON object describing each kernel;
the last is {"ok": true, "device": {...}}. With no GPU, or without the
repository around it, the script fails before printing either.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
import types
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
KERNELS = {
    "staircase_fill": dict(
        source="repeatresolver_tpu_torch/csrc/staircase_fill.cu",
        replaces="repeatresolver_tpu/ops/pallas_realign.py:358"),
    "walk_backtrack": dict(
        source="repeatresolver_tpu_torch/csrc/walk_backtrack.cu",
        replaces="repeatresolver_tpu/ops/pallas_backtrack.py:129"),
    # kernels C and D replace XLA code (scans and a while loop), not a
    # Pallas kernel
    "editdp_fill": dict(
        source="repeatresolver_tpu_torch/csrc/editdp_fill.cu",
        replaces="repeatresolver_tpu/ops/editdp.py:69, :107, :135 (XLA)"),
    "editdp_walk": dict(
        source="repeatresolver_tpu_torch/csrc/editdp_walk.cu",
        replaces="repeatresolver_tpu/ops/editdp.py:135 (XLA)"),
    # kernel E replaces the XLA body of the MaxCorrs tile step after its
    # products and the significance's while loop (a group of tile pairs a
    # call)
    "maxcorr_tile": dict(
        source="repeatresolver_tpu_torch/csrc/maxcorr_tile.cu",
        replaces="repeatresolver_tpu/models/maxcorr.py:303-343 and "
                 "repeatresolver_tpu/ops/hypergeom_device.py:81-159 (XLA)"),
    # kernels F and G replace the XLA exact band: the fill's scans, the
    # entry scan and the walk's while loop
    "exact_fill": dict(
        source="repeatresolver_tpu_torch/csrc/exact_fill.cu",
        replaces="repeatresolver_tpu/ops/banded_realign.py:54-208 (XLA)"),
    "exact_walk": dict(
        source="repeatresolver_tpu_torch/csrc/exact_walk.cu",
        replaces="repeatresolver_tpu/ops/banded_realign.py:210-244, "
                 ":247-401 (XLA)"),
    # kernel H replaces host numpy code of the JAX package: the pair loop
    # of relative_vars
    "resolver_pairs": dict(
        source="repeatresolver_tpu_torch/csrc/resolver_pairs.cu",
        replaces="repeatresolver_tpu/models/resolver.py:534-570 "
                 "(relative_vars' pair loop, host numpy)"),
}
# the path whose launches stand in a kernel's `launches`
MAIN_PATH = {"staircase_fill": "realign_tpu_converge",
             "walk_backtrack": "realign_tpu_converge",
             "editdp_fill": "pipeline_615", "editdp_walk": "pipeline_615",
             "maxcorr_tile": "pipeline_615",
             "exact_fill": "realign_tpu_converge",
             "exact_walk": "realign_tpu_converge",
             "resolver_pairs": "pipeline_615"}
REALIGN_KERNELS = ("staircase_fill", "walk_backtrack")


@contextlib.contextmanager
def phase(name):
    """Print a phase's header and, when it succeeds, its seconds. A phase
    fails if it imported jax or anything of the JAX package: the port
    must run without either."""
    t0 = time.perf_counter()
    print(f"== {name}", flush=True)
    yield
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "repeatresolver_tpu"))
    if foreign:
        raise AssertionError(f"phase {name} imported {foreign}")
    print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def kernel_tests():
    """The CUDA kernel tests' module, loaded by path (other installed
    packages may shadow the top-level name `tests`), for its input
    generators (numpy, from a seed) and its packed-code comparison."""
    import importlib.util
    path = os.path.join(REPO, "tests", "test_torch_cuda_kernels.py")
    spec = importlib.util.spec_from_file_location("_cuda_kernel_tests",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launch_counters():
    """Each kernel's wrapper, whose `launches` counts its launches."""
    from repeatresolver_tpu_torch.ops import cuda_backtrack as cb
    from repeatresolver_tpu_torch.ops import cuda_editdp as ce
    from repeatresolver_tpu_torch.ops import cuda_exact as cx
    from repeatresolver_tpu_torch.ops import cuda_maxcorr as cm
    from repeatresolver_tpu_torch.ops import cuda_realign as cr
    from repeatresolver_tpu_torch.ops import cuda_resolver as cv
    return {"staircase_fill": cr.staircase_fill,
            "walk_backtrack": cb.backtrack_moves,
            "editdp_fill": ce.editdp_fill, "editdp_walk": ce.editdp_walk,
            "maxcorr_tile": cm.maxcorr_group, "exact_fill": cx.exact_fill,
            "exact_walk": cx.exact_walk, "resolver_pairs": cv.pair_pass}


def reset_launches():
    for fn in launch_counters().values():
        fn.launches = 0


def launches_now():
    return {k: fn.launches for k, fn in launch_counters().items()}


def compare_block(args, ncols, w, t, widen, cpad, timed=False):
    """Kernels A and B against their plain versions on one block of
    GPU tensors (counts, rows, seqs, ways, lengths), chained as a block
    step chains them; cpad is the width of the rewritten rows. Returns
    (max abs difference per kernel, times in ms or None: kernel A (the
    median of KERNEL_REPS runs), its plain version (one run), kernel B,
    its plain version)."""
    import torch

    from repeatresolver_tpu_torch.ops import cuda_backtrack as cb
    from repeatresolver_tpu_torch.ops import cuda_realign as cr
    from repeatresolver_tpu_torch.ops import staircase_realign as sr

    counts, msa, seqs, ways, lengths = args
    b = msa.shape[0]
    dev = msa.device
    w2 = w + widen * t

    def timed_call(fn, reps, key):
        return time_launches(fn, reps, key) if timed else (fn(), None)

    kw = dict(bandwidth=w, chunk=t, widen=widen)
    (ck, bk, ak), ms_a = timed_call(
        lambda: cr.staircase_fill(counts, msa, seqs, ways, lengths,
                                  ncols, **kw),
        KERNEL_REPS, "staircase_fill")
    (cp, bp, ap), plain_a = timed_call(
        lambda: sr.staircase_fill(counts, msa, seqs, ways, lengths,
                                  ncols, **kw), 1, None)
    err_a = max(int((ck.long() - cp.long()).abs().max()),
                int((bk.long() - bp.long()).abs().max()),
                int((ak.long() - ap.long()).abs().max()))
    anf_full = sr.staircase_anf(ways, w, t)
    last_way = ways[torch.arange(b, device=dev),
                    (lengths - 1).clamp(min=0)]
    entry_bound = (last_way - w // 2).clamp(min=-1)
    wayin, best = cb.entry_scan(bk, ak, entry_bound, ncols, cpad=cpad,
                                bandwidth=w2)
    aint = anf_full[:, ::t].contiguous()
    mk, ms_b = timed_call(
        lambda: cb.backtrack_moves(ck, wayin, aint, lengths, chunk=t),
        KERNEL_REPS, "walk_backtrack")
    mp, plain_b = timed_call(
        lambda: cb.walk_plain(ck, wayin, aint, lengths, chunk=t), 1, None)
    err_b = int((mk.long() - mp.long()).abs().max())
    nw = ck.shape[0]
    seqs_p = torch.nn.functional.pad(seqs, (0, nw * 16 - seqs.shape[1]))
    out_k = cb.moves_to_outputs(mk, seqs_p, lengths, best, cpad=cpad)
    out_p = cb.moves_to_outputs(mp, seqs_p, lengths, best, cpad=cpad)
    for x, y in zip(out_k, out_p):      # rows, best, iy, ib, inn
        err_b = max(err_b, int((x.long() - y.long()).abs().max()))
    if err_a or err_b:
        raise AssertionError(f"kernel != plain version: fill max abs "
                             f"err {err_a}, walk max abs err {err_b}")
    return (err_a, err_b), (ms_a, plain_a, ms_b, plain_b)


# timed runs of a kernel (the median is its time)
KERNEL_REPS = 5


def time_launches(fn, reps, key=None):
    """(result, ms). reps > 1 (a kernel): two warm-ups, then the median of
    reps runs, each between its own pair of CUDA events. The warm-ups
    leave the caching allocator holding both output buffers that
    back-to-back calls alternate between, so no cudaMalloc falls among
    the timed runs; time_launches.spread[key] is (min ms, max ms, device
    memory segments allocated while timing). reps == 1 (a plain version,
    seconds): the one run."""
    import torch
    if reps > 1:
        keep = fn()
        fn()
        del keep
    torch.cuda.synchronize()
    seg0 = torch.cuda.memory_stats().get("segment.all.allocated", 0)
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
          for _ in range(reps)]
    for e0, e1 in ev:
        e0.record()
        out = fn()
        e1.record()
    torch.cuda.synchronize()
    ms = sorted(e0.elapsed_time(e1) for e0, e1 in ev)
    if reps > 1:
        time_launches.spread[key] = (
            ms[0], ms[-1],
            torch.cuda.memory_stats().get("segment.all.allocated", 0) - seg0)
    return out, ms[len(ms) // 2]


time_launches.spread = {}


def spread(key):
    """A timed kernel's run-to-run spread, for printing."""
    lo, hi, segs = time_launches.spread[key]
    return (f"median of {KERNEL_REPS} runs, {lo:.3f}-{hi:.3f} ms, {segs} "
            f"device memory segments allocated while timing")


def launch_ms(fn, name):
    """The median over KERNEL_REPS calls of fn (after two warm-ups) of
    the time between the CUDA events its wrapper records around the
    launch of kernel `name` alone, without the wrapper's own work."""
    import torch

    from repeatresolver_tpu_torch.ops import _build
    fn()
    fn()
    torch.cuda.synchronize()
    _build.kernel_events = {}
    try:
        for _ in range(KERNEL_REPS):
            fn()
        torch.cuda.synchronize()
        ms = sorted(e0.elapsed_time(e1)
                    for e0, e1 in _build.kernel_events[name])
    finally:
        _build.kernel_events = None
    return ms[len(ms) // 2]


def one_window_ms(fn, reps):
    """(ms a run, device memory segments allocated while timing) of one
    warm-up and then reps runs under a single pair of CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    seg0 = torch.cuda.memory_stats().get("segment.all.allocated", 0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        out = fn()
    ev[1].record()
    torch.cuda.synchronize()
    del out
    return (ev[0].elapsed_time(ev[1]) / reps,
            torch.cuda.memory_stats().get("segment.all.allocated", 0) - seg0)


# cycles the card spins (torch.cuda._sleep) before a queued timing
# window: 1e8, about 50 ms at 1,980 MHz, while the host queues the runs
QUEUE_SLEEP_CYCLES = 100_000_000


def queued_ms(fn, reps):
    """ms a run of reps runs of fn back to back under one pair of CUDA
    events, after two warm-ups. The card spins first, so the host has
    queued every run (its own work, the wrapper's checks included) before
    the first starts, and the window holds the device's time alone; it
    raises if the spin ended before the runs were queued."""
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    started = ev[0].query()
    torch.cuda.synchronize()
    if started:
        raise AssertionError("the card reached the timing window before "
                             f"the host had queued {reps} runs")
    return ev[0].elapsed_time(ev[1]) / reps


def sm_mhz_under(fn):
    """The SM clock in MHz (nvidia-smi clocks.sm), read while fn runs on
    the card back to back."""
    import threading

    import torch
    got = {}

    def query():
        got["mhz"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.split()[0]
    th = threading.Thread(target=query)
    th.start()
    while th.is_alive():
        fn()
    torch.cuda.synchronize()
    th.join()
    return got.get("mhz", "not read")


def compare_editdp(q, lens, targets, timed=False):
    """Kernels C and D against their plain versions (forward_plain,
    walk_plain) on one batch of GPU tensors: int16 queries [B, Lq], int32
    qlens, int16 targets [Lt] (shared: align's packed codes and kernel D,
    as align_on_device runs them) or [B, Lt] (cut's final rows). Returns
    (max abs difference per kernel or None, times in ms or None: kernel C,
    its plain version (one run), kernel D, its plain version, and each
    row's walk steps or None)."""
    import torch

    from repeatresolver_tpu_torch.ops import cuda_editdp as ce
    from repeatresolver_tpu_torch.ops import editdp as ed

    b, lq = q.shape
    reps = KERNEL_REPS if timed else 1

    def diff(x, y):
        if not x.numel():
            return 0
        if x.dtype == torch.int8:
            # int8 codes [Lq, B, Lt], 14 GB at 256 x 13,700 x 4,000: a
            # chunk of rows at a time, widened to int16
            return max(int((a.to(torch.int16) - b.to(torch.int16)).abs()
                           .max()) for a, b in zip(x.split(256),
                                                   y.split(256)))
        return int((x.long() - y.long()).abs().max())
    if targets.dim() == 2:                          # cut
        (fr, _), ms_c = time_launches(
            lambda: ce.editdp_fill(q, lens, targets), reps, "editdp_fill")
        fr_p, plain_c = time_launches(
            lambda: ed.forward_plain(q, lens, targets), 1)
        err_c = diff(fr, fr_p)
        if err_c:
            raise AssertionError(f"kernel C != plain (final rows): {err_c}")
        return (err_c, None), (ms_c, plain_c, None, None, None)
    lt = targets.shape[0]
    (fr, packed), ms_c = time_launches(
        lambda: ce.editdp_fill(q, lens, targets, codes="packed"), reps,
        "editdp_fill")
    codes_p = torch.empty((lq, b, lt), dtype=torch.int8, device=q.device)
    fr_p, plain_c = time_launches(lambda: ed.forward_plain(
        q, lens, targets[None, :].expand(b, -1), codes_p), 1)
    err_c = max(diff(fr, fr_p),
                kernel_tests().packed_max_diff(packed, codes_p, lens))
    fr8, codes8 = ce.editdp_fill(q, lens, targets, codes="int8")
    err_c = max(err_c, diff(fr8, fr_p), diff(codes8, codes_p))
    del fr8, codes8                 # align_with_codes: int8, every row
    walked = torch.zeros(b, dtype=torch.int32, device=q.device)
    al, ms_d = time_launches(
        lambda: ce.editdp_walk(packed, lens, fr, walked=walked), reps,
        "editdp_walk")
    al_p, plain_d = time_launches(
        lambda: ed.walk_plain(codes_p, lens, fr_p), 1)
    err_d = diff(al, al_p)
    if err_c or err_d:
        raise AssertionError(f"kernel != plain version: fill max abs err "
                             f"{err_c}, walk max abs err {err_d}")
    return (err_c, err_d), (ms_c, plain_c, ms_d, plain_d, walked.cpu())


def replay_blocks(blocks, errs, what):
    """Recorded block steps ({widen: (counts, rows, seqs, ways, lengths;
    ncols; the fill's keywords)}) through kernels A and B and their plain
    versions, bit-equal, into errs."""
    for widen, (args, ncols, kw) in sorted(blocks.items()):
        (ea, eb), _ = compare_block(args, ncols, kw["bandwidth"],
                                    kw["chunk"], widen, args[1].shape[1])
        errs["staircase_fill"] = max(errs["staircase_fill"], ea)
        errs["walk_backtrack"] = max(errs["walk_backtrack"], eb)
        b, lpad = args[2].shape
        print(f"{what}: first block step at widen {widen} bit-equal to "
              f"the plain versions: {b} rows x {lpad} bases, MSA width "
              f"{ncols} of {args[1].shape[1]}, W2 "
              f"{kw['bandwidth'] + widen * kw['chunk']}")


def replay_editdp(kept, errs, what):
    """Kernels C and D against their plain versions on recorded inputs:
    cut's first batch whole (200-padded reads), and
    three rows (the longest, the median, the shortest) of the first align
    batch and of the one with the most DP rows, at the batch's Lq, so at
    the kernels' layout of the main run; into errs."""
    import torch
    t0 = time.perf_counter()
    q, ql, tg = kept["cut"]
    (ec, _), _ = compare_editdp(q, ql, tg)
    errs["editdp_fill"] = max(errs["editdp_fill"], ec)
    shapes = [f"cut {q.shape[0]} x {q.shape[1]} x {tg.shape[1]}"]
    for key in ("align_first", "align_longest"):
        q, ql, t = kept[key]
        order = torch.argsort(ql.long(), stable=True)
        rows = order[sorted({0, len(order) // 2, len(order) - 1})]
        (ec, ewd), _ = compare_editdp(q[rows], ql[rows], t)
        errs["editdp_fill"] = max(errs["editdp_fill"], ec)
        errs["editdp_walk"] = max(errs["editdp_walk"], ewd)
        shapes.append(f"{len(rows)} of {q.shape[0]} align rows x "
                      f"{q.shape[1]} x {t.shape[0]} (qlens "
                      f"{ql[rows].tolist()})")
    print(f"{what}: kernels C and D bit-equal to their plain versions on "
          f"its inputs ({'; '.join(shapes)}) in "
          f"{time.perf_counter() - t0:.1f} s")


def wide_band_check(card, msa, errs, band):
    """Phase 4's wide runs: the tpu_converge MSA at band 2600 or 4200,
    block 64, 2 rounds. At 2600 the default slack's window (2600 + 12 x
    128) passes kernel A's 4,096 lanes: the resident engine caps the
    slack at rung 10 and sends the blocks that no fitting rung covers to
    the exact band. At 4200 no staircase window fits kernel A, so every
    block runs on kernels F and G (four CTAs a row). The resident engine
    on the card is held against the port's host native exact engine at
    the same block size, line for line and byte for byte. RR_FLUSH_CAP
    is raised for both runs so that both splice once a sweep, as the
    engines' oracle needs. The first block step at each slack is
    recorded and replayed through kernels A and B and their plain
    versions, bit-equal, at this path's own windows. Returns the
    kernels' launches in the run on the card."""
    import numpy as np

    from repeatresolver_tpu_torch.config import RealignerConfig
    from repeatresolver_tpu_torch.models import realigner as prt
    from repeatresolver_tpu_torch.models import realigner_device as prd
    from repeatresolver_tpu_torch.ops import cuda_realign as cr
    cfg = RealignerConfig(bandwidth=band, block_rows=64, max_rounds=2)
    blocks = {}

    def recording_fill(*args, **kw):
        if kw["widen"] not in blocks:
            blocks[kw["widen"]] = ([a.clone() for a in args[:5]], args[5],
                                   kw)
        return cr.staircase_fill(*args, **kw)

    reset_exact_blocks()
    os.environ["RR_FLUSH_CAP"] = str(1 << 30)
    prd.cr = types.SimpleNamespace(
        **{**vars(cr), "staircase_fill": recording_fill})
    try:
        reset_launches()
        t0 = time.perf_counter()
        log_d: list = []
        out_d = prt.realign_batched(msa.copy(), cfg, score_log=log_d,
                                    device="cuda")
        t1 = time.perf_counter()
        launches = launches_now()
        ex = exact_blocks()
        prd.cr = cr
        log_h: list = []
        out_h = prt.realign_batched(msa.copy(), cfg, score_log=log_h,
                                    mode="exact", kernel="native",
                                    device="cpu")
        t2 = time.perf_counter()
    finally:
        prd.cr = cr
        del os.environ["RR_FLUSH_CAP"]
    what = f"band {band}"
    print(f"{what}: {len(log_d)} score lines, {log_d[-1]}; resident "
          f"engine on {card} {t1 - t0:.2f} s (launches {launches}, exact "
          f"blocks by route {ex}), host native exact engine "
          f"{t2 - t1:.2f} s")
    check_exact_routes(what, ex)
    if log_d != log_h or not np.array_equal(out_d, out_h):
        raise AssertionError(f"{what}: resident {log_d} != host native "
                             f"exact {log_h}")
    print(f"{what}: score lines and MSA equal to the host native exact "
          "engine's")
    need = REALIGN_KERNELS if blocks else ("exact_fill", "exact_walk")
    if min(launches[k] for k in need) <= 0 or (not blocks
                                               and ex["cuda"] <= 0):
        raise AssertionError(f"{what}: a kernel never launched: "
                             f"{launches}")
    replay_blocks(blocks, errs, what)
    return launches


def exact_blocks():
    """The exact band's blocks so far: the resident engine's by route
    (kernels F and G, the host library, the torch exact band) and the
    torch exact band's runs (banded_fill.calls: the plain loop, which
    only CPU tensors take)."""
    from repeatresolver_tpu_torch.models.realigner_device import \
        DeviceResidentRealigner as eng
    from repeatresolver_tpu_torch.ops import banded_realign as br
    return {**eng.exact_blocks_run, "plain_band_runs": br.banded_fill.calls}


def reset_exact_blocks():
    from repeatresolver_tpu_torch.models.realigner_device import \
        DeviceResidentRealigner as eng
    from repeatresolver_tpu_torch.ops import banded_realign as br
    eng.exact_blocks_run = dict.fromkeys(eng.ROUTES, 0)
    eng.exact_block_s = dict.fromkeys(eng.ROUTES, 0.0)
    eng.sweep_log = []
    br.banded_fill.calls = 0


def check_exact_routes(what, routes):
    """On the card every exact-band block runs kernels F and G: the host
    library's and the torch exact band's routes, and the plain loop,
    count 0."""
    off = {k: routes[k] for k in ("native", "torch", "plain_band_runs")
           if routes[k]}
    if off:
        raise AssertionError(f"{what}: exact blocks off the card's route: "
                             f"{routes}")


def reset_tail():
    """Set the non-resident engine's counts to 0: the anneal tail's
    sweeps and seconds by route and block size, and its blocks on the
    card with their split."""
    from repeatresolver_tpu_torch.models.realigner import \
        BatchedRealigner as eng
    eng.host_sweeps_by_route = {}
    eng.host_sweep_s_by_route = {}
    eng.card_tail_split = dict.fromkeys(eng.CARD_SPLIT, 0)
    eng.card_serial_split = dict.fromkeys(eng.SERIAL_SPLIT, 0)


def serial_split_line(sp):
    """The split of the serial sweeps on the card (block 1), a row."""
    n = max(1, sp["rows"])
    return (f"{sp['sweeps']} block-1 sweeps of {sp['rows']} rows on the "
            f"card, {sp['s']:.2f} s: upload {sp['upload_s']:.3f} s, "
            f"download {sp['download_s']:.3f} s, row steps "
            f"{sp['rows_s']:.2f} s ({sp['rows_s'] / n * 1e3:.3f} ms a row,"
            f" inside F and G {sp['kernel_s'] / n * 1e3:.3f}); "
            f"{sp['host_reads'] / n:.2f} host reads a row, "
            f"{sp['splices']} columns spliced, {sp['drops']} dropped, "
            f"{sp['regrows']} regrows")


def report_tail(what, card):
    """Print the anneal tail's sweeps and seconds by route and block size,
    its blocks on the card, split into host work, transfers, the device
    (of it inside kernels F and G) and flushes, and its serial sweeps on
    the card (block 1) split a row. On the card every tail block below
    RESIDENT_MIN_BS, block 1 included, runs on F and G: fail if another
    route swept there. Returns the sweeps by route."""
    from repeatresolver_tpu_torch.models.realigner import \
        BatchedRealigner as eng
    from repeatresolver_tpu_torch.models.realigner_device import \
        DeviceResidentRealigner
    n, sec = eng.host_sweeps_by_route, eng.host_sweep_s_by_route
    print(f"{what}: anneal tail by route and block size: " + "; ".join(
        f"{route} " + ", ".join(
            f"block {bs} {n[route][bs]} sweeps {sec[route][bs]:.2f} s"
            for bs in sorted(n[route], reverse=True)) for route in n))
    sp = eng.card_tail_split
    print(f"{what}: the tail's {sp['blocks']} blocks on kernels F and G, "
          f"{sp['s']:.2f} s: host work {sp['host_s']:.2f} s (gather, "
          f"compact_rows, padding, apply), transfers {sp['transfer_s']:.2f}"
          f" s, device {sp['device_s']:.2f} s (inside F and G "
          f"{sp['kernel_s']:.3f} s); flushes {sp['flush_s']:.2f} s; on "
          f"{card}")
    print(f"{what}: {serial_split_line(eng.card_serial_split)}")
    off = {route: bs for route, by in n.items() if route != "cuda"
           for bs in by if bs < DeviceResidentRealigner.RESIDENT_MIN_BS}
    if off:
        raise AssertionError(f"{what}: tail sweeps off kernels F and G: "
                             f"{off}")
    return n


@contextlib.contextmanager
def recording_tail(rec):
    """While a main path runs, record what its checks replay: the MSA the
    resident engine hands to the anneal's tail (a copy) in
    rec["handoff"], and the inputs of the tail's first block at each row
    count (clones) in rec["blocks"], {rows: (counts, rows, seqs, ways,
    lengths, anf_full, entry_bound; ncols; keywords)}. The tail reaches
    its block DP through this stand-in."""
    from repeatresolver_tpu_torch.models import realigner as prt
    from repeatresolver_tpu_torch.models import realigner_device as prd
    cls = prd.DeviceResidentRealigner
    tail_engine, block_dp = cls._tail_engine, prt.exact_block_dp
    rec.update(handoff=None, blocks={})

    def recording_engine(self, msa, block_rows):
        if rec["handoff"] is None:
            rec["handoff"] = msa.copy()
        return tail_engine(self, msa, block_rows)

    def recording_dp(*args, **kw):
        if args[1].shape[0] not in rec["blocks"]:
            rec["blocks"][args[1].shape[0]] = (
                [a.clone() for a in args[:7]], args[7], kw)
        return block_dp(*args, **kw)

    cls._tail_engine, prt.exact_block_dp = recording_engine, recording_dp
    try:
        yield rec
    finally:
        cls._tail_engine, prt.exact_block_dp = tail_engine, block_dp


def replay_tail_blocks(rec, sizes, errs, what):
    """Kernels F and G against their plain versions, bit for bit, on the
    recorded first tail block at each of `sizes` rows (the tail's block
    sizes on the card), into errs."""
    for nb in sizes:
        if nb not in rec["blocks"]:
            raise AssertionError(f"{what}: no tail block of {nb} rows "
                                 f"recorded: {sorted(rec['blocks'])}")
        args, ncols, kw = rec["blocks"][nb]
        t0 = time.perf_counter()
        err_f, err_g = compare_exact(args[:5], args[5:7], ncols,
                                     kw["bandwidth"], args[1].shape[1])
        errs["exact_fill"] = max(errs["exact_fill"], err_f)
        errs["exact_walk"] = max(errs["exact_walk"], err_g)
        print(f"{what}: the tail's first {nb}-row block ({nb} rows x "
              f"{args[2].shape[1]} bases, longest {int(args[4].max())}, "
              f"MSA width {ncols} of {args[1].shape[1]}, band "
              f"{kw['bandwidth']}): kernels F and G bit-equal to their "
              f"plain versions ({time.perf_counter() - t0:.1f} s)")


TAIL_REPS = 3


def tail_routes(rec, sizes, band, card, dev, what, serial_reps=TAIL_REPS):
    """The anneal tail from the MSA the resident engine handed to it: one
    sweep at each of `sizes` (in turn, each from the last one's result)
    on the card's tail engine (kernels F and G; block 1 the serial sweep
    over the column store on the card) and on the host native engine,
    each the median of TAIL_REPS sweeps (serial_reps at block 1) from a
    fresh engine, the card's with its last sweep's split; fails unless
    both give the same MSA and histogram. Returns {block: (card s, host
    s)}."""
    import numpy as np

    from repeatresolver_tpu_torch.models.realigner import \
        BatchedRealigner as eng
    from repeatresolver_tpu_torch.ops import _build

    def median_sweep(msa, bs, kernel):
        ts = []
        for _ in range(serial_reps if bs == 1 else TAIL_REPS):
            # a copy each: the engine writes its MSA in place
            e = eng(msa.copy(), bandwidth=band, block_rows=bs,
                    mode="exact", kernel=kernel, device=dev)
            eng.card_tail_split = dict.fromkeys(eng.CARD_SPLIT, 0)
            eng.card_serial_split = dict.fromkeys(eng.SERIAL_SPLIT, 0)
            t0 = time.perf_counter()
            e.sweep()
            ts.append(time.perf_counter() - t0)
        ts.sort()
        split = eng.card_serial_split if bs == 1 else eng.card_tail_split
        return e, ts, dict(split)

    msa = rec["handoff"]
    if msa is None:
        raise AssertionError(f"{what}: no handoff to the tail recorded")
    out = {}
    _build.kernel_events = {}
    try:
        for bs in sizes:
            card_e, card_t, sp = median_sweep(msa, bs, "cuda")
            host_e, host_t, _ = median_sweep(msa, bs, "native")
            if not (np.array_equal(card_e.msa, host_e.msa)
                    and np.array_equal(card_e.counts, host_e.counts)):
                raise AssertionError(f"{what}: block-{bs} sweep on kernels"
                                     " F and G != the host native engine")
            mid = len(card_t) // 2
            out[bs] = (card_t[mid], host_t[mid])
            if bs == 1:
                split = "the last sweep: " + serial_split_line(sp)
            else:
                n = sp["blocks"]
                split = (f"{n} blocks, the last sweep's split: host work "
                         f"{sp['host_s'] / n * 1e3:.3f} ms a block, "
                         f"transfers {sp['transfer_s'] / n * 1e3:.3f}, "
                         f"device {sp['device_s'] / n * 1e3:.3f} (inside F"
                         f" and G {sp['kernel_s'] / n * 1e3:.3f}); flushes"
                         f" {sp['flush_s']:.4f} s")
            print(f"{what}: a block-{bs} tail sweep from the same MSA "
                  f"{msa.shape}: kernels F and G {card_t[mid]:.4f} s "
                  f"({card_t[0]:.4f}-{card_t[-1]:.4f}; {split}), the host "
                  f"native engine {host_t[mid]:.4f} s ({host_t[0]:.4f}-"
                  f"{host_t[-1]:.4f}; {os.cpu_count()} threads); medians "
                  f"of {len(card_t)}; MSA and histogram equal, on {card}")
            msa = card_e.msa
    finally:
        _build.kernel_events = None
    return out


SERIAL_REPLAY_ROWS = 8


def serial_replay(rec, band, card, dev, what, nrows=SERIAL_REPLAY_ROWS):
    """The first `nrows` rows of a block-1 sweep from the tail's handoff
    MSA, on the card's serial sweep (kernels F and G over the column
    store) and on the host native engine: after each row (the sweep's
    rows= hook ends it there) the MSA and its histogram must be equal."""
    import numpy as np

    from repeatresolver_tpu_torch.models.realigner import \
        BatchedRealigner as eng

    msa = rec["handoff"]
    if msa is None:
        raise AssertionError(f"{what}: no handoff to the tail recorded")
    t0 = time.perf_counter()
    for n in range(1, nrows + 1):
        card_e, host_e = (eng(msa.copy(), bandwidth=band, block_rows=1,
                              mode="exact", kernel=kernel, device=d)
                          for kernel, d in (("cuda", dev),
                                            ("native", "cpu")))
        card_e.sweep(rows=n)
        host_e.sweep(rows=n)
        if not (np.array_equal(card_e.msa, host_e.msa)
                and np.array_equal(card_e.counts, host_e.counts)):
            raise AssertionError(f"{what}: block-1 sweep on kernels F and "
                                 f"G != the host native engine after row "
                                 f"{n - 1}")
    print(f"{what}: the first {nrows} rows of a block-1 sweep from the "
          f"handoff MSA {msa.shape}, band {band}: the card's serial sweep "
          f"and the host native engine equal after every row, MSA and "
          f"histogram ({time.perf_counter() - t0:.1f} s), on {card}")


def build_dataset(work):
    """runs/tpu_converge's dataset through the port's CLI (simulate,
    cut) and its initial aligner at align band 3000 (a setting the CLI
    does not expose)."""
    import numpy as np

    from repeatresolver_tpu_torch import cli
    from repeatresolver_tpu_torch.config import InitialAlignerConfig
    from repeatresolver_tpu_torch.models import initial_aligner
    from repeatresolver_tpu_torch.utils import io as rio

    name = "Tree_1perc_4000kb"
    template = os.path.join(work, name + "_Template.fasta")
    cli.main(["simulate", "-c", "25", "-n", "8", "-d", "1", "-l", "4000",
              "-t", "Tree", "--seed", "11", "--outdir", work])
    cli.main(["cut", template, os.path.join(work, name + ".fasta"),
              "--device", "cpu"])
    d = rio.derived_paths(template)
    ia = initial_aligner.build_initial_msa(
        rio.read_template(template).astype(np.int16),
        [s.astype(np.int16) for s in rio.read_fasta(d["seq_fasta"])],
        InitialAlignerConfig(band=3000), device="cpu")
    initial_aligner.write_outputs(ia, d["msa"], d["seqclass"])
    return d["msa"]


class TimedLines(io.TextIOBase):
    """A stdout stand-in that keeps each printed line with the host
    time at which it was completed."""

    def __init__(self):
        self.lines: list[tuple[float, str]] = []
        self._part = ""

    def write(self, s):
        self._part += s
        while "\n" in self._part:
            line, self._part = self._part.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(s)


PIPE_ARGS = ["-c", "40", "-n", "24", "-d", "1", "-l", "4000", "-t", "Tree",
             "--seed", "11"]
PIPE_NAME = "Tree_1perc_4000kb"


def pipeline_phase(card, dev, errs):
    """Phase 6; returns the kernels' launches in the pipeline run."""
    import numpy as np
    import torch

    from repeatresolver_tpu_torch import cli
    from repeatresolver_tpu_torch.config import (MaxCorrConfig,
                                                 ResolverConfig,
                                                 WindowConfig)
    from repeatresolver_tpu_torch.models import maxcorr as pmc
    from repeatresolver_tpu_torch.models import resolver as pres
    from repeatresolver_tpu_torch.models.window import window_boundaries
    from repeatresolver_tpu_torch.ops import _build
    from repeatresolver_tpu_torch.ops import cuda_maxcorr
    from repeatresolver_tpu_torch.ops import devmm
    from repeatresolver_tpu_torch.ops import editdp
    from repeatresolver_tpu_torch.ops import maxcorr_tile
    from repeatresolver_tpu_torch.utils import io as rio

    pdir = os.path.join(WORK, "pipeline")
    hdir = os.path.join(WORK, "pipeline_host")
    os.makedirs(hdir)
    counters = [(fn, "launches") for fn in launch_counters().values()] + [
        (editdp.last_rows, "calls"), (editdp.align_on_device, "calls"),
        (pmc.compute_maxcorrs_device, "calls"),
        (devmm.matmul_t, "device_calls")]
    plain = (editdp.forward_plain, editdp.walk_plain,
             maxcorr_tile.group_pass_plain)
    for fn, attr in counters + [(fn, "calls") for fn in plain]:
        setattr(fn, attr, 0)
    cuda_maxcorr.maxcorr_group.tiles = 0
    reset_exact_blocks()
    reset_tail()
    pres.resolve_window.log = []
    # every resolver product to the card: at 615 rows no product reaches
    # the JAX package's 3e9-op gate
    os.environ["RR_DEVICE_MM_MIN"] = "0"
    out = TimedLines()
    _build.kernel_events = {}
    tail_rec: dict = {}
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), recording_tail(tail_rec):
            cli.main(["pipeline"] + PIPE_ARGS + [
                "-b", "1000", "-B", "64", "-w", pdir, "--device", dev.type])
        torch.cuda.synchronize()
    finally:
        del os.environ["RR_DEVICE_MM_MIN"]
        events, _build.kernel_events = _build.kernel_events, None
    fired = {f"{fn.__module__.split('.')[-1]}.{fn.__name__}":
             getattr(fn, attr) for fn, attr in counters}
    launches = launches_now()
    plain_runs = [fn.calls for fn in plain]
    e_tiles = cuda_maxcorr.maxcorr_group.tiles
    scan = dict(pmc.compute_maxcorrs_device.last_stats)
    in_kernel = {k: sum(e0.elapsed_time(e1) for e0, e1 in v) / 1e3
                 for k, v in events.items()}
    stage_s: dict = {}
    t_prev = t0
    for t, line in out.lines:
        print(f"  {line}")
        if line.startswith("["):
            stage = line[1:].split("]")[0].split()[0]
            stage_s[stage] = stage_s.get(stage, 0.0) + t - t_prev
            t_prev = t
    ex = exact_blocks()
    print_resolve_records("pipeline-615's resolve",
                          sorted(pres.resolve_window.log,
                                 key=lambda r: r["window"]), card)
    print(f"device routes fired in the pipeline run: {fired}; "
          f"exact blocks by route {ex}")
    check_exact_routes("pipeline-615", ex)
    tail = report_tail("pipeline-615", card)
    print("stage seconds (host clock, on " + card + "): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stage_s.items())
          + f"; total {t_prev - t0:.2f}")
    print("seconds inside the kernels (CUDA events around every launch): "
          + ", ".join(f"{k} {in_kernel.get(k, 0.0):.3f} ({n} launches)"
                      for k, n in launches.items())
          + f"; plain version runs (forward_plain, walk_plain, "
          f"group_pass_plain) {plain_runs}")
    print(f"MaxCorrs device scan in the run: {scan['tile_pairs']} tile pairs"
          f" scanned, {scan['tile_pairs_needed']} needed, "
          f"{scan['host_reads']} host reads, {scan['groups_queued']} groups "
          f"of up to {scan['group']} tiles ({scan['product_launches']} "
          f"products, {e_tiles} tiles in kernel E's calls), "
          f"{scan['seconds']:.2f} s (host clock, the one-hot build and the "
          f"result's copy included)")
    if min(fired.values()) <= 0:
        raise AssertionError(f"a device route never ran: {fired}")
    if any(plain_runs):
        raise AssertionError(f"a plain version ran on the card: "
                             f"{plain_runs}")
    check_group_counts(launches["maxcorr_tile"], e_tiles, scan)
    real_path = os.path.join(pdir, PIPE_NAME + "_MSAreal")
    real = rio.read_msa(real_path)
    print(f"MSAreal {real.shape}")
    if real.shape[0] < 512:
        raise AssertionError(f"{real.shape[0]} MSA rows: below the "
                             "MaxCorrs device gate of 512")
    # kernel E on the run's own inputs: the scan's state for this
    # MSAreal; the groups from the seed tile of the largest MaxCorr's
    # diagonal and from its neighbour, and the last (partial) tile
    # against itself
    sc = pmc.MaxCorrScan(real, MaxCorrConfig(), 256, dev)
    mc_run = rio.read_maxcorrs(os.path.join(
        pdir, "MaxCorrsOf_" + PIPE_NAME + "_MSAreal"))
    k = int(np.argmax(mc_run)) // 5 // sc.t
    groups = list(dict.fromkeys([(k, k), (k, min(k + 1, sc.nt - 1)),
                                 (sc.nt - 1, sc.nt - 1)]))
    worst, relevant, lines, _ = check_groups(sc, groups)
    print("\n".join(lines))
    if relevant == 0:
        raise AssertionError(f"no relevant pair in the groups {groups}")
    errs["maxcorr_tile"] = max(errs["maxcorr_tile"], worst)
    del sc

    # cut and align: the host native route on the same reads
    for suffix in ("_Template.fasta", ".fasta"):
        shutil.copy(os.path.join(pdir, PIPE_NAME + suffix), hdir)
    tpl = os.path.join(hdir, PIPE_NAME + "_Template.fasta")
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["cut", tpl, os.path.join(hdir, PIPE_NAME + ".fasta"),
                  "--device", "cpu"])
        cli.main(["align", tpl, os.path.join(hdir, PIPE_NAME + "_Seq.fasta"),
                  "--device", "cpu"])
    for suffix in ("_Seq.fasta", "_ReadSeqInfo", "_MSA", "_SeqClass"):
        with open(os.path.join(pdir, PIPE_NAME + suffix), "rb") as f1, \
                open(os.path.join(hdir, PIPE_NAME + suffix), "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError(f"{suffix}: device route != host "
                                     "native route")
    print(f"cut + align byte-equal to the host native route (band 0; "
          f"host route {time.perf_counter() - t1:.1f} s)")

    # the anneal tail's sweeps on the card against the host native engine
    # from the MSA the resident engine handed to it
    if not tail.get("cuda"):
        raise AssertionError(f"pipeline-615: no tail sweep on kernels F and "
                             f"G: {tail}")
    tail_routes(tail_rec, sorted(tail["cuda"], reverse=True), 1000, card,
                dev, "pipeline-615", serial_reps=1)

    # MaxCorrs: the device scan again (it is deterministic: the same
    # file), against the host fast scan on the same MSAreal
    cfg = MaxCorrConfig()
    t1 = time.perf_counter()
    mc_d = pmc.compute_maxcorrs_device(real, cfg, device=dev)
    t_dev = time.perf_counter() - t1
    mc_file = os.path.join(hdir, "MaxCorrs_device")
    rio.write_maxcorrs(mc_file, mc_d)
    np.save(os.path.join(hdir, "maxcorrs_device.npy"), mc_d)  # phase 10
    with open(mc_file, "rb") as f1, open(os.path.join(
            pdir, "MaxCorrsOf_" + PIPE_NAME + "_MSAreal"), "rb") as f2:
        if f1.read() != f2.read():
            raise AssertionError("device scan not reproducible")
    t1 = time.perf_counter()
    mc_h = pmc.compute_maxcorrs(real, cfg, fast=True,
                                threads=os.cpu_count() or 1)
    t_host = time.perf_counter() - t1
    cutoff = cfg.resolved_cutoff(real.shape[1])
    sig = mc_h > cutoff
    if not np.array_equal(mc_d > cutoff, sig):
        raise AssertionError(f"MaxCorrs decisions differ at cutoff "
                             f"{cutoff}: {int(((mc_d > cutoff) != sig).sum())}")
    np.testing.assert_allclose(mc_d[sig], mc_h[sig], rtol=2e-3, atol=5e-3)
    dz = np.abs(mc_d - mc_h)
    print(f"MaxCorrs: {int(sig.sum())} significant of {len(mc_h)} at "
          f"cutoff {cutoff:.4f}, decisions identical; max|dZ| "
          f"{dz[sig].max() if sig.any() else 0.0:.3g} significant, "
          f"{dz.max():.3g} overall; device scan {t_dev:.2f} s, host fast "
          f"scan {t_host:.2f} s ({os.cpu_count()} threads) on {card}")

    # one window's subdivisions with every product on the host; the
    # window again with every product on the card, for its time
    von, bis = window_boundaries(real, WindowConfig())[:2]
    pres.resolve_window.log = []
    t1 = time.perf_counter()
    os.environ["RR_RESOLVER_DEVICE"] = "0"
    calls = devmm.matmul_t.device_calls
    try:
        res = pres.resolve_window(real, mc_d, von, bis, ResolverConfig(),
                                  dev)
    finally:
        del os.environ["RR_RESOLVER_DEVICE"]
    t_host = time.perf_counter() - t1
    if devmm.matmul_t.device_calls != calls:
        raise AssertionError("RR_RESOLVER_DEVICE=0 still used the card")
    os.environ["RR_DEVICE_MM_MIN"] = "0"
    t1 = time.perf_counter()
    try:
        pres.resolve_window(real, mc_d, von, bis, ResolverConfig(), dev)
        torch.cuda.synchronize()
    finally:
        del os.environ["RR_DEVICE_MM_MIN"]
    print(f"window {von}-{bis} resolve: {t_host:.2f} s with host "
          f"products, {time.perf_counter() - t1:.2f} s with "
          f"{devmm.matmul_t.device_calls - calls} products on {card}")
    print_resolve_records("RR_RESOLVER_DEVICE=0, then RR_DEVICE_MM_MIN=0:",
                          pres.resolve_window.log, card)
    for kind, u in res.items():
        name = rio.subdivision_path(kind, von, bis, PIPE_NAME + "_MSAreal")
        rio.write_subdivision(os.path.join(hdir, name), u)
        with open(os.path.join(pdir, name), "rb") as f1, \
                open(os.path.join(hdir, name), "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError(f"{name}: device products != host")
    print(f"window {von}-{bis}: subdivisions byte-identical between "
          "RR_DEVICE_MM_MIN=0 and RR_RESOLVER_DEVICE=0")
    for _, line in out.lines:
        if line.startswith(("[realign]", "[assess")):
            print(f"{line}  ({card})")
    return launches


PAPER_ROWS, PAPER_COLS = 13833, 131072
PAPER_BAND_TILES = 8


def synthetic_msa(rows, cols, seed=0):
    """A MaxCorrs input at the paper run's size: 100 copy groups, 1% of
    columns planted SNPs (a block of copies carries a random other
    base), 2% noise and 3% gaps; each row covers one interval of
    20,000-60,000 columns (coverage gap 5 outside)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    copies = 100
    consensus = rng.integers(0, 4, cols).astype(np.int8)
    msa = np.empty((rows, cols), np.int8)
    msa[:] = consensus
    copy = rng.integers(0, copies, rows)
    for cc in rng.choice(cols, cols // 100, replace=False):
        first, size = rng.integers(0, copies), rng.integers(1, copies // 2)
        carriers = (copy - first) % copies < size
        msa[carriers, cc] = (consensus[cc] + rng.integers(1, 4)) % 4
    flat = msa.reshape(-1)
    pos = rng.integers(0, msa.size, msa.size // 50)
    flat[pos] = rng.integers(0, 4, pos.size).astype(np.int8)
    pos = rng.integers(0, msa.size, msa.size * 3 // 100)
    flat[pos] = 4
    del pos
    lens = rng.integers(20000, 60001, rows)
    starts = rng.integers(0, cols - lens + 1)
    for r in range(rows):
        msa[r, :starts[r]] = 5
        msa[r, starts[r] + lens[r]:] = 5
    return msa


def check_groups(sc, groups):
    """Kernel E against its plain version on the groups (seed tile,
    first partner tile) of the scan `sc` (models/maxcorr.MaxCorrScan on
    the card), each of the scan's group size or up to the last tile,
    every seed of the seed tile alive, from a zero accumulator: bit for
    bit (max |dZ| 0, identical decisions and alive seeds after each
    tile), or it raises. These launches count on no path. Returns (the
    largest |dZ|, relevant pairs summed, a line a group, the plain
    version's work on each group: group_pass_plain(with_steps=True))."""
    import torch
    t = sc.t
    zero = torch.zeros_like(sc.acc)
    worst, relevant, lines, works = 0.0, 0, [], []
    for ki, kj in groups:
        m = min(sc.group, sc.nt - kj)
        alive = sc.seed_ok[ki * t:(ki + 1) * t].any(dim=1)
        dz, differ, same, work, cut = kernel_tests().compare_maxcorr_group(
            sc, ki * t, kj * t, m, alive, zero)
        if differ or not same or dz != 0:
            raise AssertionError(f"group ({ki}, {kj}, {m} tiles): kernel E"
                                 f" != its plain version: {differ} "
                                 f"decisions, alive equal {same}, max|dZ| "
                                 f"{dz}")
        worst, relevant = max(worst, dz), relevant + work[1]
        works.append(work)
        lines.append(f"group of seed tile {ki} with partner tiles "
                     f"[{kj}, {kj + m}) of {sc.nt} at {sc.r} rows: kernel "
                     f"E == plain version (max|dZ| {dz:.3g}, decisions and "
                     f"alive seeds after each tile identical; {work[0]} "
                     f"allowed pairs, {work[1]} relevant, {work[2]} tail "
                     f"steps, {cut} seeds cut inside the group)")
    return worst, relevant, lines, works


def check_group_counts(calls, tiles, st):
    """A scan on the card ran one product and one call of kernel E a
    group queued, and the tiles of those calls are the tile pairs
    scanned (calls and tiles: cuda_maxcorr.maxcorr_group's counts over
    the scan; st: its MaxCorrScan.stats), or it raises."""
    if not (calls == st["groups_queued"] == st["product_launches"] > 0) \
            or tiles != st["tile_pairs"]:
        raise AssertionError(
            f"{calls} calls of kernel E over {tiles} tiles, "
            f"{st['product_launches']} products, for {st['groups_queued']}"
            f" groups queued and {st['tile_pairs']} tile pairs scanned")


def timed_scan(sc, tiles):
    """(seconds, the scan's counters, ms inside each timed name: CUDA
    events around every launch) of one scan of `sc`
    (models/maxcorr.MaxCorrScan) over `tiles`, from a zero accumulator
    and zero counters; the result stays in sc.acc. Phase 7 and
    bench_maxcorr time their scans with it."""
    import torch

    from repeatresolver_tpu_torch.ops import _build
    sc.acc.zero_()
    sc.tile_pairs = sc.tile_pairs_needed = sc.host_reads = 0
    sc.seed_tiles = sc.groups_queued = sc.product_launches = 0
    torch.cuda.synchronize()
    _build.kernel_events = {}
    t0 = time.perf_counter()
    try:
        sc.scan(tiles)
        torch.cuda.synchronize()
    finally:
        events, _build.kernel_events = _build.kernel_events, None
    secs = time.perf_counter() - t0
    inside = {k: sum(a.elapsed_time(b) for a, b in v)
              for k, v in events.items()}
    return secs, sc.stats(), inside


def host_band_check(msa, cfg, band, t, mc_d):
    """The native host scan (all cores) of the seed tiles in `band` (of
    t columns) against mc_d, the device scan's float64 MaxCorrs over the
    same tiles: identical decisions at the MaxCorrs cutoff and, where
    significant, rtol 2e-3 and atol 5e-3; raises if they differ or if no
    value is significant. Returns the record (seconds, counts, max
    |dZ|). Phase 7 and bench_maxcorr check their bands with it."""
    import numpy as np

    from repeatresolver_tpu_torch.utils import native
    t0 = time.perf_counter()
    bits = native.MaxCorrBitsets(msa)
    bits_s = time.perf_counter() - t0
    mc_h = np.zeros(msa.shape[1] * 5, np.float64)
    t0 = time.perf_counter()
    bits.scan(mc_h, band.start * t, band.stop * t, cfg.mincov,
              cfg.min_col_gap, msa.shape[0], cfg.majority_filter, True,
              os.cpu_count() or 1)
    host_s = time.perf_counter() - t0
    cutoff = cfg.resolved_cutoff(msa.shape[1])
    sig = mc_h > cutoff
    differ = int(((mc_d > cutoff) != sig).sum())
    dz = np.abs(mc_d - mc_h)
    rec = dict(tiles=[band.start, band.stop], host_s=host_s,
               bitsets_s=bits_s, threads=os.cpu_count(),
               significant=int(sig.sum()), decisions_differ=differ,
               max_dz_significant=float(dz[sig].max()) if sig.any()
               else 0.0, max_dz=float(dz.max()))
    if differ:
        raise AssertionError(f"decisions differ from the host scan: "
                             f"{differ}")
    if not sig.any():
        raise AssertionError("no significant MaxCorrs in the band")
    np.testing.assert_allclose(mc_d[sig], mc_h[sig], rtol=2e-3, atol=5e-3)
    return rec


def paper_scan_phase(card, dev, errs):
    """Phase 7."""
    import numpy as np
    import torch

    from repeatresolver_tpu_torch.config import MaxCorrConfig
    from repeatresolver_tpu_torch.models import maxcorr as pmc
    from repeatresolver_tpu_torch.ops import cuda_maxcorr, maxcorr_tile

    msa = paper_msa()
    cfg = MaxCorrConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sc = pmc.MaxCorrScan(msa, cfg, 256, dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t = sc.t
    k0 = sc.nt // 2 - PAPER_BAND_TILES // 2
    band = range(k0, k0 + PAPER_BAND_TILES)
    # the band's first groups through kernel E and its plain version:
    # the first seed tile's first two, as its scan queues them, and the
    # next seed tile's first
    worst, relevant, lines, _ = check_groups(
        sc, [(k0, k0), (k0, k0 + sc.group), (k0 + 1, k0 + 1)])
    print("\n".join(lines))
    if relevant == 0:
        raise AssertionError("no relevant pair in the band's groups")
    errs["maxcorr_tile"] = max(errs["maxcorr_tile"], worst)
    # the band's scan, every call of E counted and timed
    e0 = cuda_maxcorr.maxcorr_group.launches
    tiles0 = cuda_maxcorr.maxcorr_group.tiles
    plain0 = maxcorr_tile.group_pass_plain.calls
    t_dev, st, in_ms = timed_scan(sc, band)
    launched = cuda_maxcorr.maxcorr_group.launches - e0
    check_group_counts(launched, cuda_maxcorr.maxcorr_group.tiles - tiles0,
                       st)
    if maxcorr_tile.group_pass_plain.calls != plain0:
        raise AssertionError(f"the plain group pass ran "
                             f"{maxcorr_tile.group_pass_plain.calls - plain0}"
                             " times on the card")
    mc_d = sc.acc[:PAPER_COLS * 5].cpu().numpy().astype(np.float64)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rec = host_band_check(msa, cfg, band, t, mc_d)
    pairs = max(st["tile_pairs"], 1)
    print(f"seed columns [{band.start * t}, {band.stop * t}) "
          f"({PAPER_BAND_TILES} tiles of {t}): "
          f"{st['tile_pairs']} tile pairs scanned, {st['tile_pairs_needed']}"
          f" needed (the break), {st['host_reads']} host reads (one a "
          f"group of up to {st['group']} pairs: {st['groups_queued']} "
          f"groups); {rec['significant']} "
          f"significant, decisions identical to the host scan, max|dZ| "
          f"{rec['max_dz_significant']:.3g} significant, "
          f"{rec['max_dz']:.3g} overall")
    print(f"device: one-hot build {t_build:.2f} s, band {t_dev:.3f} s, "
          f"{t_dev / pairs * 1e3:.4f} ms per tile pair (host clock; inside "
          f"the product {in_ms.get('maxcorr_products', 0.0) / pairs:.4f} "
          f"ms, inside kernel E {in_ms.get('maxcorr_tile', 0.0) / pairs:.4f}"
          f" ms a pair, CUDA events), {launched} calls of E, peak "
          f"{peak:.2f} GiB; host native scan {rec['host_s']:.2f} s "
          f"({rec['threads']} threads; bitsets {rec['bitsets_s']:.1f} s) "
          f"on {card}")
    del sc
    torch.cuda.empty_cache()
    return launched


# the card's rates for the bounds: memory rate and int32 lanes per SM
# and cycle from NVIDIA's H100 SXM data sheet; the SM count and the SM
# clock are read from the card
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
# int32 operations that one band cell needs, in the cheapest formulation
# known (the reduced band of csrc/staircase_fill.cu, a warp inside the
# reference band): diagonal add, its reduced form for the code test,
# insert add, min of the two, reduction add, running min, min with the
# lower lanes' prefix, gap compare, diagonal compare + select, gap
# select, funnel shift of the code word. Per-thread and per-step work
# (the warp scan, the hand-off) is left out: a bound counts only what
# every design must do.
FILL_OPS_PER_CELL = 11
# beside it, not in the bound: the plain version's count for one cell
# (ops/staircase_realign.py: band test 3, cost plane select 1, diagonal
# 1, insert candidate 3, band/valid mask 2, prefix-min 3, gap test 6,
# diagonal test 3, pack 2, band update 1)
PLAIN_FILL_OPS_PER_CELL = 25
# dependent int32 operations of one step of the walk in kernel B (mask
# shift, and, count-leading-zeros, two shifts for the insert bit, add)
WALK_CHAIN_OPS = 6


def kernel_bounds(b, l, c, w, t, widen, lengths, sm_count, sm_hz):
    """The least time the card could take for each kernel's work on this
    block, in ms: {name: (bound_ms, bound_by, detail)}. Bytes: each input
    read once and each output written once (for the walk, which reads
    only where it goes, one 32-byte sector of codes per word-row it
    walks); operations over the card's int32 rate."""
    w2 = w + widen * t
    nc = -(-l // t)
    lpad = nc * t
    nw = lpad // 16
    int_rate = sm_count * INT32_LANES_PER_SM * sm_hz
    cells = b * lpad * w2
    bytes_a = (c * 6 * 4 + b * c + b * l + b * l * 4 + b * 4
               + nw * b * w2 * 4 + b * w2 * 4 + b * 4)
    ops_a = FILL_OPS_PER_CELL * cells
    ta_ops, ta_bytes = ops_a / int_rate * 1e3, bytes_a / HBM_BYTES_PER_S * 1e3
    steps = int(sum(int(x) for x in lengths))
    rows_walked = int(sum(-(-int(x) // 16) for x in lengths))
    bytes_b = rows_walked * 32 + b * (4 + 4 + nc * 4) + nw * b * 16 * 4
    ops_b = WALK_CHAIN_OPS * steps
    tb_ops, tb_bytes = ops_b / int_rate * 1e3, bytes_b / HBM_BYTES_PER_S * 1e3
    # what no design of the walk can beat: a row's steps are a chain
    chain_ms = max(int(x) for x in lengths) * WALK_CHAIN_OPS / sm_hz * 1e3
    return {
        "staircase_fill": (
            max(ta_ops, ta_bytes),
            "operations" if ta_ops >= ta_bytes else "bytes",
            f"{cells:.4g} band cells x {FILL_OPS_PER_CELL} int32 operations"
            f" over {sm_count} SMs x {INT32_LANES_PER_SM} lanes x "
            f"{sm_hz / 1e6:.0f} MHz = {ta_ops:.3f} ms (the plain version's "
            f"{PLAIN_FILL_OPS_PER_CELL} operations a cell would be "
            f"{ta_ops * PLAIN_FILL_OPS_PER_CELL / FILL_OPS_PER_CELL:.3f} "
            f"ms); {bytes_a / 1e6:.1f} MB over 3.35 TB/s = "
            f"{ta_bytes:.3f} ms"),
        "walk_backtrack": (
            max(tb_ops, tb_bytes),
            "operations" if tb_ops >= tb_bytes else "bytes",
            f"{rows_walked} word-rows walked x 32 B + records out = "
            f"{bytes_b / 1e6:.1f} MB over 3.35 TB/s = {tb_bytes:.4f} ms; "
            f"{steps} steps x {WALK_CHAIN_OPS} operations = {tb_ops:.5f} ms;"
            f" serial-chain floor (not the bound): {max(lengths)} dependent"
            f" steps x {WALK_CHAIN_OPS} operations at one a cycle = "
            f"{chain_ms:.3f} ms"),
    }


# int32 operations of one word step of kernel C (Myers' bit-vector
# recurrence in Hyyro's block form, 32 target columns a step): the two
# carry tests (h_in -1, +1), Xv, Eq | carry, its and with Pv, the add,
# the xor-or into Xh, Ph, Mh, h_out from their top bits (three), the two
# shift-ins (two each), the two code planes and their column mask
# (four), the new Pv and Mv, the carry packed for the next lane (two),
# the last column's value: 25 operations a word step, 0.78 a cell. (The
# direct min recurrence needs 10 a cell: mismatch test,
# three adds, three mins, two compares, the code select and shift.)
EDIT_OPS_PER_WORD = 25
EDIT_OPS_PER_CELL = EDIT_OPS_PER_WORD / 32
EDIT_OPS_PER_CELL_DIRECT = 10
# dependent integer operations of one walk step besides its load (kernel
# D): word index, shift, and, the code tests, the x and y updates
EDIT_WALK_OPS = 6


def editdp_bounds(b, lq, lt, lens, walked, sm_count, sm_hz):
    """The least time the card could take for kernels C and D's work on
    one align batch (packed codes, rows below qlen), in ms, as
    kernel_bounds gives it. C: cells x EDIT_OPS_PER_CELL over the int32
    rate against its bytes (symbols in, two bits a code and the final
    rows out); D: walk steps x EDIT_WALK_OPS against its bytes (the final
    rows, one code word a step, the alignments out)."""
    int_rate = sm_count * INT32_LANES_PER_SM * sm_hz
    n = int(sum(int(x) for x in lens))
    cells = n * lt
    bytes_c = 2 * n + 2 * lt + 4 * b + cells / 4 + 4 * b * lt
    tc_ops, tc_bytes = (EDIT_OPS_PER_CELL * cells / int_rate * 1e3,
                        bytes_c / HBM_BYTES_PER_S * 1e3)
    steps = int(sum(int(x) for x in walked))
    longest = max(int(x) for x in walked)
    bytes_d = 4 * b * lt + 4 * b + 4 * steps + 4 * b * lq
    td_ops, td_bytes = (EDIT_WALK_OPS * steps / int_rate * 1e3,
                        bytes_d / HBM_BYTES_PER_S * 1e3)
    chain_ms = longest * EDIT_WALK_OPS / sm_hz * 1e3
    return {
        "editdp_fill": (
            max(tc_ops, tc_bytes),
            "operations" if tc_ops >= tc_bytes else "bytes",
            f"{cells:.4g} cells x {EDIT_OPS_PER_CELL} int32 operations "
            f"({EDIT_OPS_PER_WORD} a 32-column word step) over "
            f"{sm_count} SMs x {INT32_LANES_PER_SM} lanes x "
            f"{sm_hz / 1e6:.0f} MHz = {tc_ops:.3f} ms; {bytes_c / 1e6:.1f} MB"
            f" (two bits a code) over 3.35 TB/s = {tc_bytes:.3f} ms; the "
            f"direct formulation's {EDIT_OPS_PER_CELL_DIRECT} operations a "
            f"cell would be "
            f"{tc_ops * EDIT_OPS_PER_CELL_DIRECT / EDIT_OPS_PER_CELL:.3f} "
            f"ms"),
        "editdp_walk": (
            max(td_ops, td_bytes),
            "operations" if td_ops >= td_bytes else "bytes",
            f"{steps} walk steps x one 4-byte code word + final rows + "
            f"alignments = {bytes_d / 1e6:.1f} MB over 3.35 TB/s = "
            f"{td_bytes:.4f} ms; {steps} steps x {EDIT_WALK_OPS} operations "
            f"= {td_ops:.5f} ms; serial-chain floor (not the bound): "
            f"{longest} dependent steps (the longest walk) x "
            f"{EDIT_WALK_OPS} operations at one a cycle = {chain_ms:.3f} ms"
            f", each step also waiting for its load"),
    }


# the card's published peaks for kernel E's bound and for its products'
# (NVIDIA's H100 SXM data sheet, dense): float32 outside the tensor cores
# and int8 in them, operations a second
FP32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
# float32 operations of kernel E (csrc/maxcorr_tile.cu), counted from its
# source: every allowed (group, group) pair pays the relevance test (the
# mode's three adds, mul and div, four compares: 9); a relevant pair the
# nine TwoSum terms of log p(s) (10 each, one add after) and the epilogue
# (log, add, neg, mul, the caps' compares and the F1 rule: 10); a tail
# step 14 (sjv; two subs and a mul for num; three adds and a mul for
# den; two compares, the max, the division, the mul, the add, the stop
# compare). The int32 sums that derive the counts from the product (24
# adds a 5 x 5 block) are left out: a bound counts float32 work only.
MAXCORR_PAIR_OPS = 9
MAXCORR_RELEVANT_OPS = 101
MAXCORR_STEP_OPS = 14


def maxcorr_bounds(t, m, rows_p, nmax, work):
    """The least time the card could take for one group (a seed tile of
    t columns against m partner tiles) over rows_p MSA rows (the seed
    tile's row window), in ms, as kernel_bounds gives it: (kernel E's,
    its product's), each (ms, by, detail). E: the float32 operations
    these inputs need (work: group_pass_plain's with_steps counts) over
    FP32_OPS_PER_S, against its bytes (the group's int32 product, the
    gates, sizes and the table in, the alive seeds in and out, the
    accumulator's two slices read and written). The product: 2 x rows_p
    x 5t x 5mt int8 operations over INT8_OPS_PER_S, against its int8
    operands in and its int32 result out."""
    pairs, relevant, steps = work
    t5, w5 = 5 * t, 5 * m * t
    ops = (pairs * MAXCORR_PAIR_OPS + relevant * MAXCORR_RELEVANT_OPS
           + steps * MAXCORR_STEP_OPS)
    e_bytes = (4 * t5 * w5 + t + m * t + t5 + w5 + 4 * (t5 + w5)
               + 8 * (nmax + 1) + 2 * 4 * (t5 + w5))
    e_ops_ms = ops / FP32_OPS_PER_S * 1e3
    e_bytes_ms = e_bytes / HBM_BYTES_PER_S * 1e3
    p_ops = 2 * rows_p * t5 * w5
    p_bytes = (t5 + w5) * rows_p + 4 * t5 * w5
    p_ops_ms = p_ops / INT8_OPS_PER_S * 1e3
    p_bytes_ms = p_bytes / HBM_BYTES_PER_S * 1e3
    return (
        (max(e_ops_ms, e_bytes_ms),
         "operations" if e_ops_ms >= e_bytes_ms else "bytes",
         f"{pairs} allowed pairs x {MAXCORR_PAIR_OPS} + {relevant} "
         f"relevant x {MAXCORR_RELEVANT_OPS} + {steps} tail steps x "
         f"{MAXCORR_STEP_OPS} = {ops:.4g} float32 operations over 67 "
         f"TFLOP/s = {e_ops_ms:.4f} ms; {e_bytes / 1e6:.2f} MB (the "
         f"product [{t5} x {w5}] int32 read once) over 3.35 TB/s = "
         f"{e_bytes_ms:.4f} ms"),
        (max(p_ops_ms, p_bytes_ms),
         "operations" if p_ops_ms >= p_bytes_ms else "bytes",
         f"{p_ops:.4g} int8 operations ([{t5} x {rows_p}] x [{rows_p} x "
         f"{w5}]) over 1,979 TOP/s = {p_ops_ms:.4f} ms; "
         f"{p_bytes / 1e6:.2f} MB over 3.35 TB/s = {p_bytes_ms:.4f} ms"))


_PAPER_MSA: list = []


def paper_msa():
    """Phase 7's synthetic MSA (made once, kept for phases 3 and 7)."""
    if not _PAPER_MSA:
        t0 = time.perf_counter()
        _PAPER_MSA.append(synthetic_msa(PAPER_ROWS, PAPER_COLS))
        print(f"synthetic MSA {_PAPER_MSA[0].shape} in "
              f"{time.perf_counter() - t0:.1f} s")
    return _PAPER_MSA[0]


def maxcorr_group_timed(card, dev):
    """Phase 3's kernel E: one group at paper width (the band's first
    seed tile against the scan's group size of partner tiles from its
    diagonal, every seed alive) through E and its plain version, bit for
    bit, then E and the group's product timed (runs queued back to back:
    queued_ms). Returns (max |dZ|, E ms, plain ms, E's bound)."""
    import torch

    from repeatresolver_tpu_torch.config import MaxCorrConfig
    from repeatresolver_tpu_torch.models import maxcorr as pmc
    from repeatresolver_tpu_torch.ops import cuda_maxcorr, maxcorr_tile

    sc = pmc.MaxCorrScan(paper_msa(), MaxCorrConfig(), 256, dev)
    t, m = sc.t, sc.group
    k0 = sc.nt // 2 - PAPER_BAND_TILES // 2
    dz, relevant, lines, (work,) = check_groups(sc, [(k0, k0)])
    if relevant == 0:
        raise AssertionError("no relevant pair in phase 3's group")
    i0 = j0 = k0 * t
    schnitt = sc.product(i0, j0, m)
    alive = sc.seed_ok[i0:i0 + t].any(dim=1)
    out = torch.empty((m, t), dtype=torch.bool, device=dev)
    args = (schnitt, alive, out, sc.seed_ok, sc.partner_ok, sc.sizes, sc.lf,
            torch.zeros_like(sc.acc), i0, j0)
    kw = dict(gap=sc.gap, ncols=sc.c, mincov=sc.mincov)
    reps = 4 * KERNEL_REPS
    ms = queued_ms(lambda: cuda_maxcorr.maxcorr_group(*args, **kw), reps)
    _, pms = time_launches(
        lambda: maxcorr_tile.group_pass_plain(*args, **kw), 1)
    prod_ms = queued_ms(lambda: sc.product(i0, j0, m), reps)
    lo, hi = sc.windows[k0]
    (bms, by, detail), (pbms, pby, pdetail) = maxcorr_bounds(
        t, m, hi - lo, sc.r, work)
    print(lines[0])
    print(f"maxcorr_tile (kernel E, one call: two launches) at {PAPER_ROWS} "
          f"rows, tile {t}, seed columns [{i0}, {i0 + t}) x partner "
          f"columns [{j0}, {j0 + m * t}) ({m} tiles): {ms:.4f} ms a group, "
          f"{ms / m:.4f} ms a tile pair ({reps} queued back to back under "
          f"one pair of events), plain {pms:.3f} ms on {card}")
    print(f"  bound {bms:.4f} ms by {by} ({bms / ms:.1%} of the kernel's "
          f"time): {detail}; library call: none (no single PyTorch call "
          "computes this function)")
    print(f"  the group's one int8 product before it (torch._int_mm over "
          f"the seed tile's row window [{lo}, {hi}) of "
          f"{sc.groups.shape[1]} rows): {prod_ms:.4f} ms a group, "
          f"{prod_ms / m:.4f} ms a tile pair ({reps} queued); its bound "
          f"{pbms:.4f} ms by {pby} ({pbms / prod_ms:.1%}): {pdetail}")
    del sc, schnitt, args
    torch.cuda.empty_cache()
    return dz, ms, pms, (bms, by, detail)


PAPER_SIM = ["-c", "12", "-n", "8", "-d", "1", "-l", "30000", "-t", "Tree",
             "--seed", "11"]
PAPER_NAME = "Tree_1perc_30000kb"
PAPER_ROUNDS = 8
PAPER_MIN_ROWS = 192                    # three blocks of 64


def paper_realign_phase(card, dev, errs):
    """Phase 8; returns the kernels' launches in the capped run, the
    MSA's path, the score lines and the first block's recorded fill
    inputs (for phases 9 and 10)."""
    import numpy as np
    import torch

    from repeatresolver_tpu_torch import cli
    from repeatresolver_tpu_torch.config import (InitialAlignerConfig,
                                                 RealignerConfig)
    from repeatresolver_tpu_torch.models import initial_aligner
    from repeatresolver_tpu_torch.models import realigner as prt
    from repeatresolver_tpu_torch.models import realigner_device as prd
    from repeatresolver_tpu_torch.ops import _build
    from repeatresolver_tpu_torch.ops import cuda_realign as cr
    from repeatresolver_tpu_torch.utils import io as rio

    work = os.path.join(WORK, "paper_width")
    os.makedirs(work)
    t0 = time.perf_counter()
    template = os.path.join(work, PAPER_NAME + "_Template.fasta")
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["simulate"] + PAPER_SIM + ["--outdir", work])
        cli.main(["cut", template, os.path.join(work, PAPER_NAME + ".fasta"),
                  "--device", "cpu"])
    d = rio.derived_paths(template)
    ia = initial_aligner.build_initial_msa(
        rio.read_template(template).astype(np.int16),
        [s.astype(np.int16) for s in rio.read_fasta(d["seq_fasta"])],
        InitialAlignerConfig(band=3000), device="cpu")
    initial_aligner.write_outputs(ia, d["msa"], d["seqclass"])
    msa = rio.read_msa(d["msa"])
    bases = int((msa < 4).sum())
    print(f"host stages (simulate, cut, align): "
          f"{time.perf_counter() - t0:.1f} s, MSA {msa.shape[0]} rows x "
          f"{msa.shape[1]} columns, {bases} bases, longest row "
          f"{int((msa < 4).sum(axis=1).max())}")
    if msa.shape[0] < PAPER_MIN_ROWS:
        raise AssertionError(f"{msa.shape[0]} rows: fewer than "
                             f"{PAPER_MIN_ROWS} (three blocks of 64)")

    cfg = RealignerConfig(bandwidth=1000, block_rows=64,
                          max_rounds=PAPER_ROUNDS)
    os.environ["RR_FLUSH_CAP"] = str(1 << 30)
    try:
        reset_launches()
        reset_tail()
        reset_exact_blocks()
        prd.DeviceResidentRealigner.resident_sweep_s = 0.0
        first = {}

        def recording_fill(*args, **kw):
            if not first:
                first["block"] = ([a.clone() for a in args[:5]], args[5], kw)
            return cr.staircase_fill(*args, **kw)

        prd.cr = types.SimpleNamespace(
            **{**vars(cr), "staircase_fill": recording_fill})
        _build.kernel_events = {}
        log_d: list = []
        t0 = time.perf_counter()
        try:
            prt.realign_batched(msa, cfg, score_log=log_d, device=dev)
            torch.cuda.synchronize()
        finally:
            prd.cr = cr
            events, _build.kernel_events = _build.kernel_events, None
        wall = time.perf_counter() - t0
        launches = launches_now()
        in_kernel = {k: sum(e0.elapsed_time(e1) for e0, e1 in v) / 1e3
                     for k, v in events.items()}
        res_s = prd.DeviceResidentRealigner.resident_sweep_s
        if prt.BatchedRealigner.sweep_totals()[0]:
            raise AssertionError(
                f"{prt.BatchedRealigner.sweep_totals()[0]} rounds left the "
                "resident engine: the cap must hold the run at block 64")
        if min(launches[k] for k in REALIGN_KERNELS) <= 0:
            raise AssertionError(f"a kernel never launched: {launches}")
        sa = in_kernel.get("staircase_fill", 0.0)
        sb = in_kernel.get("walk_backtrack", 0.0)
        sfg = in_kernel.get("exact_fill", 0.0) \
            + in_kernel.get("exact_walk", 0.0)
        ex = exact_blocks()
        print(f"realign_batched on {card}: {PAPER_ROUNDS} rounds at block "
              f"64, wall {wall:.2f} s, "
              f"{PAPER_ROUNDS * bases * 1000 / wall:.4g} cells/s; launches "
              f"{launches}, exact blocks by route {ex}")
        check_exact_routes("realign at paper width", ex)
        print(f"resident sweeps {res_s:.3f} s: inside kernel A {sa:.3f} s "
              f"({sa / launches['staircase_fill'] * 1e3:.3f} ms a launch), "
              f"inside kernel B {sb:.3f} s "
              f"({sb / launches['walk_backtrack'] * 1e3:.3f} ms a launch), "
              f"inside kernels F and G {sfg:.3f} s, "
              f"rest (torch ops, per-block host read) "
              f"{res_s - sa - sb - sfg:.3f} s")
        for i, rec in enumerate(prd.DeviceResidentRealigner.sweep_log):
            print(f"  sweep {i + 1}: {rec['s']:.3f} s, exact blocks "
                  f"{rec['exact_blocks']} in {rec['exact_block_s']} s")

        # the same capped run through the host native engine
        t0 = time.perf_counter()
        eng = prt.BatchedRealigner(msa, bandwidth=1000, block_rows=64)
        eng.ent_al_gapper()
        log_h = [eng.overall_pair()]
        for _ in range(PAPER_ROUNDS):
            eng.sweep()
            log_h.append(eng.overall_pair())
        print(f"host native engine, same run: "
              f"{time.perf_counter() - t0:.1f} s")
    finally:
        del os.environ["RR_FLUSH_CAP"]
    lines_d = [f"OverallScore: {m}{u:06d}" for m, u in
               log_d[:PAPER_ROUNDS + 1]]
    lines_h = [f"OverallScore: {m}{u:06d}" for m, u in log_h]
    for ln in lines_d:
        print(f"  {ln}")
    if lines_d != lines_h:
        raise AssertionError(f"trajectory on the card {lines_d} != host "
                             f"native engine {lines_h}")
    # the anneal shrinks the block after a round that did not improve,
    # so every round but the last must have improved
    if any(b >= a for a, b in zip(log_d, log_d[1:PAPER_ROUNDS])):
        raise AssertionError("a round before the last did not improve: "
                             "the anneal would have left block 64")
    print(f"{len(lines_d)} OverallScore lines equal to the host native "
          "engine's, line for line")

    args, ncols, kw = first["block"]
    (ea, eb), _ = compare_block(args, ncols, kw["bandwidth"], kw["chunk"],
                                kw["widen"], args[1].shape[1])
    errs["staircase_fill"] = max(errs["staircase_fill"], ea)
    errs["walk_backtrack"] = max(errs["walk_backtrack"], eb)
    b, lpad = args[2].shape
    print(f"first block bit-equal to the plain versions: {b} rows x {lpad} "
          f"bases, MSA width {ncols} of {args[1].shape[1]}, band "
          f"{kw['bandwidth']}, chunk {kw['chunk']}, widen {kw['widen']} "
          f"(W2 {kw['bandwidth'] + kw['widen'] * kw['chunk']})")
    return launches, d["msa"], lines_d, first["block"]


SAMPLE_EVERY = 10     # phase 12's host check: every 10th piece by length


def paper_cut_align_phase(card, dev, errs):
    """Phase 12; returns the kernels' launches in the device cut and
    align. Starts no process."""
    import numpy as np
    import torch

    from repeatresolver_tpu_torch import cli
    from repeatresolver_tpu_torch.config import ReadCutterConfig
    from repeatresolver_tpu_torch.models import initial_aligner
    from repeatresolver_tpu_torch.models import read_cutter
    from repeatresolver_tpu_torch.ops import _build
    from repeatresolver_tpu_torch.ops import editdp
    from repeatresolver_tpu_torch.utils import io as rio

    src = os.path.join(WORK, "paper_width")      # phase 8's files
    work = os.path.join(WORK, "paper_cut_align")
    os.makedirs(work)
    for suffix in ("_Template.fasta", ".fasta"):
        shutil.copy(os.path.join(src, PAPER_NAME + suffix), work)
    template = os.path.join(work, PAPER_NAME + "_Template.fasta")
    d = rio.derived_paths(template)
    reset_launches()
    plain = (editdp.forward_plain, editdp.walk_plain)
    for fn in plain + (editdp.last_rows, editdp.align_on_device):
        fn.calls = 0
    kept = {}
    write_outputs = initial_aligner.write_outputs

    def keeping_write(res, *paths):      # the CLI's aligner result
        kept["res"] = res
        return write_outputs(res, *paths)

    # the inputs of the first cut call, and of the first align call and
    # the one with the most DP rows, for the kernels' check below (no
    # caller writes into them); cut and align reach the edit DP through
    # these stand-ins for the module
    def keeping_last_rows(*args):
        kept.setdefault("cut", args)
        return editdp.last_rows(*args)

    def keeping_align(*args):
        kept.setdefault("align_first", args)
        if "align_longest" not in kept \
                or args[0].shape[1] > kept["align_longest"][0].shape[1]:
            kept["align_longest"] = args
        return editdp.align_on_device(*args)

    initial_aligner.write_outputs = keeping_write
    read_cutter.editdp = types.SimpleNamespace(
        **{**vars(editdp), "last_rows": keeping_last_rows})
    initial_aligner.editdp = types.SimpleNamespace(
        **{**vars(editdp), "align_on_device": keeping_align})
    _build.kernel_events = {}
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            cli.main(["cut", template,
                      os.path.join(work, PAPER_NAME + ".fasta"),
                      "--device", "cuda"])
            torch.cuda.synchronize()
            s_cut = time.perf_counter() - t0
            n_cut = launches_now()["editdp_fill"]
            t0 = time.perf_counter()
            cli.main(["align", template, d["seq_fasta"], "--device", "cuda"])
            torch.cuda.synchronize()
            s_align = time.perf_counter() - t0
    finally:
        initial_aligner.write_outputs = write_outputs
        read_cutter.editdp = initial_aligner.editdp = editdp
        events, _build.kernel_events = _build.kernel_events, None
    launches = launches_now()
    plain_runs = [fn.calls for fn in plain]
    ms = {k: [e0.elapsed_time(e1) for e0, e1 in v] for k, v in events.items()}
    c_cut = sum(ms["editdp_fill"][:n_cut]) / 1e3
    c_align = sum(ms["editdp_fill"][n_cut:]) / 1e3
    d_align = sum(ms["editdp_walk"]) / 1e3
    for suffix in ("_Seq.fasta", "_ReadSeqInfo"):
        with open(os.path.join(work, PAPER_NAME + suffix), "rb") as f1, \
                open(os.path.join(src, PAPER_NAME + suffix), "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError(f"{suffix}: cut on the card != cli cut "
                                     "--device cpu (phase 8)")
    tpl = rio.read_template(template).astype(np.int16)
    reads = rio.read_fasta(os.path.join(work, PAPER_NAME + ".fasta"))
    pieces = [p.astype(np.int16) for p in rio.read_fasta(d["seq_fasta"])]
    cfg = ReadCutterConfig()
    plen = len(tpl) // cfg.parts + cfg.overlap
    cells_cut = editdp.last_rows.calls * 64 * plen * max(len(r) for r in
                                                         reads)
    cells_align = sum(len(p) for p in pieces) * len(tpl)
    print(f"{len(reads)} reads of up to {max(len(r) for r in reads)} bases,"
          f" template {len(tpl)}: cut into {len(pieces)} pieces of "
          f"{min(len(p) for p in pieces)}-{max(len(p) for p in pieces)} "
          f"bases; _Seq.fasta and _ReadSeqInfo byte-equal to cli cut "
          f"--device cpu")
    print(f"cut on {card}: {s_cut:.2f} s, {editdp.last_rows.calls} "
          f"last_rows calls, {n_cut} launches of kernel C, {c_cut:.3f} s "
          f"inside it, {cells_cut:.4g} cells ({cells_cut / c_cut:.4g} "
          f"cells/s inside the kernel)")
    print(f"align on {card}: {s_align:.2f} s, "
          f"{editdp.align_on_device.calls} align_on_device calls, "
          f"{launches['editdp_fill'] - n_cut} launches of kernel C "
          f"({c_align:.3f} s inside) and {launches['editdp_walk']} of kernel"
          f" D ({d_align:.3f} s inside), {cells_align:.4g} cells "
          f"({cells_align / c_align:.4g} cells/s inside C, "
          f"{cells_align / s_align:.4g} for the stage)")
    print(f"launches {launches}; plain edit-DP loop runs (forward_plain, "
          f"walk_plain) {plain_runs}")
    if plain_runs != [0, 0]:
        raise AssertionError("the plain edit-DP loop ran on the card")
    if min(launches["editdp_fill"] - n_cut, n_cut,
           launches["editdp_walk"]) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")

    # kernels C and D against their plain versions at this phase's own
    # shapes
    replay_editdp(kept, errs, "cut and align at paper width")

    # a sample against the host native full DP (band 0)
    res = kept["res"]
    order = np.argsort([len(p) for p in pieces], kind="stable")
    sample = order[::SAMPLE_EVERY]
    t0 = time.perf_counter()
    al_h, err_h = initial_aligner.align_all(
        tpl, [pieces[i] for i in sample], band=0, device="cpu")
    s_host = time.perf_counter() - t0
    for k, i in enumerate(sample):
        if not np.array_equal(res.alignments[i], al_h[k]):
            raise AssertionError(f"piece {i} ({len(pieces[i])} bases): "
                                 "alignment != host native full DP")
    np.testing.assert_array_equal(res.errors[sample], err_h)
    cells_h = sum(len(pieces[i]) for i in sample) * len(tpl)
    print(f"{len(sample)} pieces (every {SAMPLE_EVERY}th by length): "
          f"alignments and errors equal to the host native full DP "
          f"(tolerance 0), which took {s_host:.2f} s for {cells_h:.4g} "
          f"cells on {os.cpu_count()} threads")
    return launches


def _same_block_result(what, got, ref, ncols):
    """(rows, best, iy, ib, inn) of one block equal between two routes
    (numpy): rows over the real columns, insert slots up to inn a row."""
    import numpy as np
    rows_g, best_g, iy_g, ib_g, inn_g = got
    rows_r, best_r, iy_r, ib_r, inn_r = ref
    ok = (np.array_equal(rows_g[:, :ncols], rows_r[:, :ncols])
          and np.array_equal(best_g, best_r)
          and np.array_equal(inn_g, inn_r)
          and all(np.array_equal(iy_g[i, :n], iy_r[i, :n])
                  and np.array_equal(ib_g[i, :n], ib_r[i, :n])
                  for i, n in enumerate(inn_r)))
    if not ok:
        raise AssertionError(f"{what}: block results differ")


MESH_ROUNDS = 3
RANK_TIMEOUT_S = 420.0
# phase 9's band past the clustered layout's MAX_W lanes
WIDE_BAND = 20000


def compare_exact(args, starts, ncols, w, cpad, wide=None):
    """Kernels F and G against their plain versions on one block of GPU
    tensors (counts, rows, seqs, ways, lengths; starts: anf_full,
    entry_bound): F's codes, band and band start (in the layout `wide`
    asks for; by default the band's) against the torch exact band's,
    packed; G's moves, entry and best against exact_walk_plain on F's
    codes. Returns (max abs difference of F, of G)."""
    from repeatresolver_tpu_torch.ops import cuda_exact as cx
    anf, eb = starts
    kern = cx.exact_fill(*args, ncols, bandwidth=w, wide=wide)
    plain = cx.exact_fill_plain(*args, ncols, bandwidth=w)
    err_f = max(int((k.long() - p.long()).abs().max())
                for k, p in zip(kern, plain))
    walk = cx.exact_walk(*kern, eb, anf, args[4], ncols, cpad=cpad)
    walk_p = cx.exact_walk_plain(*kern, eb, anf, args[4], ncols, cpad=cpad)
    err_g = max(int((k.long() - p.long()).abs().max())
                for k, p in zip(walk, walk_p))
    if err_f or err_g:
        raise AssertionError(f"kernels F, G != plain versions: max abs err "
                             f"{err_f}, {err_g}")
    return err_f, err_g


# int32 operations of the entry scan a column (the band read's select,
# the compare with the running best, the tie's select); kernel G's walk
# is counted as kernel B's (WALK_CHAIN_OPS a step)
ENTRY_OPS_PER_COLUMN = 3


def exact_kernel_bounds(b, l, c, cpad, w, lengths, sm_count, sm_hz):
    """The least time the card could take for kernels F's and G's work
    on this block, in ms: {name: (bound_ms, bound_by, detail)}, as
    kernel_bounds counts A's and B's: F's band cells (every position of
    the block, as F emits codes for each) x FILL_OPS_PER_CELL int32
    operations, its bytes each input read once and each output written
    once; G's bytes the final band and one 32-byte sector of codes a
    word-row walked, the band starts of the walked positions and the
    records out, its operations the entry scan's and the walk's."""
    nw = -(-l // 16)
    int_rate = sm_count * INT32_LANES_PER_SM * sm_hz
    cells = b * l * w
    bytes_f = (c * 6 * 4 + b * c + b * l + b * l * 4 + b * 4
               + nw * b * w * 4 + b * w * 4 + b * 4)
    tf_ops = FILL_OPS_PER_CELL * cells / int_rate * 1e3
    tf_bytes = bytes_f / HBM_BYTES_PER_S * 1e3
    steps = int(sum(int(x) for x in lengths))
    rows_walked = int(sum(-(-int(x) // 16) for x in lengths))
    bytes_g = (b * w * 4 + rows_walked * 32 + steps * 4 + b * 12
               + nw * b * 16 * 4 + b * 8)
    ops_g = ENTRY_OPS_PER_COLUMN * b * cpad + WALK_CHAIN_OPS * steps
    tg_ops, tg_bytes = ops_g / int_rate * 1e3, bytes_g / HBM_BYTES_PER_S * 1e3
    chain_ms = max(int(x) for x in lengths) * WALK_CHAIN_OPS / sm_hz * 1e3
    return {
        "exact_fill": (
            max(tf_ops, tf_bytes),
            "operations" if tf_ops >= tf_bytes else "bytes",
            f"{cells:.4g} band cells x {FILL_OPS_PER_CELL} int32 operations"
            f" over {sm_count} SMs x {INT32_LANES_PER_SM} lanes x "
            f"{sm_hz / 1e6:.0f} MHz = {tf_ops:.3f} ms; {bytes_f / 1e6:.1f} MB"
            f" over 3.35 TB/s = {tf_bytes:.3f} ms"),
        "exact_walk": (
            max(tg_ops, tg_bytes),
            "operations" if tg_ops >= tg_bytes else "bytes",
            f"final band, {rows_walked} word-rows walked x 32 B, band "
            f"starts and records = {bytes_g / 1e6:.2f} MB over 3.35 TB/s = "
            f"{tg_bytes:.4f} ms; {b} x {cpad} columns scanned x "
            f"{ENTRY_OPS_PER_COLUMN} + {steps} steps x {WALK_CHAIN_OPS} "
            f"operations = {tg_ops:.5f} ms; serial-chain floor (not the "
            f"bound): {max(lengths)} dependent steps x {WALK_CHAIN_OPS} "
            f"operations at one a cycle = {chain_ms:.3f} ms"),
    }


def exact_band_phase(card, dev, block, converge_msa_path, sm_count, sm_hz,
                     errs):
    """Phase 9; returns the kernels' launches in the forced-exact
    resident run, F's and G's times (ms, plain ms) and their bounds."""
    import numpy as np
    import torch

    from repeatresolver_tpu_torch.models import realigner as prt
    from repeatresolver_tpu_torch.models import realigner_device as prd
    from repeatresolver_tpu_torch.ops import banded_realign as br
    from repeatresolver_tpu_torch.ops import cuda_exact as cx
    from repeatresolver_tpu_torch.utils import io as rio
    from repeatresolver_tpu_torch.utils import native

    args, ncols, kw = block
    counts, rows_old, seqs, ways, lengths = args
    w, t, widen = kw["bandwidth"], kw["chunk"], kw["widen"]
    cpad = rows_old.shape[1]
    ways_h, len_h = ways.cpu().numpy(), lengths.cpu().numpy()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def starts(stair):
        return [torch.from_numpy(a).to(dev) for a in prt.band_starts(
            ways_h, len_h, w, t, stair)]

    def host_median(nb, band=w, reps=KERNEL_REPS):
        """The host native engine on the block's first nb rows at `band`,
        inputs copied to the host first: (outputs, the median seconds of
        `reps` runs, the fastest, the slowest)."""
        h = (counts[:ncols].cpu().numpy(),
             np.ascontiguousarray(rows_old[:nb, :ncols].cpu().numpy()),
             seqs[:nb].cpu().numpy(), ways_h[:nb], len_h[:nb])
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = prt.realign_block_native(native, *h, band)
            ts.append(time.perf_counter() - t0)
        ts.sort()
        return out, ts[len(ts) // 2], ts[0], ts[-1]

    common = dict(bandwidth=w, chunk=t, widen=widen)
    stair_starts = starts(True)
    anf, eb = starts(False)

    def through(stair):
        return prt.block_dp(*args, *(stair_starts if stair else (anf, eb)),
                            ncols, staircase=stair, kernel="cuda", **common)

    through(True)                        # warm-ups
    through(False)
    out_k, s_k = timed(lambda: through(True))
    out_fg, s_fg = timed(lambda: through(False))
    # F and G alone, the median of KERNEL_REPS runs each
    (codes, band, fanf), ms_f = time_launches(
        lambda: cx.exact_fill(*args, ncols, bandwidth=w), KERNEL_REPS,
        "exact_fill")
    (moves, wayin, best), ms_g = time_launches(
        lambda: cx.exact_walk(codes, band, fanf, eb, anf, lengths, ncols,
                              cpad=cpad), KERNEL_REPS, "exact_walk")
    # the plain versions: F's, the torch loop with its codes packed; G's,
    # the entry scan and the walk in torch ops over F's codes
    torch.cuda.reset_peak_memory_stats()
    fill, s_fill = timed(lambda: br.banded_fill(*args, ncols, bandwidth=w))
    packed, s_pack = timed(lambda: cx.pack_codes(fill[0]))
    err_f = max(int((k.long() - p.long()).abs().max()) for k, p in
                zip((codes, band, fanf), (packed, fill[1], fill[2])))
    out_t, s_bt = timed(lambda: br.entry_and_backtrack(
        *fill, seqs, anf, eb, lengths, ncols, cpad=cpad, bandwidth=w))
    peak = torch.cuda.max_memory_allocated() / 2**30
    del fill, packed
    walk_p, s_walk = timed(lambda: cx.exact_walk_plain(
        codes, band, fanf, eb, anf, lengths, ncols, cpad=cpad))
    err_g = max(int((k.long() - p.long()).abs().max()) for k, p in
                zip((moves, wayin, best), walk_p))
    errs["exact_fill"] = max(errs["exact_fill"], err_f)
    errs["exact_walk"] = max(errs["exact_walk"], err_g)
    if err_f or err_g:
        raise AssertionError(f"paper-width block: kernels F, G != plain "
                             f"versions, max abs err {err_f}, {err_g}")
    out_n, s_n, n_lo, n_hi = host_median(rows_old.shape[0])
    out_fg = [x.cpu().numpy() for x in out_fg]
    for what, ref in (("kernels A + B", out_k), ("the torch loop", out_t),
                      ("the host native engine", out_n)):
        ref = [x.cpu().numpy() if torch.is_tensor(x) else x for x in ref]
        _same_block_result(f"kernels F + G vs {what}", out_fg, ref, ncols)
    b, lpad = seqs.shape
    print(f"block of {b} rows x {lpad} bases (longest {int(len_h.max())}), "
          f"band {w}, MSA width {ncols} of {cpad}: rows, best and "
          f"{int(out_fg[4].sum())} inserts (most a row "
          f"{int(out_fg[4].max())}) bit-equal between kernels F + G, the "
          f"torch loop, kernels A + B and the host native engine; F and G "
          f"bit-equal to their plain versions (codes, band, band start; "
          f"moves, entry, best)")
    print(f"seconds for the block on {card}: kernels F + G with their "
          f"torch ops {s_fg:.4f} (F {ms_f:.3f} ms, {spread('exact_fill')};"
          f" G {ms_g:.3f} ms, {spread('exact_walk')}), the torch loop "
          f"{s_fill + s_bt:.2f} (banded_fill {s_fill:.2f}, "
          f"entry_and_backtrack {s_bt:.2f}; peak {peak:.2f} GiB), G's plain"
          f" walk {s_walk:.2f}, kernels A + B with their torch ops "
          f"{s_k:.4f}, host native engine {s_n:.4f} (median of "
          f"{KERNEL_REPS} runs, {n_lo:.4f}-{n_hi:.4f}; {os.cpu_count()} "
          f"threads)")
    times = {"exact_fill": (ms_f, (s_fill + s_pack) * 1e3),
             "exact_walk": (ms_g, s_walk * 1e3)}
    bounds = exact_kernel_bounds(b, lpad, rows_old.shape[1], cpad, w, len_h,
                                 sm_count, sm_hz)
    for name in times:
        bms, by, detail = bounds[name]
        print(f"{name}: bound {bms:.4f} ms by {by} ({bms / times[name][0]:.1%}"
              f" of the kernel's time): {detail}; library call: none (no "
              "single PyTorch call computes this function)")

    # F + G on 16-row and 4-row blocks cut from this block (the anneal
    # tail's block sizes), against the host native engine on the same rows
    for nb in (16, 4):
        sargs = (counts, *(a[:nb].contiguous() for a in args[1:]))
        sanf, seb = anf[:nb].contiguous(), eb[:nb].contiguous()
        out_s, ms_fg = time_launches(
            lambda: prt.block_dp(*sargs, sanf, seb, ncols, staircase=False,
                                 kernel="cuda", **common),
            KERNEL_REPS, f"exact_{nb}_rows")
        (c_s, b_s, f_s), ms_sf = time_launches(
            lambda: cx.exact_fill(*sargs, ncols, bandwidth=w), KERNEL_REPS,
            f"exact_fill_{nb}_rows")
        _, ms_sg = time_launches(
            lambda: cx.exact_walk(c_s, b_s, f_s, seb, sanf, sargs[4], ncols,
                                  cpad=cpad), KERNEL_REPS,
            f"exact_walk_{nb}_rows")
        out_sn, s_sn, sn_lo, sn_hi = host_median(nb)
        _same_block_result(f"{nb}-row block: kernels F + G vs the host "
                           "native engine",
                           [x.cpu().numpy() for x in out_s], out_sn, ncols)
        print(f"{nb}-row block cut from it (longest {int(len_h[:nb].max())})"
              f": kernels F + G with their torch ops {ms_fg:.3f} ms "
              f"({spread(f'exact_{nb}_rows')}; F {ms_sf:.3f} ms, G "
              f"{ms_sg:.3f} ms), the host native engine {s_sn * 1e3:.3f} ms"
              f" (median of {KERNEL_REPS} runs, {sn_lo * 1e3:.3f}-"
              f"{sn_hi * 1e3:.3f} ms; {os.cpu_count()} threads); rows, "
              "best and inserts equal")

    # F at each layout a cluster takes at this band, through its wrapper:
    # every one equal to the wrapper's own layout's result
    geo = cx.fill_geometry(w)
    for cs in cx.FILL_CLUSTERS:
        out_c, ms_c = time_launches(
            lambda: cx.exact_fill(*args, ncols, bandwidth=w, ctas=cs),
            KERNEL_REPS, f"exact_fill_{cs}_ctas")
        if not all(torch.equal(a, b) for a, b in zip(out_c,
                                                     (codes, band, fanf))):
            raise AssertionError(f"kernel F at {cs} CTAs a row differs from"
                                 f" its layout of {geo.cs}")
        print(f"exact_fill at {cs} CTAs a row of "
              f"{cx.fill_geometry(w, cs).threads} threads: {ms_c:.3f} ms "
              f"({spread(f'exact_fill_{cs}_ctas')}), equal to the "
              f"wrapper's layout ({geo.cs} CTA a row), on {card}")
        del out_c
    # F + G at band WIDE_BAND (F's wide layout) on the block's first 4
    # rows, against the host native engine
    nb, ww = 4, WIDE_BAND
    wargs = (counts, *(a[:nb].contiguous() for a in args[1:]))
    wanf, web = (torch.from_numpy(a).to(dev) for a in prt.band_starts(
        ways_h[:nb], len_h[:nb], ww, t, False))
    out_w, ms_w = time_launches(
        lambda: prt.block_dp(*wargs, wanf, web, ncols, bandwidth=ww,
                             chunk=t, widen=1, staircase=False,
                             kernel="cuda"), 3, "exact_wide_band")
    (c_w, b_w, f_w), ms_wf = time_launches(
        lambda: cx.exact_fill(*wargs, ncols, bandwidth=ww), 3,
        "exact_fill_wide_band")
    _, ms_wg = time_launches(
        lambda: cx.exact_walk(c_w, b_w, f_w, web, wanf, wargs[4], ncols,
                              cpad=cpad), 3, "exact_walk_wide_band")
    del c_w, b_w, f_w
    ref_w, s_wn, wn_lo, wn_hi = host_median(nb, ww, 3)
    _same_block_result(f"band {ww}, {nb} rows: kernels F + G vs the host "
                       "native engine", [x.cpu().numpy() for x in out_w],
                       ref_w, ncols)
    print(f"band {ww} ({cx.fill_geometry(ww).groups} groups of 2,048 lanes "
          f"a CTA) on the block's first {nb} rows: kernels F + G with their "
          f"torch ops {ms_w:.3f} ms (F {ms_wf:.3f} ms, G {ms_wg:.3f} ms; "
          f"median of 3), the host native engine {s_wn * 1e3:.1f} ms "
          f"(median of 3, {wn_lo * 1e3:.1f}-{wn_hi * 1e3:.1f} ms; "
          f"{os.cpu_count()} threads); rows, best and inserts equal, on "
          f"{card}")
    del out_w

    # the resident engine with every block forced onto the exact route
    # (an insert fetch of one slot), the host library made unavailable:
    # the card's route takes kernels F and G and never asks for it
    msa = rio.read_msa(converge_msa_path)
    cls = prd.DeviceResidentRealigner

    def no_library():
        raise native.NativeBuildError(
            "native host library: made unavailable")

    os.environ["RR_FLUSH_CAP"] = str(1 << 30)
    prd._native = no_library
    try:
        reset_launches()
        reset_exact_blocks()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            eng = cls(msa, bandwidth=1000, block_rows=64, device=dev)
            eng._maxf = 1                # every insert list overflows
            eng.ent_al_gapper()
            log_d = [eng.overall_pair()]
            for _ in range(2):
                eng.sweep()
                log_d.append(eng.overall_pair())
            torch.cuda.synchronize()
            s_d = time.perf_counter() - t0
        launches = launches_now()
        ex = exact_blocks()
        sweeps = list(cls.sweep_log)
        prd._native = prt._native
        t0 = time.perf_counter()
        host = prt.BatchedRealigner(msa, bandwidth=1000, block_rows=64)
        host.ent_al_gapper()
        log_h = [host.overall_pair()]
        for _ in range(2):
            host.sweep()
            log_h.append(host.overall_pair())
        s_h = time.perf_counter() - t0
    finally:
        prd._native = prt._native
        del os.environ["RR_FLUSH_CAP"]
    if [str(c.message) for c in caught if "exact band" in str(c.message)]:
        raise AssertionError("the card's exact route asked for the host "
                             "library")
    print(f"resident engine, 2 sweeps at block 64 on MSA {msa.shape}, every "
          f"block forced exact ({eng._overflow_events} insert-fetch "
          f"overflows), host library unavailable: exact blocks by route "
          f"{ex} in {s_d:.2f} s; launches {launches}; host native engine "
          f"{s_h:.2f} s, on {card}")
    for i, rec in enumerate(sweeps):
        print(f"  sweep {i + 1}: {rec['s']:.3f} s, exact blocks "
              f"{rec['exact_blocks']} in {rec['exact_block_s']} s")
    for m, u in log_d:
        print(f"  OverallScore: {m}{u:06d}")
    check_exact_routes("forced-exact resident run", ex)
    if ex["cuda"] <= 0 or min(launches["exact_fill"],
                              launches["exact_walk"]) <= 0:
        raise AssertionError(f"kernels F and G never ran: {ex}, {launches}")
    if log_d != log_h:
        raise AssertionError(f"forced-exact resident run {log_d} != host "
                             f"native engine {log_h}")
    return launches, times, bounds


def _no_foreign_modules():
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "repeatresolver_tpu"))
    if foreign:
        raise AssertionError(f"a rank imported {foreign}")


def mesh_rank(rank, n, msa_path, real_path, outdir, device="cuda:0"):
    """One rank of phase 10 (a process of its own on cuda:0; the device
    is an argument so that the rank can be rehearsed on the CPU)."""
    import numpy as np
    import torch

    from repeatresolver_tpu_torch.config import (MaxCorrConfig,
                                                 RealignerConfig)
    from repeatresolver_tpu_torch.models import maxcorr as pmc
    from repeatresolver_tpu_torch.models import realigner as prt
    from repeatresolver_tpu_torch.ops import _build
    from repeatresolver_tpu_torch.ops import cuda_realign as cr
    from repeatresolver_tpu_torch.parallel import sharded
    from repeatresolver_tpu_torch.utils import io as rio

    mesh = sharded.make_mesh(n, backend="gloo", device=device)
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" \
        else (lambda: None)
    coll = {"s": 0.0, "calls": 0}
    for name in ("all_reduce", "all_gather"):
        def timed(*a, _fn=getattr(mesh, name), **k):
            sync()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            coll["s"] += time.perf_counter() - t0
            coll["calls"] += 1
            return out
        setattr(mesh, name, timed)
    msa = rio.read_msa(msa_path)
    os.environ["RR_FLUSH_CAP"] = str(1 << 30)
    _build.kernel_events = {}
    log: list = []
    # what the block halving would read here (the engine takes the
    # least over the ranks at its first block above 8 rows)
    budget = prt.device_memory_budget(mesh.device)
    # this rank's first shard, as its block step hands it to kernel A
    # (the step reaches the fill through this stand-in module)
    first = {}

    def recording_fill(*args, **kw):
        if not first:
            first["block"] = ([a.clone() for a in args[:5]], args[5], kw)
        return cr.staircase_fill(*args, **kw)

    prt.cr = types.SimpleNamespace(staircase_fill=recording_fill,
                                   MAX_W2=cr.MAX_W2)
    reset_launches()
    reset_exact_blocks()
    sync()
    t0 = time.perf_counter()
    try:
        prt.realign_batched(
            msa, RealignerConfig(bandwidth=1000, block_rows=64,
                                 max_rounds=MESH_ROUNDS),
            score_log=log, mesh=mesh, mode="staircase", kernel="cuda")
        sync()
    finally:
        prt.cr = cr
    wall = time.perf_counter() - t0
    launches = launches_now()
    events, _build.kernel_events = _build.kernel_events, None
    in_kernel = {k: sum(e0.elapsed_time(e1) for e0, e1 in v) / 1e3
                 for k, v in events.items()}
    report = dict(
        rank=rank, log=log, wall_s=wall, budget_bytes=budget,
        sweep_s=prt.BatchedRealigner.sweep_totals()[1],
        sweeps=prt.BatchedRealigner.sweep_totals()[0],
        launches=launches, kernel_s=in_kernel, collective_s=coll["s"],
        collectives=coll["calls"], staged=mesh.staged,
        exact=exact_blocks(), built_here=sorted(_build.build_info))
    # kernels A and B against their plain versions on that shard (after
    # the launches were read: these do not count)
    args, ncols, kw = first["block"]
    t0 = time.perf_counter()
    err_a, err_b = compare_block(args, ncols, kw["bandwidth"], kw["chunk"],
                                 kw["widen"], args[1].shape[1])[0]
    report["first_shard"] = dict(
        err={"staircase_fill": err_a, "walk_backtrack": err_b},
        rows=args[2].shape[0], bases=args[2].shape[1], ncols=ncols,
        cpad=args[1].shape[1], bandwidth=kw["bandwidth"],
        chunk=kw["chunk"], widen=kw["widen"],
        seconds=time.perf_counter() - t0)
    coll["s"], coll["calls"] = 0.0, 0
    real = rio.read_msa(real_path)
    from repeatresolver_tpu_torch.ops import cuda_maxcorr, maxcorr_tile
    cuda_maxcorr.maxcorr_group.launches = 0
    cuda_maxcorr.maxcorr_group.tiles = 0
    maxcorr_tile.group_pass_plain.calls = 0
    t0 = time.perf_counter()
    mc = pmc.compute_maxcorrs_device(real, MaxCorrConfig(), mesh=mesh)
    report["maxcorr_s"] = time.perf_counter() - t0
    report["maxcorr_collective_s"] = coll["s"]
    report["maxcorr_scan"] = dict(
        pmc.compute_maxcorrs_device.last_stats,
        launches=cuda_maxcorr.maxcorr_group.launches,
        tiles=cuda_maxcorr.maxcorr_group.tiles,
        plain_runs=maxcorr_tile.group_pass_plain.calls)
    np.save(os.path.join(outdir, f"maxcorrs_rank{rank}.npy"), mc)
    if mesh.device.type == "cuda":
        # kernel E on a group of this rank's stripe (after the launches
        # were read: these do not count): the stripe's last seed tile at
        # or before the largest MaxCorr's, against the partner tiles
        # from its diagonal (the stripe's first tiles hold the MSA's thin
        # start, where no pair is allowed)
        sc = pmc.MaxCorrScan(real, MaxCorrConfig(), 256, mesh.device)
        k = int(np.argmax(mc)) // 5 // sc.t
        k = max(k - (k - rank) % n, rank)
        err, relevant, lines, _ = check_groups(sc, [(k, k)])
        report["maxcorr_stripe_pair"] = dict(pair=[k, k], err=err,
                                             relevant=relevant,
                                             line=lines[0])
        del sc
    _no_foreign_modules()
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def mesh_phase(card, dev, msa_path, paper_lines, errs):
    """Phase 10; returns a rank's launches of each kernel in the realign
    run (every rank must count the same) and kernel E's launches in the
    striped MaxCorrs scan (both ranks)."""
    import numpy as np
    import torch

    from repeatresolver_tpu_torch.config import RealignerConfig
    from repeatresolver_tpu_torch.models import realigner as prt
    from repeatresolver_tpu_torch.parallel import sharded
    from repeatresolver_tpu_torch.utils import io as rio

    outdir = os.path.join(WORK, "mesh")
    os.makedirs(outdir)
    real_path = os.path.join(WORK, "pipeline", PIPE_NAME + "_MSAreal")
    torch.cuda.empty_cache()             # the ranks share this card
    t0 = time.perf_counter()
    sharded.spawn(mesh_rank, 2, (msa_path, real_path, outdir),
                  backend="gloo", timeout=RANK_TIMEOUT_S)
    print(f"two ranks on cuda:0 over gloo: {time.perf_counter() - t0:.1f} s"
          " from spawn to exit")
    reports = []
    for r in range(2):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            reports.append(json.load(f))

    # the same rounds in this process, MSA on the host (non-resident)
    os.environ["RR_FLUSH_CAP"] = str(1 << 30)
    os.environ["RR_RESIDENT"] = "0"
    try:
        log_s: list = []
        t0 = time.perf_counter()
        prt.realign_batched(
            rio.read_msa(msa_path),
            RealignerConfig(bandwidth=1000, block_rows=64,
                            max_rounds=MESH_ROUNDS),
            score_log=log_s, mode="staircase", kernel="cuda", device=dev)
        torch.cuda.synchronize()
        s_single = time.perf_counter() - t0
    finally:
        del os.environ["RR_FLUSH_CAP"], os.environ["RR_RESIDENT"]
    lines_s = [f"OverallScore: {m}{u:06d}" for m, u in log_s]
    for rep in reports:
        lines = [f"OverallScore: {m}{u:06d}" for m, u in rep["log"]]
        if lines != lines_s:
            raise AssertionError(f"rank {rep['rank']} {lines} != "
                                 f"single-process non-resident {lines_s}")
        if min(rep["launches"][k] for k in REALIGN_KERNELS) <= 0:
            raise AssertionError(f"rank {rep['rank']}: a kernel never "
                                 f"launched: {rep['launches']}")
        if rep["built_here"]:
            raise AssertionError(f"rank {rep['rank']} ran nvcc again: "
                                 f"{rep['built_here']}")
        print(f"rank {rep['rank']}: exact blocks by route {rep['exact']}")
        check_exact_routes(f"mesh rank {rep['rank']}", rep["exact"])
        ka = rep["kernel_s"].get("staircase_fill", 0.0)
        kb = rep["kernel_s"].get("walk_backtrack", 0.0)
        print(f"rank {rep['rank']} on {card}: {MESH_ROUNDS} rounds, wall "
              f"{rep['wall_s']:.2f} s, {rep['sweeps']} sweeps "
              f"{rep['sweep_s']:.2f} s = inside kernel A {ka:.3f} s + "
              f"inside kernel B {kb:.3f} s (CUDA events) + "
              f"{rep['collectives']} collectives {rep['collective_s']:.3f} s"
              f" ({rep['staged']} staged through pinned host memory: gloo"
              f" takes host tensors) + rest "
              f"{rep['sweep_s'] - ka - kb - rep['collective_s']:.3f} s "
              f"(host clock); launches {rep['launches']}")
        fs = rep["first_shard"]
        for name, e in fs["err"].items():
            errs[name] = max(errs[name], e)
        print(f"rank {rep['rank']}'s first shard bit-equal to the plain "
              f"versions: {fs['rows']} rows x {fs['bases']} bases, MSA "
              f"width {fs['ncols']} of {fs['cpad']}, band "
              f"{fs['bandwidth']}, chunk {fs['chunk']}, widen {fs['widen']}"
              f" (W2 {fs['bandwidth'] + fs['widen'] * fs['chunk']}); "
              f"{fs['seconds']:.1f} s")
    if reports[0]["launches"] != reports[1]["launches"]:
        raise AssertionError("the ranks counted different launches: "
                             f"{[r['launches'] for r in reports]}")
    # the halving test of BatchedRealigner._realign_block for a rank's
    # half of a 64-row block at the ladder's top rung (W2 = 1000 + 16 x
    # 128): half a byte a code with headroom
    budget = min(r["budget_bytes"] for r in reports)
    need = 0.5 * 32768 * 32 * (1000 + 16 * 128)
    if reports[0]["budget_bytes"] != reports[1]["budget_bytes"]:
        raise AssertionError("the ranks read different memory budgets")
    print(f"memory budget of the block halving (a quarter of the card's "
          f"total memory, the same in every rank): {budget / 2**30:.2f} "
          f"GiB; a "
          f"rank's 32 rows x 32768 bases at the widest window (W2 3048) "
          f"count {need / 2**30:.2f} GiB against it: "
          f"{'no block is halved' if need <= budget else 'blocks are halved'}"
          f" on {card}")
    head = lines_s[:MESH_ROUNDS + 1]
    for ln in lines_s:
        print(f"  {ln}")
    if head != paper_lines[:MESH_ROUNDS + 1]:
        raise AssertionError(f"mesh trajectory {head} != phase 8's "
                             f"{paper_lines[:MESH_ROUNDS + 1]}")
    print(f"{len(lines_s)} OverallScore lines equal in both ranks and in "
          f"the single-process non-resident run ({s_single:.2f} s), the "
          f"first {MESH_ROUNDS + 1} equal to phase 8's")

    ref = np.load(os.path.join(WORK, "pipeline_host", "maxcorrs_device.npy"))
    for rep in reports:
        mc = np.load(os.path.join(outdir, f"maxcorrs_rank{rep['rank']}.npy"))
        if not np.array_equal(mc, ref):
            raise AssertionError(
                f"rank {rep['rank']}: striped MaxCorrs scan != single scan,"
                f" max abs difference {np.abs(mc - ref).max()}")
        ms = rep["maxcorr_scan"]
        check_group_counts(ms["launches"], ms["tiles"], ms)
        if ms["plain_runs"]:
            raise AssertionError(f"rank {rep['rank']}: plain group pass "
                                 f"runs {ms['plain_runs']}")
        print(f"rank {rep['rank']}'s stripe: {ms['tile_pairs']} tile pairs "
              f"({ms['tile_pairs_needed']} needed), {ms['launches']} "
              f"calls of kernel E ({ms['groups_queued']} groups, "
              f"{ms['product_launches']} products), {ms['host_reads']} host "
              f"reads, plain pass runs {ms['plain_runs']}")
        sp = rep["maxcorr_stripe_pair"]
        if sp["relevant"] == 0:
            raise AssertionError(f"rank {rep['rank']}: no relevant pair in"
                                 f" the group from {sp['pair']}")
        errs["maxcorr_tile"] = max(errs["maxcorr_tile"], sp["err"])
        print(f"rank {rep['rank']}'s {sp['line']}")
    print(f"MaxCorrs striped over 2 ranks == the single device scan "
          f"(tolerance 0, {len(ref)} values, {int((ref > 0).sum())} "
          f"nonzero): {reports[0]['maxcorr_s']:.2f} / "
          f"{reports[1]['maxcorr_s']:.2f} s a rank, of it the max-merge "
          f"{reports[0]['maxcorr_collective_s']:.3f} s, on {card}")
    # and kernel E's launches in the striped scan, both ranks together
    return reports[0]["launches"], sum(r["maxcorr_scan"]["launches"]
                                       for r in reports)


def run_processes(cmds, what, timeout=RANK_TIMEOUT_S):
    """Run commands side by side from the repository root; every one
    must exit 0 inside the time limit. Returns their outputs."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    try:
        deadline = time.perf_counter() + timeout
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"{what}: exit code {p.returncode}\n"
                                 f"{out[-3000:]}")
    return outs


def resolve_windows_phase(card):
    """Phase 11."""
    import socket
    pdir = os.path.join(WORK, "pipeline")
    names = (PIPE_NAME + "_MSAreal", "MaxCorrsOf_" + PIPE_NAME + "_MSAreal")
    dirs = {k: os.path.join(WORK, "windows_" + k) for k in ("single", "dist")}
    for d in dirs.values():
        os.makedirs(d)
        for n in names:
            shutil.copy(os.path.join(pdir, n), d)
    cli = [sys.executable, "-m", "repeatresolver_tpu_torch.cli",
           "resolve-windows"]
    t0 = time.perf_counter()
    run_processes([cli + [os.path.join(dirs["single"], names[0]),
                          "--device", "cuda"]], "resolve-windows")
    s_single = time.perf_counter() - t0
    for attempt in range(3):
        # a free port, found by binding and closing: another process may
        # take it before rank 0 listens there, so a run that failed for
        # that alone is made again on another port
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        try:
            outs = run_processes(
                [cli + [os.path.join(dirs["dist"], names[0]),
                        "--coordinator", f"127.0.0.1:{port}", "--procs",
                        "2", "--proc-id", str(i), "--device", "cuda"]
                 for i in range(2)], "resolve-windows, two processes")
            break
        except AssertionError as e:
            if attempt == 2 or "address already in use" not in str(e).lower():
                raise
            print(f"port {port} was taken meanwhile: once more")
    s_dist = time.perf_counter() - t0
    if not all("-> " in out for out in outs):
        raise AssertionError("a process resolved no window")
    subs = sorted(n for n in os.listdir(dirs["single"])
                  if "SubdivisionOf_" in n)
    if len(subs) != 18:
        raise AssertionError(f"{len(subs)} subdivision files, not 6 x 3")
    for n in subs:
        with open(os.path.join(dirs["single"], n), "rb") as f:
            ref = f.read()
        for other in (dirs["dist"], pdir):
            with open(os.path.join(other, n), "rb") as f:
                if f.read() != ref:
                    raise AssertionError(f"{n}: {other} != single process")
    print(f"{len(subs)} subdivision files byte-identical: one process "
          f"({s_single:.1f} s), two processes over gloo ({s_dist:.1f} s), "
          f"the pipeline's (phase 6), on {card}")
    t0 = time.perf_counter()
    out, = run_processes([[sys.executable, "-m",
                           "repeatresolver_tpu_torch.graft_entry",
                           "--ranks", "2"]], "graft_entry")
    for line in out.splitlines():
        if " ok" in line:
            print(f"  {line}")
    if "entry ok" not in out or "dryrun_multichip(2) ok" not in out:
        raise AssertionError(f"graft_entry: {out[-2000:]}")
    print(f"graft_entry on the card: {time.perf_counter() - t0:.1f} s")


# phase 13: the paper-run driver at a small configuration whose realign
# runs on the resident engine (55 rows: one block of 64)
DRIVER_ARGS = ["-c", "16", "-n", "8", "-l", "3000", "-d", "1", "--seed",
               "11", "--band", "1000", "--block-rows", "64", "--device",
               "cuda"]
# a process of phase 13: the driver with every count at 0, then one line
# of its launches, its plain-loop runs and any foreign module. With a
# record path (argv[1], "-" for none), stand-ins for the kernels' modules
# keep the inputs of the first block step at each slack, of the first
# cut call and of the first and the largest align call, and save them
# there (host copies) for the phase to replay
DRIVER_CHILD = """
import json, sys, types
import torch
from repeatresolver_tpu_torch import paper_run
from repeatresolver_tpu_torch.models import initial_aligner, read_cutter
from repeatresolver_tpu_torch.models import realigner_device
from repeatresolver_tpu_torch.ops import banded_realign as br
from repeatresolver_tpu_torch.ops import cuda_backtrack as cb
from repeatresolver_tpu_torch.ops import cuda_editdp as ce
from repeatresolver_tpu_torch.ops import cuda_exact as cx
from repeatresolver_tpu_torch.ops import cuda_maxcorr as cm
from repeatresolver_tpu_torch.ops import cuda_realign as cr
from repeatresolver_tpu_torch.ops import cuda_resolver as cv
from repeatresolver_tpu_torch.ops import editdp, maxcorr_tile
counters = dict(staircase_fill=cr.staircase_fill,
                walk_backtrack=cb.backtrack_moves,
                editdp_fill=ce.editdp_fill, editdp_walk=ce.editdp_walk,
                maxcorr_tile=cm.maxcorr_group, exact_fill=cx.exact_fill,
                exact_walk=cx.exact_walk, resolver_pairs=cv.pair_pass)
plain = (editdp.forward_plain, editdp.walk_plain,
         maxcorr_tile.group_pass_plain, br.banded_fill)
kept = {"blocks": {}}


def host(args):
    return [a.cpu() if torch.is_tensor(a) else a for a in args]


def fill(*args, **kw):
    if kw["widen"] not in kept["blocks"]:
        kept["blocks"][kw["widen"]] = (host(args[:5]), host(args[5:])[0],
                                       kw)
    return cr.staircase_fill(*args, **kw)


def last_rows(*args):
    kept.setdefault("cut", host(args))
    return editdp.last_rows(*args)


def align(*args):
    kept.setdefault("align_first", host(args))
    if args[0].shape[1] > kept.get("lq", -1):
        kept["lq"], kept["align_longest"] = args[0].shape[1], host(args)
    return editdp.align_on_device(*args)


if sys.argv[1] != "-":
    realigner_device.cr = types.SimpleNamespace(
        **{**vars(cr), "staircase_fill": fill})
    read_cutter.editdp = types.SimpleNamespace(
        **{**vars(editdp), "last_rows": last_rows})
    initial_aligner.editdp = types.SimpleNamespace(
        **{**vars(editdp), "align_on_device": align})
for f in counters.values():
    f.launches = 0
for f in plain:
    f.calls = 0
paper_run.main(sys.argv[2:])
if sys.argv[1] != "-":
    torch.save(kept, sys.argv[1])
print("DRIVER " + json.dumps(dict(
    launches={k: f.launches for k, f in counters.items()},
    plain=[f.calls for f in plain],
    foreign=sorted(m for m in sys.modules
                   if m.split(".")[0] in ("jax", "repeatresolver_tpu")))))
"""


def _driver_report(out, what):
    line = [ln for ln in out.splitlines() if ln.startswith("DRIVER ")]
    if not line:
        raise AssertionError(f"{what}: no report\n{out[-2000:]}")
    rep = json.loads(line[-1][len("DRIVER "):])
    if rep["foreign"]:
        raise AssertionError(f"{what} imported {rep['foreign']}")
    if any(rep["plain"]):
        raise AssertionError(f"{what}: a plain version ran "
                             f"{rep['plain']}")
    return rep["launches"]


def _same_npz(a, b):
    import numpy as np
    with np.load(a) as za, np.load(b) as zb:
        return (sorted(za.files) == sorted(zb.files)
                and all(np.array_equal(za[k], zb[k]) for k in za.files))


def paper_driver_phase(card, errs):
    """Phase 13; returns the straight run's launches. The straight run
    records the kernels' inputs, replayed here through each kernel and
    its plain version; a third process cuts and aligns on the host
    routes (--device cpu --align-band 0), whose files the straight run's
    must equal."""
    import hashlib

    import torch
    dirs = {k: os.path.join(WORK, "driver_" + k)
            for k in ("resumed", "straight", "host")}
    record = os.path.join(WORK, "driver_inputs.pt")

    def cmd(d, *extra, rec="-"):
        return [sys.executable, "-c", DRIVER_CHILD, rec, "--workdir", d] + \
            DRIVER_ARGS + list(extra)

    def state(d):
        out = {}
        for n in os.listdir(d):
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[n] = (hashlib.sha256(f.read()).hexdigest(),
                          os.stat(p).st_mtime_ns)
        return out

    t0 = time.perf_counter()
    out_a, out_s, out_h = run_processes(
        [cmd(dirs["resumed"], "--until", "align"),
         cmd(dirs["straight"], rec=record),
         cmd(dirs["host"], "--device", "cpu", "--align-band", "0",
             "--until", "align")],
        "paper_run --until align, straight, and on the host routes")
    t_first = time.perf_counter() - t0
    first = _driver_report(out_a, "paper_run --until align")
    straight = _driver_report(out_s, "paper_run straight")
    _driver_report(out_h, "paper_run --device cpu")
    host_files = sorted(set(os.listdir(dirs["host"]))
                        - {"stage_times.json"})
    for n in host_files:
        with open(os.path.join(dirs["host"], n), "rb") as f1, \
                open(os.path.join(dirs["straight"], n), "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError(f"{n}: the card's driver != --device "
                                     "cpu --align-band 0")
    before = state(dirs["resumed"])
    del before["stage_times.json"]
    t0 = time.perf_counter()
    out_r, = run_processes([cmd(dirs["resumed"])], "paper_run resumed")
    t_resume = time.perf_counter() - t0
    resumed = _driver_report(out_r, "paper_run resumed")
    after = state(dirs["resumed"])
    touched = [n for n in before if after.get(n) != before[n]]
    if touched:
        raise AssertionError(f"the resume touched {touched}")
    recs = {}
    for k, d in dirs.items():
        with open(os.path.join(d, "stage_times.json")) as f:
            recs[k] = [json.loads(ln) for ln in f]
    stages = [r["stage"] for r in recs["resumed"]]
    if (len(set(stages)) != len(stages)
            or stages != [r["stage"] for r in recs["straight"]]
            or stages[:4] != ["simulate", "cut", "align", "realign"]
            or stages[-1] != "assess"):
        raise AssertionError(f"stages {stages} (straight: "
                             f"{[r['stage'] for r in recs['straight']]})")
    names = sorted(os.listdir(dirs["straight"]))
    if sorted(os.listdir(dirs["resumed"])) != names:
        raise AssertionError("the resumed run's files differ in name")
    for n in names:
        a, b = (os.path.join(dirs[k], n) for k in ("resumed", "straight"))
        if n == "stage_times.json":
            continue
        if n.endswith(".done"):
            with open(a) as fa, open(b) as fb:
                same = json.load(fa)["rounds"] == json.load(fb)["rounds"]
        elif n.endswith(".ckpt"):
            # npz: its zip members carry their write time
            same = _same_npz(a, b)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                same = fa.read() == fb.read()
        if not same:
            raise AssertionError(f"{n}: resumed run != straight run")
    # kernel E is not on this path: at 55 rows the MaxCorrs gate takes
    # the host scan
    dead = [k for k in KERNELS if not straight[k] and k != "maxcorr_tile"]
    if dead or not (first["editdp_fill"] and first["editdp_walk"]
                    and resumed["staircase_fill"]
                    and resumed["walk_backtrack"]):
        raise AssertionError(f"kernels that did not launch: straight "
                             f"{straight}, --until align {first}, resumed "
                             f"{resumed}")
    if resumed["editdp_fill"] or resumed["editdp_walk"]:
        raise AssertionError(f"the resume cut or aligned again: {resumed}")
    # the straight run's kernel inputs through each kernel and its plain
    # version (launches not counted in the run above)
    kept = torch.load(record, weights_only=False)

    def to_card(x):
        return x.cuda() if torch.is_tensor(x) else x
    blocks = {w: ([to_card(a) for a in args], to_card(ncols), kw)
              for w, (args, ncols, kw) in kept["blocks"].items()}
    if not blocks:
        raise AssertionError("the straight run recorded no block step")
    replay_blocks(blocks, errs, "paper_run realign")
    replay_editdp({k: [to_card(a) for a in kept[k]] for k in
                   ("cut", "align_first", "align_longest")}, errs,
                  "paper_run cut and align")
    print("straight run's stages (s): " + ", ".join(
        f"{r['stage']} {r['wall_s']:.2f}" for r in recs["straight"])
        + f"; assessment {recs['straight'][-1]}")
    print(f"cut and align files ({', '.join(host_files)}) byte-equal to "
          f"--device cpu --align-band 0")
    print(f"{len(names)} files equal between a straight run and --until "
          f"align + resume (stage_times.json: the same {len(stages)} "
          f"stages once each; .done: the same rounds; checkpoints: the "
          f"same arrays); the resume left the earlier {len(before)} "
          f"files untouched; launches straight {straight}, --until align "
          f"{first}, resumed {resumed}; the first three processes "
          f"{t_first:.1f} s, the resume {t_resume:.1f} s, on {card}")
    return straight


RESOLVE_ROWS, RESOLVE_COPIES, RESOLVE_COLS = 3000, 100, 17733
# columns of the synthetic MSA that the whole card route resolves (a
# quarter: the paper width's window costs about a minute of host
# significance, measured in the paper-default run instead)
RESOLVE_QUARTER = RESOLVE_COLS // 4
# selected groups a cluster in a paper-default window: 160,633-241,667
# rows of kernel H over 43-64 clusters (the paper-default run on an H100,
# PERF.md §5)
PAPER_SEL_ROWS = 3750
# seconds the host route's relative_vars gets on the paper-scale pass
RELVARS_HOST_S = 30.0


def resolve_window_msa(seed=0, rows=RESOLVE_ROWS, copies=RESOLVE_COPIES,
                       cols=RESOLVE_COLS, difference=0.01):
    """(MSA, each row's copy): a resolver window at the paper run's
    shape, about `rows` rows of `copies` copies (26-34 rows a copy, as
    the paper run's coverage varies, in random order) over `cols`
    columns, every row covering the window. The copies descend as the
    simulator's Tree (models/simulator.tree_copies: a binary doubling
    tree of log2(copies) + 1 generations, the first `copies` leaves
    kept, each branch mutating difference / 2 of the columns). A
    mutation is a substitution (a third) or the branch's clade carrying
    a gap (an insertion or a deletion: in the alignment both split the
    rows the same way); then 1% substitutions and 1% gaps as noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    hap = rng.integers(0, 4, (1, cols)).astype(np.int8)
    per_branch = int(difference / 2.0 * cols)
    for _ in range(int(np.log2(copies)) + 1):
        hap = np.repeat(hap, 2, axis=0)
        for child in hap:
            at = rng.integers(0, cols, per_branch)
            sub = rng.random(per_branch) < 1.0 / 3.0
            base = child[at]
            child[at] = np.where(
                sub, np.where(base < 4, (base + rng.integers(1, 4, at.size))
                              % 4, rng.integers(0, 4, at.size)), 4)
    spread = rng.integers(-4, 5, copies)
    copy_of = rng.permutation(np.repeat(np.arange(copies),
                                        rows // copies + spread))
    msa = hap[:copies][copy_of]
    noise = rng.random(msa.shape)
    msa[noise < 0.01] = rng.integers(0, 4, int((noise < 0.01).sum()))
    msa[(noise >= 0.01) & (noise < 0.02)] = 4
    return np.ascontiguousarray(msa.astype(np.int8)), copy_of


def recording_pairs(rec):
    """Stand-in for ops/cuda_resolver as the resolver sees it: every
    pair_pass call's inputs (clones) go to the list `rec` before the
    kernel runs."""
    from repeatresolver_tpu_torch.models import resolver as pres
    from repeatresolver_tpu_torch.ops import cuda_resolver as cv

    def pair_pass(p, tables, occ, h, marked, count=False):
        rec.append((cv.PairPass(**{k: v.clone() for k, v in
                                   vars(p).items()}),
                    tables.clone(), occ.clone(),
                    cv.PairHash(h.keys.clone(), h.bits.clone(),
                                h.state.clone()), count))
        return cv.pair_pass(p, tables, occ, h, marked, count)

    @contextlib.contextmanager
    def ctx():
        pres.cv = types.SimpleNamespace(**{**vars(cv),
                                           "pair_pass": pair_pass})
        try:
            yield
        finally:
            pres.cv = cv
    return ctx()


# the card's peak rates for kernel H's bound, a clock of an SM: the
# popcount pipe (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0: "population count", 16) and the
# int32 pipes (AND, add, shift, multiply-add: 64)
POPC_PER_SM_CLOCK = 16
INT32_PER_SM_CLOCK = 64


def pair_pass_bound(p, sm_count, sm_hz):
    """(ms, by, detail) of the least time for kernel H's work on p: the
    pairs its inputs hold (sel[b] >= sel[a] + ROW_GAP within a cluster),
    each word of a pair a 64-bit popcount (two 32-bit popcounts, on the
    popcount pipe) and an AND and an add of 64 bits (three int32
    operations: two ANDs, the add of the halves' counts), each pair 4
    more int32 operations (its entry's index, a multiply-add and an
    add; its word, a shift; its bit, a shift and a test counted as
    one), over each pipe's rate; the bytes of its inputs and marks read
    and written once. The largest of the three; the detail names it."""
    import numpy as np

    from repeatresolver_tpu_torch.ops import cuda_resolver as cv
    sel = p.sel.cpu().numpy().astype(np.int64)
    off = p.row_off.cpu().numpy()
    words = p.words.cpu().numpy()
    pairs = word_pairs = 0
    for k in range(len(words)):
        s = sel[off[k]:off[k + 1]]
        n = int((s.size - np.searchsorted(s, s + cv.ROW_GAP)).sum())
        pairs += n
        word_pairs += n * int(words[k])
    popc = word_pairs * 2
    ints = word_pairs * 3 + pairs * 4
    clocks = sm_count * sm_hz
    ms_popc = popc / (clocks * POPC_PER_SM_CLOCK) * 1e3
    ms_int = ints / (clocks * INT32_PER_SM_CLOCK) * 1e3
    nbytes = sum(int(x.numel()) * x.element_size() for x in vars(p).values()
                 ) + (int(p.nrows) + 31) // 32 * 4
    ms_bytes = nbytes / 3.35e12 * 1e3
    ms, pipe = max((ms_popc, "the popcount pipe"),
                   (ms_int, "the int32 pipes"), (ms_bytes, "bytes"))
    return (ms, "bytes" if pipe == "bytes" else "operations",
            f"set by {pipe}; {pairs:,} pairs, {word_pairs:,} pair-words: "
            f"{popc:.4g} "
            f"popcounts over {sm_count} SMs x {POPC_PER_SM_CLOCK} a clock x "
            f"{sm_hz / 1e6:.0f} MHz = {ms_popc:.4g} ms; {ints:.4g} int32 "
            f"operations at {INT32_PER_SM_CLOCK} a clock = {ms_int:.4g} ms; "
            f"{nbytes:,} bytes over 3.35 TB/s = {ms_bytes:.4g} ms")


def replay_pairs(rec, label, dev):
    """Kernel H against its plain version on recorded inputs: a counting
    launch's occurrence bitmap (bit for bit), hash keys (as a set;
    racing inserts place them apart) and overflow flag from a zeroed
    bitmap and an empty hash of the recorded size, a lookup launch's
    packed marks on the recorded tables and hash. Returns the largest
    difference of a mark, a bit or a key (0 or 1)."""
    import torch

    from repeatresolver_tpu_torch.ops import cuda_resolver as cv
    for p, tables, occ, h, count in rec:
        got = []
        for run in (cv.pair_pass, cv.pair_pass_plain):
            m = torch.zeros((p.nrows + 31) // 32, dtype=torch.int32,
                            device=dev)
            if count:
                hh = cv.PairHash.empty(h.log2, dev)
                oo = torch.zeros_like(occ)
                run(p, tables, oo, hh, m, True)
                got.append((hh.overflowed(), oo.cpu(), None
                            if hh.overflowed() else
                            torch.sort(hh.keys[hh.keys != 0]).values.cpu()))
            else:
                run(p, tables, occ, h, m)
                got.append((False, m.cpu(), None))
        (f0, a0, k0), (f1, a1, k1) = got
        same = f0 == f1 and torch.equal(a0, a1) and (
            k0 is None or torch.equal(k0, k1))
        if not same:
            raise AssertionError(f"{label}: kernel H != pair_pass_plain "
                                 f"({'count' if count else 'lookup'} mode)")
    print(f"{label}: kernel H bit-equal to pair_pass_plain on {len(rec)} "
          f"recorded launches ({sum(r[4] for r in rec)} in counting mode)")
    return 0


def print_resolve_records(label, records, card):
    """One line a resolve_window record: seconds, split, tallies."""
    for r in records:
        split = ", ".join(f"{k} {v:.2f}" for k, v in r["split"].items()
                          if v >= 0.005)
        tallies = {k: v for k, v in r.items() if k not in (
            "window", "route", "device", "split", "s", "rows", "cols")}
        print(f"  {label} window {r['window'][0]}-{r['window'][1]} "
              f"({r['route']} route, {r['rows']} x {r['cols']}): "
              f"{r['s']:.2f} s on {card}'s host; split: {split}; {tallies}")


def resolve_card_phase(card, dev, errs, sm_count, sm_hz):
    """Phase 14; returns (H's launches on phase 6's windows, on the
    synthetic MSA), H's (ms, plain ms) and its bound."""
    import torch

    from repeatresolver_tpu_torch.config import ResolverConfig, WindowConfig
    from repeatresolver_tpu_torch.models import resolver as pres
    from repeatresolver_tpu_torch.models.window import window_boundaries
    from repeatresolver_tpu_torch.utils import io as rio

    def host_calls():
        return pres._cliques_host.calls + pres.relative_vars.calls

    # phase 6's windows through the card route, against the host route
    pdir = os.path.join(WORK, "pipeline")
    real = rio.read_msa(os.path.join(pdir, PIPE_NAME + "_MSAreal"))
    mc = rio.read_maxcorrs(os.path.join(
        pdir, "MaxCorrsOf_" + PIPE_NAME + "_MSAreal"))
    bounds = window_boundaries(real, WindowConfig())
    rec615: list = []
    pres.resolve_window.log = []
    reset_launches()
    calls0 = host_calls()
    outs, s_card = [], 0.0
    with recording_pairs(rec615):
        for von, bis in zip(bounds[:-1], bounds[1:]):
            t0 = time.perf_counter()
            outs.append(pres.resolve_window(real, mc, von, bis,
                                            ResolverConfig(), dev))
            s_card += time.perf_counter() - t0
    torch.cuda.synchronize()
    win_launches = launches_now()
    if host_calls() != calls0:
        raise AssertionError("the card route took a host route's "
                             "candidate statistics or relative_vars")
    card_recs = list(pres.resolve_window.log)
    t0 = time.perf_counter()
    for (von, bis), out in zip(zip(bounds[:-1], bounds[1:]), outs):
        host = pres.resolve_window(real, mc, von, bis, ResolverConfig(),
                                   "cpu")
        for kind, u in out.items():
            a, b = (os.path.join(WORK, f"resolve_{r}") for r in ("c", "h"))
            rio.write_subdivision(a, u)
            rio.write_subdivision(b, host[kind])
            with open(a, "rb") as f1, open(b, "rb") as f2:
                if f1.read() != f2.read():
                    raise AssertionError(f"window {von}-{bis} {kind}: "
                                         "card route != host route")
    s_host = time.perf_counter() - t0
    print_resolve_records("pipeline-615", card_recs, card)
    print(f"pipeline-615: {len(outs)} windows, subdivision files "
          f"byte-equal between the card route ({s_card:.2f} s) and the "
          f"host route ({s_host:.2f} s); kernel H launched "
          f"{win_launches['resolver_pairs']} times, the host route's "
          "statistics and relative_vars never")
    if win_launches["resolver_pairs"] <= 0:
        raise AssertionError("kernel H never launched on phase 6's windows")
    errs["resolver_pairs"] = max(errs["resolver_pairs"],
                                 replay_pairs(rec615, "pipeline-615", dev))

    synth_launches, h_times, bound = resolve_synthetic(card, dev, errs,
                                                       sm_count, sm_hz)
    return (win_launches, synth_launches, h_times, bound)


def resolve_synthetic(card, dev, errs, sm_count, sm_hz):
    """Phase 14's synthetic MSA: a quarter through the card route, H at
    the paper-default scale (see the module docstring); returns (H's
    launches in both, H's (ms, plain ms) and its bound)."""
    import numpy as np
    import torch

    from repeatresolver_tpu_torch.config import MaxCorrConfig, ResolverConfig
    from repeatresolver_tpu_torch.models import maxcorr as pmc
    from repeatresolver_tpu_torch.models import resolver as pres
    from repeatresolver_tpu_torch.ops import cuda_resolver as cv
    from repeatresolver_tpu_torch.ops import devmm

    def host_calls():
        return pres._cliques_host.calls + pres.relative_vars.calls

    # the synthetic MSA at the paper's shape, MaxCorrs from the scan
    t0 = time.perf_counter()
    msa, copy_of = resolve_window_msa(rows=RESOLVE_ROWS,
                                      copies=RESOLVE_COPIES,
                                      cols=RESOLVE_COLS)
    mcs = pmc.compute_maxcorrs_device(msa, MaxCorrConfig(), device=dev)
    torch.cuda.synchronize()
    print(f"synthetic MSA {msa.shape} ({RESOLVE_COPIES} copies): MaxCorrs "
          f"device scan {time.perf_counter() - t0:.2f} s with the MSA's "
          f"build, {int((mcs > 0).sum())} nonzero")
    cfg = ResolverConfig(cov=msa.shape[0] // RESOLVE_COPIES)

    # its first quarter through the whole card route, with its split
    rec_win: list = []
    pres.resolve_window.log = []
    reset_launches()
    calls0 = host_calls()
    t0 = time.perf_counter()
    with recording_pairs(rec_win):
        res = pres.resolve_window(msa, mcs, 0, RESOLVE_QUARTER - 1, cfg,
                                  dev)
    torch.cuda.synchronize()
    s_win = time.perf_counter() - t0
    win_q_launches = launches_now()
    if host_calls() != calls0:
        raise AssertionError("the card route took a host route on the "
                             "synthetic window")
    print_resolve_records("synthetic", pres.resolve_window.log, card)
    print(f"synthetic window 0-{RESOLVE_QUARTER - 1}: card route "
          f"{s_win:.2f} s, {int(res['Kmeans'].max()) + 1} Kmeans clusters")
    if win_q_launches["resolver_pairs"] <= 0:
        raise AssertionError("kernel H never launched on the synthetic "
                             "window")
    for kind, u in res.items():
        if u.shape != copy_of.shape or u.min() < 0:
            raise AssertionError(f"synthetic window {kind}: labels "
                                 f"{u.shape}, min {u.min()}")
    errs["resolver_pairs"] = max(errs["resolver_pairs"],
                                 replay_pairs(rec_win, "synthetic", dev))

    # H at the paper-default scale: every copy's relative_vars over the
    # whole width, the significant groups cut where a cluster selects
    # PAPER_SEL_ROWS of them on average
    win = pres.extract_window(msa, 0, RESOLVE_COLS - 1)
    gd = pres.GroupData.from_window(win)
    card_g = pres.CardGroups(gd, dev)
    mc = mcs.reshape(-1, 5)[:win.bis + 1].reshape(-1).astype(np.float64)
    if mc.size != gd.groups.shape[0]:
        raise AssertionError(f"{mc.size} MaxCorrs for "
                             f"{gd.groups.shape[0]} groups")
    cutoff, mingroup = cfg.resolved_cutoff(gd.covcount.size), cfg.mingroup
    ks = [k for k in range(RESOLVE_COPIES)
          if int((copy_of == k).sum()) > 2 * mingroup]
    u_t = torch.from_numpy(copy_of.astype(np.int64)).to(dev)
    onehot = (u_t[None, :] == torch.tensor(ks, device=dev)[:, None]).to(
        torch.int8)
    inter = devmm.int_matmul_t(card_g.groups, onehot)
    picked = (torch.from_numpy(mc > cutoff).to(dev)[:, None]
              & (inter >= mingroup))
    mean_sel = picked.cumsum(0).double().mean(1)
    g_cut = int(torch.searchsorted(mean_sel, float(PAPER_SEL_ROWS)))
    mc[g_cut:] = 0.0
    del inter, picked, onehot
    rec_paper: list = []
    clock = pres.SplitClock(dev)
    reset_launches()
    t0 = time.perf_counter()
    with recording_pairs(rec_paper):
        vars_card = pres._relative_vars_card(card_g, copy_of.copy(), ks, mc,
                                             cutoff, mingroup, clock)
    torch.cuda.synchronize()
    s_relv = time.perf_counter() - t0
    paper_launches = launches_now()
    print(f"paper-scale pair pass: {len(ks)} clusters of "
          f"{2 * mingroup + 1}+ rows, significant groups below {g_cut} of "
          f"{mc.size}: {s_relv:.2f} s on {card}'s host; {clock.counts}")
    if paper_launches["resolver_pairs"] <= 0:
        raise AssertionError("kernel H never launched at paper scale")
    errs["resolver_pairs"] = max(errs["resolver_pairs"],
                                 replay_pairs(rec_paper, "paper-scale", dev))
    t0 = time.perf_counter()
    done = 0
    for k in ks:
        if time.perf_counter() - t0 > RELVARS_HOST_S:
            break
        host = pres.relative_vars(gd, copy_of, k, mc, cutoff, mingroup,
                                  "cpu")
        if host != vars_card[k]:
            raise AssertionError(f"paper-scale cluster {k}: card route's "
                                 "vars != host route's")
        done += 1
    print(f"relative_vars: {done} of {len(ks)} clusters on the host route "
          f"in {time.perf_counter() - t0:.1f} s, the same var lists as the "
          "card route")
    if done == 0:
        raise AssertionError("no cluster's relative_vars checked on the "
                             "host route")

    # the same pass with every cluster's decisions in the hash (the
    # switch at 0; a paper window's tables fit in shared memory): the
    # same var lists
    rec_hash: list = []
    smem = cv.SMEM_TABLE_BYTES
    cv.SMEM_TABLE_BYTES = 0
    reset_launches()
    try:
        with recording_pairs(rec_hash):
            vars_hash = pres._relative_vars_card(
                card_g, copy_of.copy(), ks, mc, cutoff, mingroup,
                pres.SplitClock(dev))
    finally:
        cv.SMEM_TABLE_BYTES = smem
    torch.cuda.synchronize()
    hash_launches = launches_now()
    if vars_hash != vars_card:
        raise AssertionError("paper-scale pair pass: the hashed decisions' "
                             "var lists != the shared-memory tables'")
    errs["resolver_pairs"] = max(errs["resolver_pairs"], replay_pairs(
        rec_hash, "paper-scale, every cluster hashed", dev))

    # H and its plain version on both forms' lookup and counting
    # launches, beside the bound (the same pairs)
    bound = pair_pass_bound(rec_paper[-1][0], sm_count, sm_hz)
    n_words = (rec_paper[-1][0].nrows + 31) // 32
    times = {}
    for label, rec in (("shared-memory tables", rec_paper),
                       ("every cluster hashed", rec_hash)):
        for count in (False, True):
            p, tables, occ, h, _ = next(r for r in rec if r[4] == count)
            marked = torch.zeros(n_words, dtype=torch.int32, device=dev)
            if count:
                def fresh(fn, p=p, tables=tables, occ=occ, h=h):
                    return lambda: fn(p, tables, torch.zeros_like(occ),
                                      cv.PairHash.empty(h.log2, dev),
                                      marked, True)
            else:
                def fresh(fn, p=p, tables=tables, occ=occ, h=h):
                    return lambda: fn(p, tables, occ, h, marked)
            ms = launch_ms(fresh(cv.pair_pass), "resolver_pairs")
            _, plain_ms = time_launches(fresh(cv.pair_pass_plain), 1)
            times[label, count] = (ms, plain_ms)
            keys = int((h.keys != 0).sum()) if not count else int(
                (rec[-1][3].keys != 0).sum())
            print(f"resolver_pairs at paper scale, {label}, "
                  f"{'counting' if count else 'lookup'} launch "
                  f"({p.nrows} rows, {p.nclusters} clusters, "
                  f"{int((p.kflag != cv.BITMAP).sum())} hashed, "
                  f"{p.tiles.shape[0]} tiles, {h.keys.numel():,} hash "
                  f"slots, {keys:,} keys): kernel {ms:.4f} ms (median of "
                  f"{KERNEL_REPS} launches), plain {plain_ms:.3f} ms on "
                  f"{card}; bound {bound[0]:.4f} ms ({bound[0] / ms:.1%} "
                  "of the kernel's time)")
    print(f"  bound {bound[0]:.4f} ms by {bound[1]}: {bound[2]}; library "
          "call: none (no single PyTorch call computes the masked pair "
          "test)")
    both = {k: v + paper_launches[k] + hash_launches[k]
            for k, v in win_q_launches.items()}
    return both, times["shared-memory tables", False], bound


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from repeatresolver_tpu_torch.models import realigner as prt
    from repeatresolver_tpu_torch.models import realigner_device as prd
    from repeatresolver_tpu_torch.ops import _build
    from repeatresolver_tpu_torch.ops import cuda_editdp as ce
    from repeatresolver_tpu_torch.ops import cuda_realign as cr

    from repeatresolver_tpu_torch.models.realigner_device import \
        DEFAULT_WIDEN

    dev = torch.device("cuda", 0)
    errs = {k: 0 for k in KERNELS}

    def to_dev(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]
    with phase("1 card and build"):
        # the kernels (one nvcc each, started together) and the port's
        # host library (g++; get_lib raises if it cannot build)
        t0 = time.perf_counter()
        _build.prebuild(list(KERNELS))
        from repeatresolver_tpu_torch.utils import native
        print(f"host library {os.path.relpath(native.get_lib()._name, REPO)}"
              f"; builds took {time.perf_counter() - t0:.1f} s")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        card = smi.stdout.strip().splitlines()[0]
        print(card)
        clk = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True)
        sm_hz = float(clk.stdout.strip().splitlines()[0]) * 1e6
        sm_count = torch.cuda.get_device_properties(0).multi_processor_count
        print(f"{sm_count} SMs, SM clock (clocks.max.sm) "
              f"{sm_hz / 1e6:.0f} MHz")
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} "
              f"device {torch.cuda.get_device_name(0)}")
        for name in KERNELS:
            _build.load(name)
            secs, log = _build.build_info.get(name, (0.0, "cached"))
            print(f"built {name} in {secs:.1f} s")
            for line in log.splitlines():
                if "Compiling entry" in line:
                    print(f"  {line.split('Compiling entry function')[-1].strip()[:100]}")
                if "registers" in line or "spill" in line:
                    print(f"  {line.strip()}")

    with phase("2 kernels vs plain, small blocks"):
        cases = [dict(seed=5), dict(seed=7, gapdense=True),
                 dict(seed=11, gapdense=True, len_lo=0.05),
                 dict(seed=3, zero_rows=(2, 5))]
        block_inputs = kernel_tests()._inputs
        for case in cases:
            args = to_dev(block_inputs(b=8, tlen=256, c=512, **case))
            for widen in (1, 3):
                (ea, eb), _ = compare_block(args, 512, 64, 32, widen, 576)
                errs["staircase_fill"] = max(errs["staircase_fill"], ea)
                errs["walk_backtrack"] = max(errs["walk_backtrack"], eb)
        print(f"{len(cases) * 2} blocks bit-equal (rows of length 0 and "
              "1, dead walks included)")
        # kernels F and G: shifts past the band, rows of length 0 and 1,
        # padding columns, a row ending at the last column, band 2600;
        # bands 4,200, 8,192 and the clustered layout's cap (every kind of
        # shift F splits), bands 20,000, 32,768 and 65,536 (the wide
        # layout), and ways that are not edge-padded past the rows' ends
        import numpy as np
        kt = kernel_tests()
        exact_cases = [kt.exact_inputs(*c) for c in kt.EXACT_CASES] \
            + [kt.exact_shift_inputs(*c) for c in kt.EXACT_WIDE_CASES]
        shifts = kt.exact_shift_inputs(12, 6, 9000, 300, 1000)
        exact_cases.append((*kt.unpad_ways(shifts[:5], 12), shifts[5]))
        exact_bands = [c[-1] for c in kt.EXACT_CASES + kt.EXACT_WIDE_CASES]
        exact_bands.append(1000)
        for (*arrays, ncols), w in zip(exact_cases, exact_bands):
            ef, eg = compare_exact(
                to_dev(arrays), to_dev(kt.exact_bounds(arrays[3], arrays[4],
                                                       w)),
                ncols, w, arrays[1].shape[1])
            errs["exact_fill"] = max(errs["exact_fill"], ef)
            errs["exact_walk"] = max(errs["exact_walk"], eg)
        # the wide layout at the clustered layout's bands
        for (*arrays, ncols), w in zip(exact_cases, exact_bands[:len(
                kt.EXACT_CASES)]):
            ef, _ = compare_exact(
                to_dev(arrays), to_dev(kt.exact_bounds(arrays[3], arrays[4],
                                                       w)),
                ncols, w, arrays[1].shape[1], wide=True)
            errs["exact_fill"] = max(errs["exact_fill"], ef)
        # a row with more inserts than MAX_INSERTS: F + G against the
        # host native engine, and against their plain versions
        from repeatresolver_tpu_torch.ops import banded_realign as br
        heavy, order = kt.insert_heavy_block()
        hcounts = prt.symbol_counts(heavy).astype(np.int32)
        hrows = heavy[order]
        hseqs, hways, hlens = prt.compact_rows(hrows)
        hstarts = kt.exact_bounds(hways, hlens, 64)
        hargs = to_dev((hcounts, hrows, hseqs, hways, hlens))
        ef, eg = compare_exact(hargs, to_dev(hstarts), heavy.shape[1], 64,
                               heavy.shape[1])
        errs["exact_fill"] = max(errs["exact_fill"], ef)
        errs["exact_walk"] = max(errs["exact_walk"], eg)
        got = [x.cpu().numpy() for x in prt.block_dp(
            *hargs, *to_dev(hstarts), heavy.shape[1], bandwidth=64,
            chunk=256, widen=1, staircase=False, kernel="cuda")]
        ref = prt.realign_block_native(native, hcounts, hrows, hseqs, hways,
                                       hlens, 64)
        _same_block_result("a row past MAX_INSERTS, F + G vs the host "
                           "native engine", got, ref, heavy.shape[1])
        if ref[4].max() <= br.MAX_INSERTS:
            raise AssertionError("the insert-heavy block has "
                                 f"{ref[4].max()} inserts a row at most")
        print(f"kernels F and G: {len(exact_cases) + 1} blocks bit-equal "
              f"to their plain versions (bands {sorted(set(exact_bands))}; "
              f"F's wide layout also at bands "
              f"{[c[-1] for c in kt.EXACT_CASES]}, "
              f"shifts past the band, rows of length 0 and 1, padding "
              f"columns, a row ending at the last column, ways not "
              f"edge-padded); a row of {int(ref[4].max())} inserts "
              f"(MAX_INSERTS {br.MAX_INSERTS}) equal to the host native "
              "engine")
        # a band whose one row's codes pass the device memory budget:
        # refused on the card, by block_dp and by the engines when they
        # are made, and no other engine runs it
        from repeatresolver_tpu_torch.models import realigner_device as prd
        from repeatresolver_tpu_torch.ops import cuda_exact as cx
        wide = 4 * cx.MAX_W
        budget = cx.codes_bytes(hseqs.shape[1], wide) - 1
        os.environ["RR_DEVICE_HBM_BUDGET"] = str(budget)
        refusals = [
            lambda: prt.block_dp(*hargs, *to_dev(hstarts), heavy.shape[1],
                                 bandwidth=wide, chunk=256, widen=1,
                                 staircase=False, kernel="cuda"),
            lambda: prd.DeviceResidentRealigner(heavy, bandwidth=wide,
                                                block_rows=8, device=dev),
            lambda: prt.BatchedRealigner(heavy, bandwidth=wide,
                                         block_rows=8, mode="staircase",
                                         kernel="cuda", device=dev)]
        reset_launches()
        try:
            for refuse in refusals:
                try:
                    refuse()
                except ValueError as e:
                    if "device memory budget" not in str(e):
                        raise
                else:
                    raise AssertionError(f"band {wide} was not refused on "
                                         "the card")
        finally:
            del os.environ["RR_DEVICE_HBM_BUDGET"]
        if launches_now()["exact_fill"]:
            raise AssertionError(f"band {wide}: kernel F launched")
        print(f"band {wide}, a row of {hseqs.shape[1]} positions past a "
              f"budget of {budget:,} bytes: refused by block_dp and both "
              "engines on the card, nothing launched")
        # kernels C and D: align's shared target (packed and int8 codes),
        # Lq > Lt, two segments; cut's stride-0 queries against 200-padded
        # per-read targets (final rows), two and three segments
        editdp_batch = kernel_tests().editdp_batch
        for seed, b, lq, lt in ((1, 6, 200, 300), (2, 5, 700, 90),
                                (3, 8, 256, 4000), (4, 4, 120, 33000)):
            (ec, ewd), _ = compare_editdp(*to_dev(editdp_batch(seed, b, lq,
                                                               lt)))
            errs["editdp_fill"] = max(errs["editdp_fill"], ec)
            errs["editdp_walk"] = max(errs["editdp_walk"], ewd)
        for seed, lq, lt in ((5, 66, 33000), (6, 40, 70000)):
            q, _, tg = to_dev(editdp_batch(seed, 8, lq, lt,
                                           per_row_targets=True,
                                           pad_from=lt // 2))
            ql = torch.full((8,), lq, dtype=torch.int32, device=dev)
            (ec, _), _ = compare_editdp(q[:1].expand(8, -1), ql, tg)
            errs["editdp_fill"] = max(errs["editdp_fill"], ec)
        print("edit DP: 4 align batches (final rows, packed and int8 codes, "
              "walks) and 2 cut batches (final rows) bit-equal")

    with phase("3 kernels vs plain, production shape"):
        import numpy as np
        b, l, w, c, t, widen = 64, 32768, 1000, 139264, 128, 6
        rng = np.random.default_rng(0)
        msa = rng.integers(0, 4, (b, c)).astype(np.int8)
        counts = np.stack([(msa == s).sum(axis=0) for s in range(6)],
                          axis=1).astype(np.int32)
        counts[:, 0] += 40
        seqs = rng.integers(0, 4, (b, l)).astype(np.int8)
        ways = np.broadcast_to(np.linspace(0, c - 1, l).astype(np.int32),
                               (b, l)).copy()
        lengths = np.full(b, l, np.int32)
        block = to_dev((counts, msa, seqs, ways, lengths))
        (ea, eb), (ms_a, plain_a, ms_b, plain_b) = compare_block(
            block, c, w, t, widen, c + 64, timed=True)
        errs["staircase_fill"] = max(errs["staircase_fill"], ea)
        errs["walk_backtrack"] = max(errs["walk_backtrack"], eb)
        cells = b * l * w
        times = {"staircase_fill": (ms_a, plain_a),
                 "walk_backtrack": (ms_b, plain_b)}
        bounds = kernel_bounds(b, l, c, w, t, widen, lengths, sm_count,
                               sm_hz)
        for name, (ms, pms) in times.items():
            bms, by, detail = bounds[name]
            print(f"{name}: kernel {ms:.3f} ms ({cells / ms * 1e3:.4g} "
                  f"cells/s; {spread(name)}), plain {pms:.3f} ms "
                  f"({cells / pms * 1e3:.4g} cells/s) on {card}")
            print(f"  bound {bms:.4f} ms by {by} ({bms / ms:.1%} of the "
                  f"kernel's time): {detail}; library call: none (no "
                  "single PyTorch call computes this function)")
        print("bit-equal at 64 x 32768, band 1000, chunk 128, widen 6")
        # kernel A's time at the other window widths of the drift ladder
        # (its bits there are held by the plain versions on the main
        # path's own blocks, phases 5 and 8)
        by_w2 = {}
        for wd in (1, 8, 10, 12, 16):
            kw = dict(bandwidth=w, chunk=t, widen=wd)
            cr.staircase_fill(*block, c, **kw)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(3):
                cr.staircase_fill(*block, c, **kw)
            ev[1].record()
            torch.cuda.synchronize()
            by_w2[w + wd * t] = ev[0].elapsed_time(ev[1]) / 3
        print("kernel A by window width W2: "
              + ", ".join(f"{k} {m:.3f} ms" for k, m in by_w2.items()))

        # kernels C and D at pipeline-615's largest align batch: 256
        # pieces run to Lq 13,700 against the 4,000-base template
        b, lq, lt = 256, 13700, 4000
        q, ql, tt = to_dev(kernel_tests().editdp_batch(1, b, lq, lt))
        # kernel C timed as it was before KERNEL_REPS: one warm-up, then 3
        # runs under one pair of events, while the runs alternate between
        # two output buffers of which the allocator holds one
        def fill_c():
            return ce.editdp_fill(q, ql, tt, codes="packed")
        ms_1w, seg_1w = one_window_ms(fill_c, 3)
        print(f"editdp_fill, one warm-up and 3 runs under one pair of "
              f"events: {ms_1w:.3f} ms a run, {seg_1w} device memory "
              f"segments allocated while timing; SM clock under it "
              f"{sm_mhz_under(fill_c)} MHz")
        (ec, ewd), (ms_c, plain_c, ms_d, plain_d, walked) = compare_editdp(
            q, ql, tt, timed=True)
        errs["editdp_fill"] = max(errs["editdp_fill"], ec)
        errs["editdp_walk"] = max(errs["editdp_walk"], ewd)
        cells = int(ql.sum()) * lt
        times["editdp_fill"] = (ms_c, plain_c)
        times["editdp_walk"] = (ms_d, plain_d)
        bounds.update(editdp_bounds(b, lq, lt, ql.tolist(), walked.tolist(),
                                    sm_count, sm_hz))
        for name in ("editdp_fill", "editdp_walk"):
            ms, pms = times[name]
            bms, by, detail = bounds[name]
            print(f"{name}: kernel {ms:.3f} ms ({cells / ms * 1e3:.4g} "
                  f"cells/s; {spread(name)}), plain {pms:.3f} ms on "
                  f"{card}")
            print(f"  bound {bms:.4f} ms by {by} ({bms / ms:.1%} of the "
                  f"kernel's time): {detail}; library call: none (no "
                  "single PyTorch call computes this function)")
        print(f"bit-equal at {b} x {lq} x {lt} ({cells:.4g} cells; walks of "
              f"{int(walked.max())} steps at most, "
              f"{ms_d * 1e6 / int(walked.max()):.0f} ns a step of the "
              "longest)")
        # the launches alone (events around the launch in the wrapper;
        # the times above include the wrapper's checks and its symbol
        # remap)
        fr_k, packed_k = fill_c()
        kc = launch_ms(fill_c, "editdp_fill")
        kd = launch_ms(lambda: ce.editdp_walk(packed_k, ql, fr_k),
                       "editdp_walk")
        print(f"launches alone (median of {KERNEL_REPS}): editdp_fill "
              f"{kc:.3f} ms ({bounds['editdp_fill'][0] / kc:.1%} of its "
              f"bound), editdp_walk {kd:.3f} ms, on {card}")
        del q, ql, tt, fr_k, packed_k
        # kernel C at cut's shape: 64 reads of up to 25,950 bases against
        # a 66-base template part, queries a stride-0 expand
        q, _, tg = to_dev(kernel_tests().editdp_batch(
            2, 64, 66, 25950, per_row_targets=True, pad_from=13000))
        ql = torch.full((64,), 66, dtype=torch.int32, device=dev)
        (ec, _), (ms_cut, plain_cut, *_) = compare_editdp(
            q[:1].expand(64, -1), ql, tg, timed=True)
        errs["editdp_fill"] = max(errs["editdp_fill"], ec)
        kcut = launch_ms(lambda: ce.editdp_fill(q[:1].expand(64, -1), ql, tg),
                         "editdp_fill")
        print(f"editdp_fill at cut's shape 64 x 66 x 25950 (final rows): "
              f"kernel {ms_cut:.3f} ms ({spread('editdp_fill')}; the "
              f"launch alone {kcut:.3f} ms), plain {plain_cut:.3f} ms on "
              f"{card}; bit-equal")
        del q, ql, tg
        # kernel E at paper width, beside the products it follows
        dz, ms_e, plain_e, bounds["maxcorr_tile"] = maxcorr_group_timed(
            card, dev)
        errs["maxcorr_tile"] = max(errs["maxcorr_tile"], dz)
        times["maxcorr_tile"] = (ms_e, plain_e)

    with phase("4 main path: CLI realign on the tpu_converge dataset"):
        from repeatresolver_tpu_torch import cli
        from repeatresolver_tpu_torch.utils import io as rio
        shutil.rmtree(WORK, ignore_errors=True)
        os.makedirs(WORK)
        t0 = time.perf_counter()
        msa_path = build_dataset(WORK)
        msa = rio.read_msa(msa_path)
        print(f"host stages (simulate, cut, align): "
              f"{time.perf_counter() - t0:.1f} s, MSA {msa.shape}")
        if msa.shape != (131, 85628):
            raise AssertionError(f"MSA shape {msa.shape} != (131, 85628)")
        out_path = os.path.join(WORK, "MSAreal")
        reset_launches()
        reset_tail()
        reset_exact_blocks()
        prd.DeviceResidentRealigner.resident_sweep_s = 0.0
        # record the fill inputs of the first block step at each slack
        # (clones: the resident MSA is rewritten in place) for phase 5;
        # the block step reaches the fill through this stand-in module
        blocks = {}

        def recording_fill(*args, **kw):
            if kw["widen"] not in blocks and len(blocks) < 4:
                blocks[kw["widen"]] = ([a.clone() for a in args[:5]],
                                       args[5], kw)
            return cr.staircase_fill(*args, **kw)

        buf = io.StringIO()
        prd.cr = types.SimpleNamespace(
            **{**vars(cr), "staircase_fill": recording_fill})
        _build.kernel_events = {}
        tail_rec: dict = {}
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf), recording_tail(tail_rec):
                cli.main(["realign", msa_path, "-o", out_path, "-b",
                          "1000", "-B", "64", "--device", "cuda"])
            torch.cuda.synchronize()
        finally:
            prd.cr = cr
            _build.kernel_events = None
        wall = time.perf_counter() - t0
        launches = launches_now()
        scores = [ln.split()[1] for ln in buf.getvalue().splitlines()
                  if ln.startswith("OverallScore:")]
        with open(os.path.join(REPO, "runs", "tpu_converge",
                               "scorelog_tpu")) as f:
            oracle = [ln.split()[1] for ln in f if ln.strip()]
        real = rio.read_msa(out_path)
        bases = int((msa < 4).sum())
        rounds = len(scores) - 2
        cells = rounds * bases * 1000
        print(f"realign: {len(scores)} OverallScore lines, best "
              f"{min(scores)}, {rounds} rounds, wall {wall:.2f} s, "
              f"{cells / wall:.4g} cells/s on {card}")
        ex = exact_blocks()
        tail_n, host_s = prt.BatchedRealigner.sweep_totals()
        print(f"launches {launches}, exact blocks by route {ex}, "
              f"anneal-tail rounds {tail_n}")
        check_exact_routes("CLI realign", ex)
        tail = report_tail("CLI realign", card)
        res_s = prd.DeviceResidentRealigner.resident_sweep_s
        print(f"seconds: resident sweeps {res_s:.2f}, anneal-tail sweeps "
              f"{host_s:.2f}, rest of the loop {wall - res_s - host_s:.2f}")
        # the tail: blocks 16, 4 and 1 on kernels F and G (block 1 the
        # serial sweep over the column store on the card), none on the
        # host
        if sorted(tail.get("cuda", {})) != [1, 4, 16] or set(tail) \
                != {"cuda"}:
            raise AssertionError(f"anneal tail routes {tail}: blocks 16, "
                                 "4 and 1 on kernels F and G, none on the "
                                 "host native engine expected")
        if min(launches["exact_fill"], launches["exact_walk"]) <= 0:
            raise AssertionError(f"kernels F and G never launched in the "
                                 f"tail: {launches}")
        if scores != oracle:
            raise AssertionError(f"score trajectory {scores} != "
                                 f"scorelog_tpu {oracle}")
        prt.validate_counts(real, prt.symbol_counts(real))
        best = min((int(s[:-6] or 0), int(s[-6:])) for s in scores)
        if prt.overall_score_pair(prt.symbol_counts(real)) != best:
            raise AssertionError("MSAreal does not score the best pair")
        for k in range(msa.shape[0]):
            if not np.array_equal(msa[k][msa[k] < 4], real[k][real[k] < 4]):
                raise AssertionError(f"row {k} lost or changed bases")
        if min(launches[k] for k in REALIGN_KERNELS) <= 0:
            raise AssertionError(f"a kernel never launched: {launches}")
        band_launches = wide_band_check(card, msa, errs, 2600)
        reset_launches()
        band4200_launches = wide_band_check(card, msa, errs, 4200)

    with phase("5 kernels vs plain on the main path's own blocks"):
        for widen, (args, ncols, kw) in blocks.items():
            (ea, eb), _ = compare_block(args, ncols, kw["bandwidth"],
                                        kw["chunk"], widen,
                                        args[1].shape[1])
            errs["staircase_fill"] = max(errs["staircase_fill"], ea)
            errs["walk_backtrack"] = max(errs["walk_backtrack"], eb)
            b, lpad = args[2].shape
            print(f"bit-equal: {b} rows x {lpad} bases, MSA width {ncols}"
                  f" of {args[1].shape[1]}, band {kw['bandwidth']}, chunk"
                  f" {kw['chunk']}, widen {widen} "
                  f"(W2 {kw['bandwidth'] + widen * kw['chunk']})")
        if DEFAULT_WIDEN not in blocks:
            raise AssertionError(f"no block step at widen {DEFAULT_WIDEN}"
                                 f" recorded: {sorted(blocks)}")
        # the anneal tail's own blocks through F and G, and its sweeps
        # on the card against the host native engine from the handoff
        tail_sizes = sorted(tail["cuda"], reverse=True)
        replay_tail_blocks(tail_rec, [bs for bs in tail_sizes if bs > 1],
                           errs, "CLI realign")
        serial_replay(tail_rec, 1000, card, dev, "CLI realign")
        tail_routes(tail_rec, tail_sizes, 1000, card, dev, "CLI realign")

    with phase("6 main path: CLI pipeline on the card"):
        pipe_launches = pipeline_phase(card, dev, errs)

    with phase("7 MaxCorrs scan at paper width"):
        scan_launches = paper_scan_phase(card, dev, errs)

    with phase("8 main path: realign at paper width"):
        paper_launches, paper_msa, paper_lines, paper_block = \
            paper_realign_phase(card, dev, errs)

    with phase("9 exact band on the card"):
        forced_launches, exact_times, exact_bounds_ms = exact_band_phase(
            card, dev, paper_block, msa_path, sm_count, sm_hz, errs)
        times.update(exact_times)
        bounds.update(exact_bounds_ms)

    with phase("10 mesh path: two ranks sharing the card over gloo"):
        mesh_launches, striped_launches = mesh_phase(
            card, dev, paper_msa, paper_lines, errs)

    with phase("11 resolve-windows on two processes; graft entry"):
        resolve_windows_phase(card)

    with phase("12 main path: cut and align at paper width on the card"):
        cut_launches = paper_cut_align_phase(card, dev, errs)

    with phase("13 main path: the paper-run driver, resumed after align"):
        driver_launches = paper_driver_phase(card, errs)

    with phase("14 resolve on the card: kernel H and the card route"):
        win_launches, rpaper_launches, times["resolver_pairs"], \
            bounds["resolver_pairs"] = resolve_card_phase(
                card, dev, errs, sm_count, sm_hz)

    # `launches` is the count on the kernel's MAIN_PATH (phase 4 for A
    # and B, as in every earlier report, and for F and G, which run its
    # anneal tail; phase 6 for C, D, E and H); the counts of all thirteen
    # main paths stand in `launches_by_path` (the mesh
    # realign's is one rank's: both ranks launch the same number; the
    # striped MaxCorrs scan's is both ranks')
    maxcorr_only = {name: name == "maxcorr_tile" for name in KERNELS}
    by_path = {name: {"realign_tpu_converge": launches[name],
                      "pipeline_615": pipe_launches[name],
                      "realign_band_2600": band_launches[name],
                      "realign_band_4200": band4200_launches[name],
                      "maxcorr_paper_width_band":
                          scan_launches * maxcorr_only[name],
                      "realign_paper_width": paper_launches[name],
                      "realign_mesh_2_ranks_per_rank": mesh_launches[name],
                      "maxcorr_striped_2_ranks":
                          striped_launches * maxcorr_only[name],
                      "realign_forced_exact": forced_launches[name],
                      "cut_align_paper_width": cut_launches[name],
                      "paper_run_driver": driver_launches[name],
                      "resolve_615_windows": win_launches[name],
                      "resolve_synthetic": rpaper_launches[name]}
               for name in KERNELS}
    report = [dict(name=name, route="cuda", **KERNELS[name],
                   launches=by_path[name][MAIN_PATH[name]],
                   launches_by_path=by_path[name],
                   max_abs_err=errs[name], ms=times[name][0],
                   plain_ms=times[name][1], bound_ms=bounds[name][0],
                   bound_by=bounds[name][1], library_ms=None)
              for name in KERNELS]
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
