#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py          # from the repository root; one GPU

Phases (each raises on failure, or when jax or any module of the JAX
package repeatresolver_tpu was imported, so any failure exits non-zero):

  1. card and build: the card's name, power limit and SM clock, torch /
     CUDA versions, the nvcc build of the four kernels from csrc/ (one
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
  4. the main path: the runs/tpu_converge dataset (Tree, c=25, n=8,
     d=1%, l=4000, seed 11) built with the port's host stages, then the
     port's CLI `realign -b 1000 -B 64 --device cuda`. Its OverallScore
     sequence must equal column 2 of runs/tpu_converge/scorelog_tpu (all
     24 lines; the JAX package's trajectory, identical on TPU and CPU),
     and both kernels must have launched. Then the same MSA at band 2600
     (block 64, 2 rounds), past kernel A's 4,096-lane window at the
     default slack: the resident engine on the card must equal the
     port's host native exact engine line for line, with both kernels
     launched (counts set to 0 just before that run), and the first
     block step at each slack it ran (W2 up to 3,880) goes through both
     kernels and their plain versions, bit-equal;
  5. kernels vs plain versions on the main path's own blocks: the fill
     inputs of the first block step at each slack (widen 12 first)
     recorded during phase 4, replayed through both kernels and their
     plain versions, bit-equal;
  6. the whole pipeline: the port's CLI `pipeline -c 40 -n 24 -d 1 -l
     4000 -t Tree --seed 11 -b 1000 -B 64 --device cuda` (615 MSA rows,
     so the MaxCorrs device scan's >= 512-row gate routes it to the
     card), with every resolver product sent to the card
     (RR_DEVICE_MM_MIN=0). The edit DP of cut and align (kernels C and
     D), kernels A and B, the MaxCorrs scan and the resolver products
     must each have run on the card, and the plain edit-DP loop not at
     all; cut and align must write the host native route's files byte
     for byte, MaxCorrs must make the host fast scan's decisions (within
     its tolerances), and one window's subdivisions must equal, byte for
     byte, a rerun with every product on the host. Prints each stage's
     seconds, each kernel's launches and seconds inside it (CUDA events)
     and the assessment;
  7. the MaxCorrs device scan at the paper run's size: a synthetic MSA
     of 13,833 rows x 131,072 columns from seed 0, a band of seed tiles
     scanned on the card and by the native host scan, same decisions
     within the same tolerances, with both times;
  8. the realign main path at the paper's repeat length: a Tree dataset
     with -l 30000 -d 1 (coverage 12, 8 copies: an MSA of 328 rows,
     more than three blocks of 64) built with the port's host stages,
     then `realign_batched` on the card, band 1000, block 64, capped at
     8 rounds so that only resident rounds run. Prints rows x columns,
     rounds, launches, the seconds in resident sweeps and, from CUDA
     events around both kernels' launches, the seconds inside kernel A,
     inside kernel B and in the rest of the sweeps (torch ops and the
     per-block host read). The score after every round must equal the
     same capped run at the same block size through the host native
     engine (exact band, independent of both kernels; RR_FLUSH_CAP high
     so that both flush once a sweep), and the first block's recorded
     inputs go through both kernels and their plain versions, bit-equal;
  9. the exact band on the card: phase 8's first block (64 rows, band
     1000) through the torch exact band (ops/banded_realign:
     banded_fill + entry_and_backtrack) on CUDA tensors; rows, best and
     insert lists bit-equal to the kernels' result for the same block
     and to the host native engine's, with the seconds of each. Then
     the resident engine on phase 4's MSA with the host library made
     unavailable to its exact blocks and every block forced onto the
     exact route (an insert fetch of one slot): the torch route must
     have run, counted apart from the native one, and the score after
     each sweep must equal the native route's;
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
     bit-equal. Then the MaxCorrs scan
     of phase 6's MSAreal striped over the two ranks: equal to phase
     6's single scan, tolerance 0;
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
     Kernels A-D must each have launched, the plain edit-DP loop not at
     all.

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
}
# the path whose launches stand in a kernel's `launches`
MAIN_PATH = {"staircase_fill": "realign_tpu_converge",
             "walk_backtrack": "realign_tpu_converge",
             "editdp_fill": "pipeline_615", "editdp_walk": "pipeline_615"}
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
    from repeatresolver_tpu_torch.ops import cuda_realign as cr
    return {"staircase_fill": cr.staircase_fill,
            "walk_backtrack": cb.backtrack_moves,
            "editdp_fill": ce.editdp_fill, "editdp_walk": ce.editdp_walk}


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


def wide_band_check(card, msa, errs):
    """Phase 4's second run: the tpu_converge MSA at band 2600, block 64,
    2 rounds, where the default slack's window (2600 + 12 x 128) passes
    kernel A's 4,096 lanes: the resident engine on the card (slack capped
    at rung 10, blocks that no fitting rung covers on the exact band)
    against the port's host native exact engine at the same block size,
    line for line. RR_FLUSH_CAP is raised for both runs so that both
    splice once a sweep, as the engines' oracle needs. The first block
    step at each slack is recorded and replayed through kernels A and B
    and their plain versions, bit-equal, at this path's own windows.
    Returns the kernels' launches in the run on the card."""
    import numpy as np

    from repeatresolver_tpu_torch.config import RealignerConfig
    from repeatresolver_tpu_torch.models import realigner as prt
    from repeatresolver_tpu_torch.models import realigner_device as prd
    from repeatresolver_tpu_torch.ops import cuda_realign as cr
    cfg = RealignerConfig(bandwidth=2600, block_rows=64, max_rounds=2)
    blocks = {}

    def recording_fill(*args, **kw):
        if kw["widen"] not in blocks:
            blocks[kw["widen"]] = ([a.clone() for a in args[:5]], args[5],
                                   kw)
        return cr.staircase_fill(*args, **kw)

    ex0 = exact_blocks()
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
        prd.cr = cr
        log_h: list = []
        out_h = prt.realign_batched(msa.copy(), cfg, score_log=log_h,
                                    mode="exact", kernel="native",
                                    device="cpu")
        t2 = time.perf_counter()
    finally:
        prd.cr = cr
        del os.environ["RR_FLUSH_CAP"]
    ex1 = exact_blocks()
    print(f"band 2600: {len(log_d)} score lines, {log_d[-1]}; resident "
          f"engine on {card} {t1 - t0:.2f} s (launches {launches}, "
          f"{ex1[0] - ex0[0]} exact blocks through the host library), "
          f"host native exact engine {t2 - t1:.2f} s")
    if log_d != log_h or not np.array_equal(out_d, out_h):
        raise AssertionError(f"band 2600: resident {log_d} != host native "
                             f"exact {log_h}")
    if min(launches[k] for k in REALIGN_KERNELS) <= 0:
        raise AssertionError(f"band 2600: a kernel never launched: "
                             f"{launches}")
    replay_blocks(blocks, errs, "band 2600")
    return launches


def exact_blocks():
    """The resident engine's exact blocks so far, by route: (through the
    host library, through the torch exact band)."""
    from repeatresolver_tpu_torch.models.realigner_device import \
        DeviceResidentRealigner as eng
    return eng.exact_blocks_run, eng.exact_blocks_run_torch


def reset_exact_blocks():
    from repeatresolver_tpu_torch.models.realigner_device import \
        DeviceResidentRealigner as eng
    eng.exact_blocks_run = eng.exact_blocks_run_torch = 0


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


def pipeline_phase(card, dev):
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
    from repeatresolver_tpu_torch.ops import devmm
    from repeatresolver_tpu_torch.ops import editdp
    from repeatresolver_tpu_torch.utils import io as rio

    pdir = os.path.join(WORK, "pipeline")
    hdir = os.path.join(WORK, "pipeline_host")
    os.makedirs(hdir)
    counters = [(fn, "launches") for fn in launch_counters().values()] + [
        (editdp.last_rows, "calls"), (editdp.align_on_device, "calls"),
        (pmc.compute_maxcorrs_device, "calls"),
        (devmm.matmul_t, "device_calls")]
    plain = (editdp.forward_plain, editdp.walk_plain)
    for fn, attr in counters + [(fn, "calls") for fn in plain]:
        setattr(fn, attr, 0)
    reset_exact_blocks()
    # every resolver product to the card: at 615 rows no product reaches
    # the JAX package's 3e9-op gate
    os.environ["RR_DEVICE_MM_MIN"] = "0"
    out = TimedLines()
    _build.kernel_events = {}
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
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
    print(f"device routes fired in the pipeline run: {fired}; "
          f"exact-fallback blocks (host library, torch exact band) "
          f"{exact_blocks()}")
    print("stage seconds (host clock, on " + card + "): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stage_s.items())
          + f"; total {t_prev - t0:.2f}")
    print("seconds inside the kernels (CUDA events around every launch): "
          + ", ".join(f"{k} {in_kernel.get(k, 0.0):.3f} ({n} launches)"
                      for k, n in launches.items())
          + f"; plain edit-DP loop runs (forward_plain, walk_plain) "
          f"{plain_runs}")
    if min(fired.values()) <= 0:
        raise AssertionError(f"a device route never ran: {fired}")
    if any(plain_runs):
        raise AssertionError(f"the plain edit-DP loop ran on the card: "
                             f"{plain_runs}")
    real_path = os.path.join(pdir, PIPE_NAME + "_MSAreal")
    real = rio.read_msa(real_path)
    print(f"MSAreal {real.shape}")
    if real.shape[0] < 512:
        raise AssertionError(f"{real.shape[0]} MSA rows: below the "
                             "MaxCorrs device gate of 512")

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


def paper_scan_phase(card, dev):
    """Phase 7."""
    import numpy as np
    import torch

    from repeatresolver_tpu_torch.config import MaxCorrConfig
    from repeatresolver_tpu_torch.models import maxcorr as pmc
    from repeatresolver_tpu_torch.utils import native

    t0 = time.perf_counter()
    msa = synthetic_msa(PAPER_ROWS, PAPER_COLS)
    print(f"synthetic MSA {msa.shape} in {time.perf_counter() - t0:.1f} s")
    cfg = MaxCorrConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sc = pmc.MaxCorrScan(msa, cfg, 256, dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    k0 = sc.nt // 2 - PAPER_BAND_TILES // 2
    band = range(k0, k0 + PAPER_BAND_TILES)
    t0 = time.perf_counter()
    acc = sc.scan(band)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    mc_d = acc[:PAPER_COLS * 5].cpu().numpy().astype(np.float64)
    peak = torch.cuda.max_memory_allocated() / 2**30
    i0, i1 = band.start * 256, band.stop * 256
    t0 = time.perf_counter()
    bits = native.MaxCorrBitsets(msa)
    t_bits = time.perf_counter() - t0
    mc_h = np.zeros(PAPER_COLS * 5, np.float64)
    t0 = time.perf_counter()
    bits.scan(mc_h, i0, i1, cfg.mincov, cfg.min_col_gap, PAPER_ROWS,
              cfg.majority_filter, True, os.cpu_count() or 1)
    t_host = time.perf_counter() - t0
    cutoff = cfg.resolved_cutoff(PAPER_COLS)
    sig = mc_h > cutoff
    if not np.array_equal(mc_d > cutoff, sig):
        raise AssertionError(f"decisions differ: "
                             f"{int(((mc_d > cutoff) != sig).sum())}")
    np.testing.assert_allclose(mc_d[sig], mc_h[sig], rtol=2e-3, atol=5e-3)
    dz = np.abs(mc_d - mc_h)
    print(f"seed columns [{i0}, {i1}) ({PAPER_BAND_TILES} tiles of 256): "
          f"{sc.tile_pairs} tile pairs, {int(sig.sum())} significant, "
          f"decisions identical, max|dZ| {dz[sig].max() if sig.any() else 0:.3g}"
          f" significant, {dz.max():.3g} overall")
    print(f"device: one-hot build {t_build:.2f} s, band {t_dev:.2f} s, "
          f"{t_dev / max(sc.tile_pairs, 1) * 1e3:.3f} ms per tile pair, "
          f"peak {peak:.2f} GiB; host native scan {t_host:.2f} s "
          f"({os.cpu_count()} threads; bitsets {t_bits:.1f} s) on {card}")
    if sig.sum() == 0:
        raise AssertionError("no significant MaxCorrs in the band")


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
        prt.BatchedRealigner.host_sweeps = 0
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
        if prt.BatchedRealigner.host_sweeps:
            raise AssertionError(
                f"{prt.BatchedRealigner.host_sweeps} rounds left the "
                "resident engine: the cap must hold the run at block 64")
        if min(launches[k] for k in REALIGN_KERNELS) <= 0:
            raise AssertionError(f"a kernel never launched: {launches}")
        sa = in_kernel.get("staircase_fill", 0.0)
        sb = in_kernel.get("walk_backtrack", 0.0)
        print(f"realign_batched on {card}: {PAPER_ROUNDS} rounds at block "
              f"64, wall {wall:.2f} s, "
              f"{PAPER_ROUNDS * bases * 1000 / wall:.4g} cells/s; launches "
              f"{launches}, exact-fallback blocks (host library, torch "
              f"exact band) {exact_blocks()}")
        print(f"resident sweeps {res_s:.3f} s: inside kernel A {sa:.3f} s "
              f"({sa / launches['staircase_fill'] * 1e3:.3f} ms a launch), "
              f"inside kernel B {sb:.3f} s "
              f"({sb / launches['walk_backtrack'] * 1e3:.3f} ms a launch), "
              f"rest (torch ops, per-block host read) "
              f"{res_s - sa - sb:.3f} s")

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


def exact_band_phase(card, dev, block, converge_msa_path):
    """Phase 9."""
    import numpy as np
    import torch

    from repeatresolver_tpu_torch.models import realigner as prt
    from repeatresolver_tpu_torch.models import realigner_device as prd
    from repeatresolver_tpu_torch.ops import banded_realign as br
    from repeatresolver_tpu_torch.utils import io as rio
    from repeatresolver_tpu_torch.utils import native

    args, ncols, kw = block
    counts, rows_old, seqs, ways, lengths = args
    w, t, widen = kw["bandwidth"], kw["chunk"], kw["widen"]
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

    common = dict(bandwidth=w, chunk=t, widen=widen)
    prt.block_dp(*args, *starts(True), ncols, staircase=True, kernel="cuda",
                 **common)               # warm-up
    out_k, s_k = timed(lambda: prt.block_dp(
        *args, *starts(True), ncols, staircase=True, kernel="cuda",
        **common))
    anf, eb = starts(False)
    torch.cuda.reset_peak_memory_stats()
    fill, s_fill = timed(lambda: br.banded_fill(*args, ncols, bandwidth=w))
    out_t, s_bt = timed(lambda: br.entry_and_backtrack(
        *fill, seqs, anf, eb, lengths, ncols, cpad=rows_old.shape[1],
        bandwidth=w))
    peak = torch.cuda.max_memory_allocated() / 2**30
    del fill
    t0 = time.perf_counter()
    out_n = prt.realign_block_native(
        native, counts[:ncols].cpu().numpy(),
        np.ascontiguousarray(rows_old[:, :ncols].cpu().numpy()),
        seqs.cpu().numpy(), ways_h, len_h, w)
    s_n = time.perf_counter() - t0
    out_k = [x.cpu().numpy() for x in out_k]
    out_t = [x.cpu().numpy() for x in out_t]
    _same_block_result("torch exact band vs kernels A + B", out_t, out_k,
                       ncols)
    _same_block_result("torch exact band vs host native engine", out_t,
                       out_n, ncols)
    b, lpad = seqs.shape
    print(f"block of {b} rows x {lpad} bases (longest {int(len_h.max())}), "
          f"band {w}, MSA width {ncols}: rows, best and "
          f"{int(out_t[4].sum())} inserts bit-equal between the torch exact "
          f"band, kernels A + B and the host native engine")
    print(f"seconds for the block on {card}: torch exact band "
          f"{s_fill + s_bt:.2f} (banded_fill {s_fill:.2f}, "
          f"entry_and_backtrack {s_bt:.2f}; peak {peak:.2f} GiB), kernels "
          f"A + B with their torch ops {s_k:.4f}, host native engine "
          f"{s_n:.2f} ({os.cpu_count()} threads)")

    # the resident engine's exact blocks without the host library
    msa = rio.read_msa(converge_msa_path)
    cls = prd.DeviceResidentRealigner

    def resident_run():
        eng = cls(msa, bandwidth=1000, block_rows=64, device=dev)
        eng._maxf = 1                    # every insert list overflows
        eng.ent_al_gapper()
        log = [eng.overall_pair()]
        for _ in range(2):
            eng.sweep()
            log.append(eng.overall_pair())
        return log, eng._overflow_events

    cls.exact_blocks_run = cls.exact_blocks_run_torch = 0
    (log_n, overflows), s_native = timed(resident_run)
    native_blocks = (cls.exact_blocks_run, cls.exact_blocks_run_torch)

    def no_library():
        raise native.NativeBuildError(
            "native host library: made unavailable")

    prd._native = no_library
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            (log_t, _), s_torch = timed(resident_run)
    finally:
        prd._native = prt._native
    said = [str(c.message) for c in caught
            if "torch exact band" in str(c.message)]
    if len(said) != 1:
        raise AssertionError("the degrade route must warn once an engine: "
                             f"{said}")
    print(f"  warning of the degrade route: {said[0]}")
    torch_blocks = (cls.exact_blocks_run - native_blocks[0],
                    cls.exact_blocks_run_torch)
    print(f"resident engine, 2 sweeps at block 64 on MSA {msa.shape}, "
          f"{overflows} insert-fetch overflows: exact blocks (native, "
          f"torch) {native_blocks} in {s_native:.2f} s with the host "
          f"library, {torch_blocks} in {s_torch:.2f} s without it, on "
          f"{card}")
    for m, u in log_t:
        print(f"  OverallScore: {m}{u:06d}")
    if native_blocks[0] <= 0 or native_blocks[1] != 0 \
            or torch_blocks != (0, native_blocks[0]):
        raise AssertionError("the exact route's two implementations were "
                             f"not counted apart: {native_blocks}, "
                             f"{torch_blocks}")
    if log_t != log_n:
        raise AssertionError(f"torch exact route {log_t} != native exact "
                             f"route {log_n}")


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
        sweep_s=prt.BatchedRealigner.host_sweep_s,
        sweeps=prt.BatchedRealigner.host_sweeps,
        launches=launches, kernel_s=in_kernel, collective_s=coll["s"],
        collectives=coll["calls"], staged=mesh.staged,
        built_here=sorted(_build.build_info))
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
    t0 = time.perf_counter()
    mc = pmc.compute_maxcorrs_device(real, MaxCorrConfig(), mesh=mesh)
    report["maxcorr_s"] = time.perf_counter() - t0
    report["maxcorr_collective_s"] = coll["s"]
    np.save(os.path.join(outdir, f"maxcorrs_rank{rank}.npy"), mc)
    _no_foreign_modules()
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def mesh_phase(card, dev, msa_path, paper_lines, errs):
    """Phase 10; returns a rank's launches of each kernel (every rank
    must count the same)."""
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
    print(f"MaxCorrs striped over 2 ranks == the single device scan "
          f"(tolerance 0, {len(ref)} values, {int((ref > 0).sum())} "
          f"nonzero): {reports[0]['maxcorr_s']:.2f} / "
          f"{reports[1]['maxcorr_s']:.2f} s a rank, of it the max-merge "
          f"{reports[0]['maxcorr_collective_s']:.3f} s, on {card}")
    return reports[0]["launches"]


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
from repeatresolver_tpu_torch.ops import cuda_backtrack as cb
from repeatresolver_tpu_torch.ops import cuda_editdp as ce
from repeatresolver_tpu_torch.ops import cuda_realign as cr
from repeatresolver_tpu_torch.ops import editdp
counters = dict(staircase_fill=cr.staircase_fill,
                walk_backtrack=cb.backtrack_moves,
                editdp_fill=ce.editdp_fill, editdp_walk=ce.editdp_walk)
plain = (editdp.forward_plain, editdp.walk_plain)
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
        raise AssertionError(f"{what}: the plain edit-DP loop ran "
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
    dead = [k for k in KERNELS if not straight[k]]
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
        prt.BatchedRealigner.host_sweeps = 0
        prt.BatchedRealigner.host_sweep_s = 0.0
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
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                cli.main(["realign", msa_path, "-o", out_path, "-b",
                          "1000", "-B", "64", "--device", "cuda"])
            torch.cuda.synchronize()
        finally:
            prd.cr = cr
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
        print(f"launches {launches}, exact-fallback blocks (host library, "
              f"torch exact band) {exact_blocks()}, host "
              f"anneal-tail rounds {prt.BatchedRealigner.host_sweeps}")
        res_s = prd.DeviceResidentRealigner.resident_sweep_s
        host_s = prt.BatchedRealigner.host_sweep_s
        print(f"seconds: resident sweeps {res_s:.2f}, host anneal-tail "
              f"sweeps {host_s:.2f}, rest of the loop "
              f"{wall - res_s - host_s:.2f}")
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
        band_launches = wide_band_check(card, msa, errs)

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

    with phase("6 main path: CLI pipeline on the card"):
        pipe_launches = pipeline_phase(card, dev)

    with phase("7 MaxCorrs scan at paper width"):
        paper_scan_phase(card, dev)

    with phase("8 main path: realign at paper width"):
        paper_launches, paper_msa, paper_lines, paper_block = \
            paper_realign_phase(card, dev, errs)

    with phase("9 exact band on the card"):
        exact_band_phase(card, dev, paper_block, msa_path)

    with phase("10 mesh path: two ranks sharing the card over gloo"):
        mesh_launches = mesh_phase(card, dev, paper_msa, paper_lines,
                                    errs)

    with phase("11 resolve-windows on two processes; graft entry"):
        resolve_windows_phase(card)

    with phase("12 main path: cut and align at paper width on the card"):
        cut_launches = paper_cut_align_phase(card, dev, errs)

    with phase("13 main path: the paper-run driver, resumed after align"):
        driver_launches = paper_driver_phase(card, errs)

    # `launches` is the count on the kernel's MAIN_PATH (phase 4 for A
    # and B, as in every earlier report; phase 6 for C and D); the counts
    # of all seven main paths stand in `launches_by_path` (the mesh path's
    # is one rank's: both ranks launch the same number)
    by_path = {name: {"realign_tpu_converge": launches[name],
                      "pipeline_615": pipe_launches[name],
                      "realign_band_2600": band_launches[name],
                      "realign_paper_width": paper_launches[name],
                      "realign_mesh_2_ranks_per_rank": mesh_launches[name],
                      "cut_align_paper_width": cut_launches[name],
                      "paper_run_driver": driver_launches[name]}
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
