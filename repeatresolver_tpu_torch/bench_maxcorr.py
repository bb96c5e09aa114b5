"""Time the MaxCorrs device scan at paper width on the card.

    python -m repeatresolver_tpu_torch.bench_maxcorr [--band-tiles 8]

Run from a checkout's root on a machine with a GPU; the counterpart of
scripts/maxcorr_tall_bench.py. The input is chip_smoke.py's phase 7
synthetic MSA (13,833 rows x 131,072 columns, seed 0). Three runs of
`models/maxcorr.MaxCorrScan` (tile 256, groups of 8 partner tiles):

  * the variant probe: kernel E on one group (the middle seed tile
    against the 8 partner tiles from its diagonal, every seed alive), as
    csrc/maxcorr_tile.cu stands and as variants built here from the same
    source with lines replaced (VARIANTS) into build/kernels/probe/, all
    timed queued (chip_smoke.queued_ms): the log-factorial table staged
    in shared memory by every CTA of the second pass (held bit-equal to
    E), and E cut short to show where its time goes (the cut and the
    alive seeds alone; both passes without the relevant pairs' Z);
  * the full device scan, all 512 seed tiles: seconds (host clock, up to
    a device sync), tile pairs scanned and needed, host reads, groups,
    and the ms a group and a pair inside the group's int8 product and
    inside kernel E (CUDA events around every call), peak device memory;
  * the host check: the band of --band-tiles seed tiles in the middle
    scanned on the card and held to the native host scan by
    chip_smoke.host_band_check, phase 7's check (identical decisions at
    the MaxCorrs cutoff; rtol 2e-3, atol 5e-3 where significant). A full
    host scan at this size takes over half an hour.

Prints the card's name and power limit, the lines of the runs, then one
JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

from .bench_editdp import _chip_smoke

# variants of csrc/maxcorr_tile.cu for the probe: each line replaced (it
# must stand once in the source); the first gives E's result, the others
# stop early
VARIANTS = {
    "shared_table": {
        "  const float2* tab = lf;\n":
            "  extern __shared__ float2 s_lf[];\n"
            "  for (int x = tid; x <= nmax; x += THREADS) s_lf[x] = lf[x];\n"
            "  __syncthreads();\n"
            "  const float2* tab = s_lf;\n",
        "  group_z_kernel<<<grid, THREADS, 0, s>>>(\n":
            "  cudaFuncSetAttribute(\n"
            "      group_z_kernel,\n"
            "      cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
            "      (nmax + 1) * (int)sizeof(float2));\n"
            "  group_z_kernel<<<grid, THREADS, (nmax + 1) * sizeof(float2), "
            "s>>>(\n"},
    # the first pass, and the second up to its cut and alive seeds
    "cut_only": {"  if (lo >= hi || sok == 0) return;\n": "  return;\n"},
    # both passes up to the compacted list of relevant pairs
    "without_z": {"  if (total == 0) return;\n": "  return;\n"},
}


def _variant_libs():
    """{name: library} of VARIANTS, built from the checkout's source (one
    nvcc each, started together) and bound as _build binds E."""
    from .ops import _build
    src = open(os.path.join(_build.CSRC, "maxcorr_tile.cu")).read()
    out = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, lines in VARIANTS.items():
        text = src
        for old, new in lines.items():
            if text.count(old) != 1:
                raise AssertionError(f"variant {name}: {old.strip()!r} does "
                                     "not stand once in csrc/maxcorr_tile.cu")
            text = text.replace(old, new)
        cu = os.path.join(out, f"maxcorr_tile_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out, f"libmaxcorr_tile_{name}.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.maxcorr_tile_launch.argtypes = _build._SIGNATURES["maxcorr_tile"]
        lib.maxcorr_tile_launch.restype = ctypes.c_int
        lib.maxcorr_tile_error_string.argtypes = [ctypes.c_int]
        lib.maxcorr_tile_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def variant_probe(smoke, sc, card, reps=20):
    """Kernel E and its VARIANTS on one group (module docstring): {name:
    ms a group}; the shared-memory table bit-equal to E."""
    import torch

    from .ops import _build, cuda_maxcorr
    t, m = sc.t, sc.group
    i0 = j0 = (sc.nt // 2) * t
    schnitt = sc.product(i0, j0, m)
    alive = sc.seed_ok[i0:i0 + t].any(dim=1)
    kw = dict(gap=sc.gap, ncols=sc.c, mincov=sc.mincov)
    libs = {"kernel_e": _build.load("maxcorr_tile"), **_variant_libs()}
    ms, outs = {}, {}
    try:
        for name, lib in libs.items():
            _build._libs["maxcorr_tile"] = lib
            out = torch.empty((m, t), dtype=torch.bool, device=alive.device)
            acc = torch.zeros_like(sc.acc)
            cuda_maxcorr.maxcorr_group(schnitt, alive, out, sc.seed_ok,
                                       sc.partner_ok, sc.sizes, sc.lf, acc,
                                       i0, j0, **kw)
            outs[name] = (out.clone(), acc.clone())
            ms[name] = smoke.queued_ms(
                lambda: cuda_maxcorr.maxcorr_group(
                    schnitt, alive, out, sc.seed_ok, sc.partner_ok,
                    sc.sizes, sc.lf, acc, i0, j0, **kw), reps)
    finally:
        _build._libs["maxcorr_tile"] = libs["kernel_e"]
    if not all(torch.equal(a, b) for a, b in zip(outs["kernel_e"],
                                                 outs["shared_table"])):
        raise AssertionError("variant probe: the shared-memory table "
                             "changed E's result")
    print(f"kernel E on the group of seed columns [{i0}, {i0 + t}) x "
          f"[{j0}, {j0 + m * t}), {sc.r} rows (table {sc.lf.shape[0] * 8} "
          f"bytes), ms a group ({reps} queued back to back) on {card}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
          + " (shared_table bit-equal to kernel_e)")
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--band-tiles", type=int, default=8)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bench_maxcorr: torch sees no CUDA device", file=sys.stderr)
        return 2
    from .config import MaxCorrConfig
    from .models import maxcorr as pmc
    smoke = _chip_smoke()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    msa = smoke.synthetic_msa(smoke.PAPER_ROWS, smoke.PAPER_COLS)
    cfg = MaxCorrConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sc = pmc.MaxCorrScan(msa, cfg, 256, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    probe = variant_probe(smoke, sc, card)

    secs, st, inside = smoke.timed_scan(sc, range(sc.nt))
    pairs = max(st["tile_pairs"], 1)
    groups = max(st["groups_queued"], 1)
    prod_ms = inside.get("maxcorr_products", 0.0)
    e_ms = inside.get("maxcorr_tile", 0.0)
    full = dict(seconds=secs, build_s=build_s, **st,
                products_ms_a_pair=prod_ms / pairs,
                products_ms_a_group=prod_ms / groups,
                kernel_e_ms_a_pair=e_ms / pairs,
                kernel_e_ms_a_group=e_ms / groups,
                host_clock_ms_a_pair=secs / pairs * 1e3,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"full device scan of {sc.nt} seed tiles on {card}: {secs:.2f} s "
          f"(one-hot build {build_s:.2f} s before it), {st['tile_pairs']} "
          f"tile pairs scanned, {st['tile_pairs_needed']} needed, "
          f"{st['host_reads']} host reads, {st['groups_queued']} groups "
          f"({st['product_launches']} products); a pair "
          f"{secs / pairs * 1e3:.4f} ms (host clock), inside the product "
          f"{full['products_ms_a_pair']:.4f} ms and kernel E "
          f"{full['kernel_e_ms_a_pair']:.4f} ms (a group "
          f"{full['products_ms_a_group']:.4f} and "
          f"{full['kernel_e_ms_a_group']:.4f} ms; CUDA events); peak "
          f"{full['peak_gib']:.2f} GiB")

    k0 = sc.nt // 2 - args.band_tiles // 2
    band = range(k0, k0 + args.band_tiles)
    bsecs, bst, _ = smoke.timed_scan(sc, band)
    mc_d = sc.acc[:msa.shape[1] * 5].cpu().numpy().astype(np.float64)
    band_rec = dict(smoke.host_band_check(msa, cfg, band, sc.t, mc_d),
                    device_s=bsecs, **bst)
    print(f"band of seed tiles [{band.start}, {band.stop}): device "
          f"{bsecs:.3f} s ({bst['tile_pairs']} tile pairs), host native "
          f"scan {band_rec['host_s']:.2f} s on {band_rec['threads']} "
          f"threads (bitsets {band_rec['bitsets_s']:.1f} s); "
          f"{band_rec['significant']} significant, decisions identical, "
          f"max|dZ| {band_rec['max_dz_significant']:.3g} significant")
    print(json.dumps({"card": card, "variant_probe_ms": probe,
                      "full_scan": full, "band_check": band_rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
