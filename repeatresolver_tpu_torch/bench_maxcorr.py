"""Time the MaxCorrs device scan at paper width on the card.

    python -m repeatresolver_tpu_torch.bench_maxcorr [--band-tiles 8]

Run from a checkout's root on a machine with a GPU; the counterpart of
scripts/maxcorr_tall_bench.py. The input is chip_smoke.py's phase 7
synthetic MSA (13,833 rows x 131,072 columns, seed 0). Two runs of
`models/maxcorr.MaxCorrScan` (tile 256):

  * the full device scan, all 512 seed tiles: seconds (host clock, up to
    a device sync), tile pairs scanned and needed, host reads, and the
    ms a pair inside the four int8 products and inside kernel E (CUDA
    events around every launch), peak device memory;
  * the host check: the band of --band-tiles seed tiles in the middle
    scanned on the card and held to the native host scan by
    chip_smoke.host_band_check, phase 7's check (identical decisions at
    the MaxCorrs cutoff; rtol 2e-3, atol 5e-3 where significant). A full
    host scan at this size takes over half an hour.

Prints the card's name and power limit, the lines of both runs, then
one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from .bench_editdp import _chip_smoke


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

    secs, st, inside = smoke.timed_scan(sc, range(sc.nt))
    pairs = max(st["tile_pairs"], 1)
    full = dict(seconds=secs, build_s=build_s, **st,
                products_ms_a_pair=inside.get("maxcorr_products", 0.0)
                / pairs,
                kernel_e_ms_a_pair=inside.get("maxcorr_tile", 0.0) / pairs,
                host_clock_ms_a_pair=secs / pairs * 1e3,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"full device scan of {sc.nt} seed tiles on {card}: {secs:.2f} s "
          f"(one-hot build {build_s:.2f} s before it), {st['tile_pairs']} "
          f"tile pairs scanned, {st['tile_pairs_needed']} needed, "
          f"{st['host_reads']} host reads; a pair {secs / pairs * 1e3:.4f} "
          f"ms (host clock), inside the products "
          f"{full['products_ms_a_pair']:.4f} ms and kernel E "
          f"{full['kernel_e_ms_a_pair']:.4f} ms (CUDA events); peak "
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
    print(json.dumps({"card": card, "full_scan": full, "band_check":
                      band_rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
