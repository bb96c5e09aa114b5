"""A tiny copy of the benchmark's registry for CPU runs: the real
traffic drivers and metric readers over small configurations (a 3,000
base repeat, band 200) and cells."""
from __future__ import annotations

import argparse
import json
import os
import shutil

from bench_port.registry import HERE, Registry

SMALL = dict(repeatlength=3000, flank=500, coverage=6, bandwidth=200)
PARAMS = {
    "realign-tail.tree-1pct-30k": dict(copies=2, serial_rows=3,
                                       warm_rows=6),
    "realign-resident.distributed-1pct-30k": dict(
        copies=4, block_rows=8, sample=4, warm_rows=12, rounds=3),
    "maxcorr-scan.tree-1pct-30k": dict(copies=8, sample=6),
}


def tiny_registry(tmp) -> Registry:
    root = os.path.join(tmp, "bench")
    for d in ("traffic", "metrics"):
        shutil.copytree(os.path.join(HERE, d), os.path.join(root, d))
    os.makedirs(os.path.join(root, "configs"))
    os.makedirs(os.path.join(root, "workloads"))
    for f in os.listdir(os.path.join(HERE, "configs")):
        with open(os.path.join(HERE, "configs", f)) as fh:
            c = json.load(fh)
        c.update(SMALL)
        with open(os.path.join(root, "configs", f), "w") as fh:
            json.dump(c, fh)
    for cell, p in PARAMS.items():
        with open(os.path.join(HERE, "workloads", cell + ".json")) as fh:
            w = json.load(fh)
        w["params"].update(p)
        with open(os.path.join(root, "workloads", cell + ".json"),
                  "w") as fh:
            json.dump(w, fh)
    return Registry(root=root)


def args(cell, seed=2 ** 31 + 77, trace=0, control=0):
    return argparse.Namespace(workload=cell, seed=seed, seconds=0.1,
                              trace=trace, control=control)
