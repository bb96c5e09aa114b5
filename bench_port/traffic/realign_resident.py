"""Traffic kind `realign_resident`: realign's resident sweeps, job after
job.

A job is `realign_batched(msa0, RealignerConfig(bandwidth, block_rows,
max_rounds=rounds), anneal=False)` from the cell's generated MSA, at
the program's defaults: at block 64 on a CUDA device the resident
engine (the MSA on the card; kernels A and B a block, the block step's
torch ops, exact blocks on F and G, the sweep-end regather). A job's
work is its DP cells (`stats["dp_cells"]`).

The check (after the window, on the last job): its rows hold their
reads' bases; its score is the program's; every job gave the same
output; and `sample` rows (drawn from the seed) of the first block and
of a later block (drawn from the seed), placed by the reference, sit
where the program put them (`ref.compare`), in the job's first round
and in the round whose state the job returns (its last improving round:
a job stops at the first round that does not improve). One call shows
no state between its rounds or blocks, so a run of the same job after
the window keeps the program's own state where each checked block
starts and where its first round ends (`bench_port.capture`), and its
output must be the window's. The first round's first block is placed
from the cell's generated MSA itself.
"""
from __future__ import annotations

import numpy as np

from bench_port.capture import SweepStates
from bench_port.gen.msa import make_cell_input
from bench_port.ref import compare
from bench_port.trace import span


def prepare(cfg: dict, wl: dict, seed: int, device):
    return RealignResident(cfg, wl["params"], seed, device)


class RealignResident:
    def __init__(self, cfg, params, seed, device):
        from repeatresolver_tpu_torch.ops import _build
        from repeatresolver_tpu_torch.utils import native
        self.band = int(cfg["bandwidth"])
        self.block = int(params["block_rows"])
        self.rounds = int(params["rounds"])
        self.sample = int(params["sample"])
        self.seed = seed
        self.device = device
        self.inp = make_cell_input(cfg, int(params["copies"]), seed)
        # the reads' base counts: realignment-invariant, they order a
        # Jacobi sweep's blocks
        self.lengths = np.array([len(t) for t in self.inp.rows])
        kernels = ["staircase_fill", "walk_backtrack", "exact_fill",
                   "exact_walk"]
        if device.type == "cuda":
            _build.prebuild(kernels)
            for k in kernels:
                _build.load(k)
        native.get_lib()          # the host splices' library
        warm = self.inp.msa[:int(params["warm_rows"])]
        self._job(np.ascontiguousarray(warm[:, (warm < 4).any(axis=0)]))
        self.out = None
        self.first = None
        self.fingerprints = []

    def _job(self, msa0):
        from repeatresolver_tpu_torch.config import RealignerConfig
        from repeatresolver_tpu_torch.models.realigner import realign_batched
        st, sl = {}, []
        with span("resident.job"):
            out = realign_batched(
                msa0.copy(), RealignerConfig(bandwidth=self.band,
                                             block_rows=self.block,
                                             max_rounds=self.rounds),
                score_log=sl, stats=st, anneal=False, device=self.device)
        best = min(sl)
        return (int(st["dp_cells"]), out, best[0] * 1000000 + best[1],
                (sl, int(st["rounds"])))

    def unit(self) -> int:
        work, out, score, log = self._job(self.inp.msa)
        self.out, self.score, self.job_log = out, score, log
        if self.first is None:
            self.first = out
        self.fingerprints.append((score, out.shape))
        return work

    def check(self, control: bool):
        inp, out = self.inp, self.out
        rng = np.random.default_rng([self.seed, 1])
        pick = sorted(rng.choice(self.block, size=self.sample,
                                 replace=False).tolist())
        nb = -(-inp.msa.shape[0] // self.block)
        j = int(rng.integers(1, nb)) if nb > 1 else 0
        # the log: the start, each round run, the end after EntAlGapper;
        # the job returns the state after its last improving entry: the
        # round t it checks (a job stops at its first round that does
        # not improve)
        log, n_run = self.job_log
        e = max((i for i in range(1, len(log))
                 if log[i] < min(log[:i])), default=0)
        t = max(1, min(e, n_run))
        with SweepStates(resident_sweeps={1, t},
                         resident_blocks={0, j}) as st:
            _, again, _, _ = self._job(inp.msa)
        end1 = out if t == 1 else st.at.get((1, "end"))
        want = [(1, j)] + ([(t, 0), (t, j)] if t > 1 else [])
        missing = sum(k not in st.at for k in want) + int(end1 is None)
        checks = compare.RealignChecks(control)
        if end1 is not None:
            checks.jacobi("first_round_moved", inp.msa, end1, self.band,
                          self.block, pick)
        for name, key, to in (("first_round_later_moved", (1, j), end1),
                              ("last_round_moved", (t, 0), out),
                              ("last_round_later_moved", (t, j), out)):
            if key in want and key in st.at and to is not None:
                checks.jacobi_at(name, st.at[key], to, self.band, self.block,
                                 key[1], pick, self.lengths)
        res = [
            ("rows_altered", compare.rows_altered(out, inp.rows), 0),
            ("layout_faults", compare.layout_faults(out), 0),
            ("score_gap", compare.score_gap(out, self.score), 0),
            ("jobs_differ",
             sum(f != self.fingerprints[-1] for f in self.fingerprints)
             + int(not np.array_equal(self.first, out))
             + int(not np.array_equal(again, out)), 0),
            ("later_states_missing", missing, 0)]
        got = checks.results()
        if t == 1:
            # one round checked: the last round is the first
            got += [(name.replace("first", "last"), v, c)
                    for name, v, c in got]
        return res + compare.as_checks(got, control)
