"""Traffic kind `realign_tail`: realign's anneal tail, cycle after cycle.

A cycle is three sweeps, each from the one before, all from the cell's
generated MSA: one sweep at each of the workload's `blocks` (16 and 4:
the tail engine, `realign_batched(..., mode="exact", kernel="cuda")`,
the MSA on the host, kernels F and G a block; 1: the serial sweep a row
at a time over the column store on the card, which `realign_batched`
routes through `tail_kernel`). One round each, no anneal. A cycle's
work is its DP cells: bases x band, each sweep (`realign_batched`'s
`stats["dp_cells"]`).

The check (after the window, on the last cycle): every sweep improved
the score; each output's rows hold their reads' bases; each output's
score is the program's; the first Jacobi block of each sweep above
block 1 and the first `serial_rows` rows of the serial sweep, placed by
the reference from that sweep's input, sit where the program put them
(`ref.compare`); so do a later block of each Jacobi sweep and a later
range of `serial_rows` serial rows, drawn from the seed and placed from
the program's own state at their start, which a run of the cycle after
the window keeps (`bench_port.capture`); and every cycle, that run's
too, gave the same outputs.
"""
from __future__ import annotations

import numpy as np

from bench_port.capture import SweepStates
from bench_port.gen.msa import make_cell_input
from bench_port.ref import compare
from bench_port.trace import span


def prepare(cfg: dict, wl: dict, seed: int, device):
    return RealignTail(cfg, wl["params"], seed, device)


class RealignTail:
    def __init__(self, cfg, params, seed, device):
        from repeatresolver_tpu_torch.ops import _build
        from repeatresolver_tpu_torch.utils import native
        self.band = int(cfg["bandwidth"])
        self.blocks = [int(b) for b in params["blocks"]]
        self.serial_rows = int(params["serial_rows"])
        self.seed, self.device = seed, device
        self.inp = make_cell_input(cfg, int(params["copies"]), seed)
        # the reads' base counts: realignment-invariant, they order a
        # Jacobi sweep's blocks
        self.lengths = np.array([len(t) for t in self.inp.rows])
        if device.type == "cuda":
            _build.prebuild(["exact_fill", "exact_walk"])
            for k in ("exact_fill", "exact_walk"):
                _build.load(k)
        native.get_lib()          # the host splices' library
        # warm up every path of a cycle on the MSA's first rows
        warm = self.inp.msa[:int(params["warm_rows"])]
        self._cycle(np.ascontiguousarray(warm[:, (warm < 4).any(axis=0)]))
        self.outs = None
        self.first = None
        self.fingerprints = []

    def _cycle(self, msa0):
        from repeatresolver_tpu_torch.config import RealignerConfig
        from repeatresolver_tpu_torch.models.realigner import realign_batched
        outs, scores, logs, work = [], [], [], 0
        m = msa0
        for bs in self.blocks:
            st, sl = {}, []
            kw = dict(mode="exact", kernel="cuda") if bs > 1 else {}
            with span(f"tail.block{bs}"):
                m = realign_batched(
                    m.copy(), RealignerConfig(bandwidth=self.band,
                                              block_rows=bs, max_rounds=1),
                    score_log=sl, stats=st, anneal=False,
                    device=self.device, **kw)
            work += int(st["dp_cells"])
            outs.append(m)
            best = min(sl)
            scores.append(best[0] * 1000000 + best[1])
            logs.append(sl)
        return work, outs, scores, logs

    def unit(self) -> int:
        work, outs, scores, logs = self._cycle(self.inp.msa)
        self.outs, self.scores, self.logs = outs, scores, logs
        if self.first is None:
            self.first = outs
        self.fingerprints.append(
            (tuple(scores), tuple(o.shape for o in outs)))
        return work

    def check(self, control: bool):
        inp, outs = self.inp, self.outs
        r = inp.msa.shape[0]
        n = self.serial_rows
        rng = np.random.default_rng([self.seed, 2])
        later = {bs: int(rng.integers(1, -(-r // bs))) if r > bs else 0
                 for bs in self.blocks if bs > 1}
        lo = min(n, r - 1)
        start = int(rng.integers(lo, max(lo, r - n) + 1))
        checks = compare.RealignChecks(control)
        ins = [inp.msa] + outs[:-1]
        for bs, m_in, m_out in zip(self.blocks, ins, outs):
            if bs > 1:
                checks.jacobi(f"block{bs}_moved", m_in, m_out, self.band, bs,
                              range(bs))
            else:
                checks.serial("serial_moved", m_in, m_out, self.band, n)
        # the cycle again, the program's state kept where the later
        # block (or row range) of each sweep starts
        with SweepStates(jacobi=later, serial_start=start) as st:
            _, again, _, _ = self._cycle(inp.msa)
        missing = 0
        for bs, m_out in zip(self.blocks, outs):
            key = (bs, later[bs]) if bs > 1 else ("serial", start)
            if key not in st.at:
                missing += 1
            elif bs > 1:
                checks.jacobi_at(f"block{bs}_later_moved", st.at[key], m_out,
                                 self.band, bs, later[bs], range(bs),
                                 self.lengths)
            else:
                checks.serial("serial_later_moved", st.at[key], m_out,
                              self.band, n, start)
        res = [
            # the log: the start, the round, the end after EntAlGapper
            ("sweeps_not_improved",
             sum(1 for sl in self.logs if not sl[1] < sl[0]), 0),
            ("rows_altered", sum(compare.rows_altered(o, inp.rows)
                                 for o in outs), 0),
            ("layout_faults", sum(compare.layout_faults(o) for o in outs),
             0),
            ("score_gap", sum(compare.score_gap(o, s)
                              for o, s in zip(outs, self.scores)), 0),
            ("cycles_differ",
             sum(f != self.fingerprints[-1] for f in self.fingerprints)
             + sum(not np.array_equal(a, b)
                   for a, b in zip(self.first, outs))
             + sum(not np.array_equal(a, b) for a, b in zip(again, outs)),
             0),
            ("later_states_missing", missing, 0)]
        return res + compare.as_checks(checks.results(), control)
