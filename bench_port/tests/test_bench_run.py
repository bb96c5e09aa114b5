"""Whole runs on the CPU at a tiny size (the harness's look for a card
skipped; the port's plain versions in place of its kernels): sound runs
are correct, the control is not, and so is no run with the timed path
broken underneath."""
import contextlib
import functools

import numpy as np
import pytest

from bench_port import run as R
from bench_port.tests.tiny import args, tiny_registry

TAIL = "realign-tail.tree-1pct-30k"
RES = "realign-resident.distributed-1pct-30k"
MC = "maxcorr-scan.tree-1pct-30k"


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    return tiny_registry(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("cell", [TAIL, RES, MC])
def test_a_sound_run_is_correct(reg, cell):
    res = R.run(args(cell), "cpu", reg)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    rate = [m["name"] for m in reg.metrics_of(cell, trace=False)
            if m["name"] != "setup_s"]
    assert rate and all(res["metrics"][m]["value"] > 0 for m in rate)
    assert res["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("cell", [TAIL, RES, MC])
def test_the_control_is_not_correct(reg, cell):
    res = R.run(args(cell, control=1), "cpu", reg)
    assert not res["correct"]
    checks = res["checks"]
    # the control has to fail one of the cell's numbers (at this size its
    # tie order may leave a later block's few sampled rows in place)
    ctl = {k: v["value"] for k, v in checks.items()
           if (k.endswith("_moved") or k == "max_dz")
           and not k.startswith("program.")}
    assert any(v > checks[k]["limit"] for k, v in ctl.items()), ctl
    # beside the control, the program's own numbers, within their limits
    mine = {k: v["value"] for k, v in checks.items()
            if k.startswith("program.")}
    assert all(v <= checks[k]["limit"] for k, v in mine.items()), mine
    if cell != MC:
        assert set(mine) == {"program." + k for k in ctl}


@contextlib.contextmanager
def patched(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _state_unchanged():
    from repeatresolver_tpu_torch.models.maxcorr import MaxCorrScan
    from repeatresolver_tpu_torch.models.realigner import BatchedRealigner
    from repeatresolver_tpu_torch.models.realigner_device import \
        DeviceResidentRealigner
    return [(BatchedRealigner, "sweep", lambda self, rows=None: None),
            (DeviceResidentRealigner, "sweep", lambda self: None),
            (MaxCorrScan, "scan", lambda self, i_tiles: self.acc)]


def _half_batch():
    from repeatresolver_tpu_torch.models import maxcorr as mcm
    from repeatresolver_tpu_torch.models import realigner_device as rd
    from repeatresolver_tpu_torch.models.realigner import BatchedRealigner
    apply0 = BatchedRealigner._apply_block
    rows0 = rd.apply_rows
    mm0 = mcm.int_matmul_t

    def int_matmul_t(a, b):
        # the product over every other one of its rows (the reads)
        return mm0(a[:, ::2], b[:, ::2])

    def apply_block(self, rows, new_rows, *a, **kw):
        h = (len(rows) + 1) // 2
        new_rows = np.array(new_rows, copy=True)
        new_rows[h:] = self.msa[list(rows)[h:]]
        return apply0(self, rows, new_rows, *a, **kw)

    def apply_rows(msa_d, counts_d, rows, rows_old, new_rows):
        h = (rows.shape[0] + 1) // 2
        new_rows = new_rows.clone()
        new_rows[h:] = rows_old[h:]
        return rows0(msa_d, counts_d, rows, rows_old, new_rows)
    return [(BatchedRealigner, "_apply_block", apply_block),
            (rd, "apply_rows", apply_rows), (mcm, "int_matmul_t", int_matmul_t)]


def _answer_altered():
    from repeatresolver_tpu_torch.ops import banded_realign as br
    from repeatresolver_tpu_torch.ops import cuda_backtrack as cb
    from repeatresolver_tpu_torch.ops import maxcorr_tile
    eb0, cb0 = br.entry_and_backtrack, cb.entry_and_backtrack
    gp0 = maxcorr_tile.group_pass_plain

    @functools.wraps(gp0)
    def group_pass(*a, **kw):
        # every maximum the group touches comes out 0.01 high
        out = gp0(*a, **kw)
        acc = a[7]
        acc.add_((acc > 0) * 0.01)
        return out

    def swap_first_bases(new_rows):
        # in each row the first base trades places with the next base
        # that differs from it
        for row in new_rows:
            idx = (row < 4).nonzero()[:, 0]
            diff = (row[idx] != row[idx[0]]).nonzero()[:, 0]
            if len(diff):
                i, j = int(idx[0]), int(idx[int(diff[0])])
                row[i], row[j] = row[j].clone(), row[i].clone()

    def eb(*a, **kw):
        out = eb0(*a, **kw)
        swap_first_bases(out[0])
        return out

    def cbt(*a, **kw):
        out = cb0(*a, **kw)
        swap_first_bases(out[0])
        return out
    return [(br, "entry_and_backtrack", eb), (cb, "entry_and_backtrack", cbt),
            (maxcorr_tile, "group_pass_plain", group_pass)]


def _later_blocks_unchanged():
    # every block of a sweep after its first (every row after the first
    # of a serial sweep) left as it was
    import torch

    from repeatresolver_tpu_torch.models import realigner_device as rd
    from repeatresolver_tpu_torch.models.realigner import BatchedRealigner
    BR, D = BatchedRealigner, rd.DeviceResidentRealigner
    sweep0, block0 = BR._sweep, BR._realign_block
    try0, step0, exact0 = D._try_sweep, rd.block_step, D._exact_block
    n = [0]

    def _sweep(self, rows=None):
        n[0] = 0
        return sweep0(self, 1 if self.block_rows == 1 else rows)

    def _realign_block(self, rows):
        n[0] += 1
        if n[0] == 1:
            block0(self, rows)

    def _try_sweep(self, extra_exact=()):
        n[0] = 0
        return try0(self, extra_exact)

    def block_step(msa_d, counts_d, rows, lengths, ncols, **kw):
        n[0] += 1
        if n[0] == 1:
            return step0(msa_d, counts_d, rows, lengths, ncols, **kw)
        b = rows.shape[0]
        return torch.zeros(b * kw["maxf"] + b + 1, dtype=torch.int32,
                           device=msa_d.device)

    def _exact_block(self, rows, pending):
        n[0] += 1
        if n[0] == 1:
            exact0(self, rows, pending)
    return [(BR, "_sweep", _sweep), (BR, "_realign_block", _realign_block),
            (D, "_try_sweep", _try_sweep), (rd, "block_step", block_step),
            (D, "_exact_block", _exact_block)]


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}
REALIGN_FAULTS = {"later_blocks_unchanged": _later_blocks_unchanged}


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in (TAIL, RES, MC) for fault in FAULTS] + [
    (cell, fault) for cell in (TAIL, RES) for fault in REALIGN_FAULTS])
def test_a_broken_timed_path_is_not_correct(reg, cell, fault):
    patches = {**FAULTS, **REALIGN_FAULTS}[fault]()
    with contextlib.ExitStack() as stack:
        for obj, name, new in patches:
            stack.enter_context(patched(obj, name, new))
        res = R.run(args(cell), "cpu", reg)
    assert not res["correct"], res["checks"]
