"""On the card: whole runs of both cells at a tiny size, through the
port's kernels, come out correct, and the control does not. Skips
without a card (`cuda` marker)."""
import pytest

from bench_port import run as R
from bench_port.tests.tiny import args, tiny_registry


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["realign-tail.tree-1pct-30k",
                                  "realign-resident.distributed-1pct-30k"])
def test_tiny_runs_on_the_card(cuda_device, tmp_path, cell):
    reg = tiny_registry(str(tmp_path))
    res = R.run(args(cell, trace=1), cuda_device, reg)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    ctl = R.run(args(cell, control=1), cuda_device, reg)
    assert not ctl["correct"]
