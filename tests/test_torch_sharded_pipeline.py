"""The port's pipeline on a mesh, and the dry run, on the CPU: two gloo
ranks in one spawn (the companion of tests/test_torch_sharded.py, kept
apart so that the two files run side by side)."""
import os

import pytest
import torch

from repeatresolver_tpu_torch import config as C

torch.set_num_threads(1)

RANK_TIMEOUT_S = 420.0


def pipeline_cfg(**kw):
    """tests/test_torch_pipeline.py's tiny pipeline."""
    return C.PipelineConfig(
        simulator=C.SimulatorConfig(coverage=8, copynumber=4,
                                    repeatlength=2000, difference=0.02,
                                    flank=1500, seed=7),
        realigner=C.RealignerConfig(bandwidth=200, block_rows=16, **kw),
        resolver=C.ResolverConfig(cov=8), maxcorr=C.MaxCorrConfig(mincov=8))


def _rank_work(rank, n, outdir):
    torch.set_num_threads(1)
    from repeatresolver_tpu_torch.parallel import sharded
    from repeatresolver_tpu_torch.pipeline import run_pipeline
    run_pipeline(pipeline_cfg(mesh_devices=n), os.path.join(outdir, "pipe"),
                 progress=lambda *_: None, device="cpu")
    sharded.dryrun(n, device="cpu")       # inside the group: as a rank
    with open(os.path.join(outdir, f"done{rank}"), "w") as f:
        f.write("ok")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repeatresolver_tpu_torch.parallel import sharded
    outdir = str(tmp_path_factory.mktemp("mesh_pipeline"))
    sharded.spawn(_rank_work, 2, (outdir,), backend="gloo",
                  timeout=RANK_TIMEOUT_S)
    return outdir


def test_pipeline_on_the_mesh_writes_the_single_process_files(
        ranks, tmp_path, monkeypatch):
    """run_pipeline with realigner.mesh_devices=2 inside the group: rank
    0's files equal, byte for byte, the single-process pipeline's with
    the same engine (the MSA on the host: RR_RESIDENT=0); rank 1 ran on
    files of its own and reached the same MSAreal."""
    from repeatresolver_tpu_torch.pipeline import run_pipeline
    monkeypatch.setenv("RR_RESIDENT", "0")
    run_pipeline(pipeline_cfg(), str(tmp_path / "single"),
                 progress=lambda *_: None, device="cpu")
    pipe = os.path.join(ranks, "pipe")
    names = sorted(os.listdir(tmp_path / "single"))
    assert sorted(os.listdir(pipe)) == sorted(names + ["rank1"])
    assert sum(n.startswith("KmeansSubdivisionOf_") for n in names) == 6
    for n in names:
        if n.endswith(".ckpt"):
            continue
        with open(tmp_path / "single" / n, "rb") as f1, \
                open(os.path.join(pipe, n), "rb") as f2:
            assert f1.read() == f2.read(), n
    real = [n for n in names if n.endswith("_MSAreal")][0]
    with open(os.path.join(pipe, real), "rb") as f1, \
            open(os.path.join(pipe, "rank1", real), "rb") as f2:
        assert f1.read() == f2.read()
    assert not any(n.endswith(".ckpt")
                   for n in os.listdir(os.path.join(pipe, "rank1")))


def test_dryrun_two_ranks(ranks):
    """dryrun(2) ran inside the fixture's group, every rank its share
    (tests/test_torch_graft_entry.py has it start its own ranks)."""
    for rank in range(2):
        assert os.path.exists(os.path.join(ranks, f"done{rank}"))
