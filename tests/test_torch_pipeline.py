"""The port's pipeline as a whole against the JAX package's, on the CPU.

  * run_pipeline(device="cpu") against the JAX package's run_pipeline on
    the tiny_dataset configuration (coverage 8, 4 copies, 2,000 bases,
    2%), block 16, resolver and MaxCorrs coverage 8: every file of the
    two work directories byte-equal, the same printed lines (the
    realign line's cells/s aside) and the same assessment;
  * realign_batched(stats=...) fills the JAX package's keys with the
    same rounds and DP cells;
  * the device stays explicit: "cuda" raises where torch sees no GPU,
    also through the CLI, and the mesh is not ported.

Files and counts are compared exactly (tolerance 0).
"""
import os

import numpy as np
import pytest
import torch

from repeatresolver_tpu import config as C
from tests.test_realigner_device import make_msa

torch.set_num_threads(1)


def _cfg(**kw):
    return C.PipelineConfig(
        simulator=C.SimulatorConfig(coverage=8, copynumber=4,
                                    repeatlength=2000, difference=0.02,
                                    flank=1500, seed=7),
        realigner=C.RealignerConfig(bandwidth=200, block_rows=16, **kw),
        resolver=C.ResolverConfig(cov=8), maxcorr=C.MaxCorrConfig(mincov=8))


def test_pipeline_matches_jax(tmp_path):
    from repeatresolver_tpu.pipeline import run_pipeline as jrun
    from repeatresolver_tpu_torch.pipeline import run_pipeline as prun
    lines = {"jax": [], "port": []}
    res_j = jrun(_cfg(), str(tmp_path / "jax"), progress=lines["jax"].append)
    res_p = prun(_cfg(), str(tmp_path / "port"),
                 progress=lines["port"].append, device="cpu")
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert sum(n.startswith("KmeansSubdivisionOf_") for n in names) == 6
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    strip = [ln.split(", ")[:-1] if ln.startswith("[realign]") else ln
             for ln in lines["jax"]]
    assert [ln.split(", ")[:-1] if ln.startswith("[realign]") else ln
            for ln in lines["port"]] == strip
    assert res_p.boundaries == res_j.boundaries
    quals = [(res_j.quality["multi"], res_p.quality["multi"])]
    assert res_p.quality["singles"].keys() == res_j.quality["singles"].keys()
    quals += [(q, res_p.quality["singles"][k])
              for k, q in res_j.quality["singles"].items()]
    for qj, qp in quals:
        assert (qp.truepositives, qp.falsepositives) == \
            (qj.truepositives, qj.falsepositives)
    for k, out in res_j.window_results.items():
        for kind in out:
            np.testing.assert_array_equal(res_p.window_results[k][kind],
                                          out[kind])


def test_trace_writes_chrome_trace(tmp_path):
    from repeatresolver_tpu_torch.pipeline import trace
    with trace(str(tmp_path / "prof"), torch.device("cpu"), "t.json"):
        torch.ones(8).cumsum(0)
    assert (tmp_path / "prof" / "t.json").read_text().lstrip()[0] == "{"
    with trace(None, torch.device("cpu"), "t.json"):
        pass


def test_realign_stats_match_jax():
    from repeatresolver_tpu.models import realigner as jr
    from repeatresolver_tpu_torch.models import realigner as pr
    msa = make_msa(11, rows=8, tlen=200)
    cfg = C.RealignerConfig(bandwidth=96)
    st_j: dict = {}
    st_p: dict = {}
    jr.realign_batched(msa.copy(), cfg, block_rows=4, mode="exact",
                       kernel="native", stats=st_j)
    pr.realign_batched(msa.copy(), cfg, block_rows=4, kernel="cuda",
                       device="cpu", stats=st_p)
    assert st_p.keys() == st_j.keys()
    assert st_p["rounds"] == st_j["rounds"] > 1
    assert st_p["dp_cells"] == st_j["dp_cells"] > 0
    assert st_p["wall_s"] > 0 and st_p["cells_per_s"] > 0


def test_device_is_explicit(monkeypatch, tmp_path):
    from repeatresolver_tpu_torch import cli as pcli
    from repeatresolver_tpu_torch.pipeline import run_pipeline
    with pytest.raises(NotImplementedError):
        run_pipeline(_cfg(mesh_devices=2), str(tmp_path / "m"),
                     device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pcli.main(["pipeline", "-c", "4", "-n", "2", "-l", "1500",
                   "-w", str(tmp_path / "w")])
    assert not os.path.exists(tmp_path / "w")
