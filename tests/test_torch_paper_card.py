"""The paper run's card driver (repeatresolver_tpu_torch.paper_card) on
the CPU, at test_torch_paper_run's configuration with --device cpu.

`paper_card run --realign-limit-s` first: a stand-in on the steps'
PYTHONPATH (a sitecustomize that only the realign step acts on) holds
realign's third sweep, so the limit stops realign once two rounds have
written a best MSA. The probe steps then run the MaxCorrs scan, every
window's resolve (a record a window, with its split) and the assessment
on that MSA into probe_* files, beside the host checks (the maxcorr
check last); the driver's own later files stay unwritten. The same work
directory, run again without the stand-in and the limit (a new --out
that carries the first report's trajectory and tail lines, which skips
those checks), resumes realign from its checkpoint and runs the later
stages beside their checks. Every check holds (the tail's: one sweep at
block 4 through the card's tail engine, here on CPU tensors, equal to
the host native engine, then the first SERIAL_ROWS rows of a block-1
sweep on both routes), and the work directory's files
equal a straight paper_run's, the probe files aside (the scorelog and
stage_times.json as in test_torch_paper_run's interrupted realign).
"""
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["-c", "30", "-n", "4", "-l", "2000", "-d", "2", "--seed", "7",
        "--band", "200", "--block-rows", "16", "--align-band", "0",
        "--threads", "2", "--device", "cpu"]
NAME = "Tree_2perc_2000kb"
LIMIT_S = 20
SERIAL_ROWS = 6
TIMEOUT_S = 400
HOLD_THIRD_SWEEP = """
import sys
if sys.argv[1:4] == ["step", "--step", "realign"]:
    import time
    from repeatresolver_tpu_torch.models import realigner
    sweep, calls = realigner.BatchedRealigner.sweep, [0]

    def held(self):
        calls[0] += 1
        if calls[0] == 3:
            time.sleep(600)
        sweep(self)
    realigner.BatchedRealigner.sweep = held
"""


def card_run(workdir, out, *extra, pythonpath=()):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, *pythonpath]))
    p = subprocess.run(
        [sys.executable, "-m", "repeatresolver_tpu_torch.paper_card", "run",
         "--workdir", str(workdir), "--out", str(out), *extra, "--"]
        + ARGS, env=env, cwd=REPO, capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    with open(out / "report.jsonl") as f:
        return p.stdout, {r["step"]: r for r in map(json.loads, f)}


def stage_records(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items()
             if k not in ("wall_s", "ts", "cells_per_s")} for r in recs]


def test_card_run_with_a_realign_limit_then_resumed(tmp_path):
    from repeatresolver_tpu_torch import paper_run
    from repeatresolver_tpu_torch.utils.checkpoint import RealignCheckpoint
    hold = tmp_path / "hold"
    hold.mkdir()
    (hold / "sitecustomize.py").write_text(HOLD_THIRD_SWEEP)
    wd, out1, out2 = (tmp_path / k for k in ("work", "out1", "out2"))

    stdout, rep = card_run(wd, out1, "--realign-limit-s", str(LIMIT_S),
                           "--serial-rows", str(SERIAL_ROWS),
                           pythonpath=[str(hold)])
    assert "status: realign limit" in stdout
    steps = list(rep)
    assert steps[:7] == ["simulate", "cut", "align", "check:trajectory",
                         "check:tail", "realign", "probe:maxcorr"]
    # probe:resolve's window records, its own line and the resolve check
    # (side by side) in any order; then the assessment and the maxcorr
    # check
    assert sorted(steps[7:10]) == ["check:resolve", "probe:resolve",
                                   "probe:resolve/window"]
    assert steps[10:] == ["probe:assess", "check:maxcorr"]
    traj, tail = rep["check:trajectory"], rep["check:tail"]
    assert traj["equal"] and len(traj["resident_log"]) >= 3
    assert tail["equal"] and tail["block_rows"] == 4
    assert tail["card"]["tail_sweeps"] == {"cuda": {"4": 1}}
    assert tail["card"]["tail_card_split"]["blocks"] > 0
    assert tail["host_native"]["tail_sweeps"] == {"native": {"4": 1}}
    serial = tail["serial"]
    assert serial["equal"] and serial["rows"] == SERIAL_ROWS
    assert serial["card"]["tail_sweeps"] == {"cuda": {"1": 1}}
    assert serial["card"]["card_serial_split"]["rows"] == SERIAL_ROWS
    assert serial["host_native"]["tail_sweeps"] == {"native": {"1": 1}}
    assert rep["realign"]["stopped"]
    start = rep["realign"]["checkpoint"]["round"]
    assert 1 <= start <= 2
    for k in ("check:maxcorr", "check:resolve"):
        assert rep[k]["equal"] and rep[k]["files"] == "probe_*", rep[k]
    windows = rep["probe:resolve"]["windows"]
    assert len(windows) >= 2
    assert rep["check:resolve"]["host"]["route"] == "host"
    assess = rep["probe:assess"]
    assert not assess["realign_converged"] and "multi" in assess["summary"]
    names = os.listdir(wd)
    probes = sorted(n for n in names if n.startswith("probe_"))
    assert len(probes) == 2 + 3 * len(windows)
    assert {"probe_MaxCorrsOf_" + NAME + "_MSAreal",
            "probe_assessment.json"} <= set(probes)
    assert not any(n.startswith(("MaxCorrsOf_", "KmeansSubdivisionOf_"))
                   or n.endswith(".done") for n in names)

    out2.mkdir()
    (out2 / "report.jsonl").write_text(json.dumps(traj) + "\n"
                                       + json.dumps(tail) + "\n")
    stdout, rep = card_run(wd, out2)
    assert "status: done" in stdout
    steps = list(rep)
    assert steps[:4] == ["check:trajectory", "check:tail", "realign",
                         "maxcorr"]
    assert sorted(steps[4:6]) == ["check:resolve", "resolve"]
    assert steps[6:] == ["assess", "check:maxcorr"]
    assert not rep["realign"]["stopped"]
    records = rep["resolve"]["resolve_windows"]
    kmeans = sorted(n for n in os.listdir(wd)
                    if n.startswith("KmeansSubdivisionOf_"))
    assert len(records) == len(kmeans) >= 2
    assert all(r["route"] == "host" and r["s"] > 0 for r in records)
    for k in ("check:maxcorr", "check:resolve"):
        assert rep[k]["equal"] and rep[k]["files"] == "*", rep[k]
    # no value passes the cutoff at this size: the decisions agree
    # trivially, so hold the values, as the MaxCorrs file rounds them
    nz = rep["check:maxcorr"]["nonzero"]
    assert nz[0] == nz[1] > 0 and rep["check:maxcorr"]["max_dz"] < 1e-5

    ref = tmp_path / "straight"
    paper_run.main(["--workdir", str(ref)] + ARGS)
    names = sorted(os.listdir(ref))
    assert sorted(n for n in os.listdir(wd)
                  if not n.startswith("probe_")) == names
    for n in names:
        a, b = wd / n, ref / n
        if n.endswith(".done"):
            assert (json.loads(a.read_text())["rounds"]
                    == json.loads(b.read_text())["rounds"])
        elif n.endswith(".ckpt"):
            ca, cb = (RealignCheckpoint.load(str(p)) for p in (a, b))
            np.testing.assert_array_equal(ca.msa, cb.msa)
            assert ca.round == cb.round
        elif n == f"{NAME}_scorelog":
            # the stopped run logged rounds 0-2; the resume logs again
            # from the checkpoint's round
            lines = b.read_text().splitlines()
            assert a.read_text().splitlines() == lines[:3] + lines[start:]
        elif n == "stage_times.json":
            got, want = stage_records(a), stage_records(b)
            assert [r["stage"] for r in got] == [r["stage"] for r in want]
            for g, w in zip(got, want):
                if g["stage"] == "realign":
                    rounds = w["rounds"]
                    assert (g.pop("dp_cells") * rounds
                            == w.pop("dp_cells") * (rounds - start))
                assert g == w
        else:
            assert a.read_bytes() == b.read_bytes(), n
