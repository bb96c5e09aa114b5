"""The port's paper-run driver against scripts/paper_run.py, on the CPU.

At a small configuration (-c 30 -n 4 -l 2000 -d 2 --seed 7 --band 200
--block-rows 16 --align-band 0 --threads 2) the JAX driver runs as a
subprocess (JAX_PLATFORMS=cpu) and the port's driver in this process
with --device cpu. Every file of the two work directories must be
byte-equal, with three exceptions: stage_times.json must have the same
stages in the same order with the same extras (wall times, clock times
and rates left out), `_MSAreal.done` the same rounds, and the realign
checkpoint (an npz, whose zip members carry their write time) must load
to the same arrays and fields.

  * banded align: the same comparison at --align-band 300 --until align;
  * resume: --until align and then a full run; a realign interrupted in
    its third sweep by an exception from a stand-in and then restarted;
    a work directory that the JAX driver left after --until realign,
    finished by the port's driver. Each ends with the JAX driver's
    straight run's files;
  * the port's parser has the JAX driver's flags and defaults, and
    --device, but no default --workdir; --device cuda raises where
    torch sees no GPU.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["-c", "30", "-n", "4", "-l", "2000", "-d", "2", "--seed", "7",
        "--band", "200", "--block-rows", "16", "--align-band", "0",
        "--threads", "2"]
NAME = "Tree_2perc_2000kb"
JAX_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX driver's work directories, run side by side: a straight
    run, a run --until realign, and a banded align --until align."""
    root = tmp_path_factory.mktemp("jax_paper_run")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               JAX_COMPILATION_CACHE_DIR=str(root / "jax_cache"))
    runs = {"straight": [], "until_realign": ["--until", "realign"],
            "banded": ["--align-band", "300", "--until", "align"]}
    procs = {k: subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "paper_run.py"),
         "--workdir", str(root / k)] + ARGS + extra,
        cwd=str(root), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for k, extra in runs.items()}
    try:
        for k, p in procs.items():
            out, _ = p.communicate(timeout=JAX_TIMEOUT_S)
            assert p.returncode == 0, f"{k}: {out[-3000:]}"
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return {k: root / k for k in runs}


def port_run(workdir, *extra):
    from repeatresolver_tpu_torch import paper_run
    paper_run.main(["--workdir", str(workdir)] + ARGS + list(extra)
                   + ["--device", "cpu"])


def stage_records(path, drop=("wall_s", "ts", "cells_per_s")):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k not in drop} for r in recs]


def assert_same_checkpoint(a, b):
    from repeatresolver_tpu_torch.utils.checkpoint import RealignCheckpoint
    ca, cb = RealignCheckpoint.load(str(a)), RealignCheckpoint.load(str(b))
    for f in ("msa", "widen", "exact_blocks"):
        x, y = getattr(ca, f), getattr(cb, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)
    for f in ("round", "best_mille", "best_uno", "bandwidth", "block_rows",
              "widen_bs"):
        assert getattr(ca, f) == getattr(cb, f), f


def assert_same_run(got, ref, special=()):
    """Every file of `got` equal to `ref`'s under the module's rules;
    names in `special` are compared by the caller."""
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(got)) == names
    for name in names:
        if name in special:
            continue
        a, b = got / name, ref / name
        if name == "stage_times.json":
            assert stage_records(a) == stage_records(b)
        elif name.endswith(".done"):
            assert (json.loads(a.read_text())["rounds"]
                    == json.loads(b.read_text())["rounds"])
        elif name.endswith(".ckpt"):
            assert_same_checkpoint(a, b)
        else:
            assert a.read_bytes() == b.read_bytes(), name


def test_cpu_driver_matches_jax_driver(jax_runs, tmp_path):
    port_run(tmp_path / "port")
    ref = jax_runs["straight"]
    assert sum(n.startswith("KmeansSubdivisionOf_")
               for n in os.listdir(ref)) == 6
    assert [r["stage"] for r in stage_records(ref / "stage_times.json")][
        :4] == ["simulate", "cut", "align", "realign"]
    assert "multi" in json.loads((ref / "assessment.json").read_text())
    assert_same_run(tmp_path / "port", ref)


def test_banded_align_matches_jax_driver(jax_runs, tmp_path):
    port_run(tmp_path / "port", "--align-band", "300", "--until", "align")
    assert_same_run(tmp_path / "port", jax_runs["banded"])
    # the band changed the alignment: the comparison is not vacuous
    assert ((jax_runs["banded"] / f"{NAME}_MSA").read_bytes()
            != (jax_runs["straight"] / f"{NAME}_MSA").read_bytes())


def test_resume_after_until_align(jax_runs, tmp_path):
    wd = tmp_path / "port"
    port_run(wd, "--until", "align")
    assert not (wd / f"{NAME}_MSAreal").exists()
    before = {n: (wd / n).stat().st_mtime_ns for n in os.listdir(wd)
              if n != "stage_times.json"}
    port_run(wd)
    assert {n: (wd / n).stat().st_mtime_ns for n in before} == before
    assert_same_run(wd, jax_runs["straight"])


def test_resume_of_an_interrupted_realign(jax_runs, tmp_path, monkeypatch):
    from repeatresolver_tpu_torch.models import realigner
    from repeatresolver_tpu_torch.utils.checkpoint import RealignCheckpoint

    class Interrupted(Exception):
        pass

    sweep = realigner.BatchedRealigner.sweep
    calls = [0]

    def stand_in(self):
        calls[0] += 1
        if calls[0] == 3:
            raise Interrupted
        sweep(self)

    wd = tmp_path / "port"
    monkeypatch.setattr(realigner.BatchedRealigner, "sweep", stand_in)
    with pytest.raises(Interrupted):
        port_run(wd)
    for t in threading.enumerate():   # the best-MSA write in flight
        if "_write_best" in t.name:
            t.join()
    monkeypatch.setattr(realigner.BatchedRealigner, "sweep", sweep)
    assert not (wd / f"{NAME}_MSAreal.done").exists()
    start = RealignCheckpoint.load(str(wd / f"{NAME}_realign.ckpt")).round
    assert 1 <= start <= 2
    port_run(wd)
    ref = jax_runs["straight"]
    assert_same_run(wd, ref, special=("stage_times.json",
                                      f"{NAME}_scorelog"))
    # the interrupted run logged rounds 0-2; the restart logs again from
    # the checkpoint's round, as the JAX driver's resume does
    lines = (ref / f"{NAME}_scorelog").read_text().splitlines()
    assert ((wd / f"{NAME}_scorelog").read_text().splitlines()
            == lines[:3] + lines[start:])
    # a restarted realign counts the DP cells of its own sweeps
    got = stage_records(wd / "stage_times.json")
    want = stage_records(ref / "stage_times.json")
    assert [r["stage"] for r in got] == [r["stage"] for r in want]
    for g, w in zip(got, want):
        if g["stage"] == "realign":
            rounds = w["rounds"]
            assert g["rounds"] == rounds
            assert (g.pop("dp_cells") * rounds
                    == w.pop("dp_cells") * (rounds - start))
        assert g == w


def test_port_finishes_a_jax_workdir(jax_runs, tmp_path):
    wd = tmp_path / "carried"
    shutil.copytree(jax_runs["until_realign"], wd)
    assert not any(n.startswith("MaxCorrsOf_") for n in os.listdir(wd))
    port_run(wd)
    assert_same_run(wd, jax_runs["straight"])


def _jax_parser_flags():
    """{flag: (default, type name, choices)} of the add_argument calls in
    scripts/paper_run.py."""
    with open(os.path.join(REPO, "scripts", "paper_run.py")) as f:
        tree = ast.parse(f.read())
    flags = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            default = (ast.literal_eval(kw["default"]) if "default" in kw
                       else None)
            if kw.get("choices") is not None:
                choices = ("STAGES",) if isinstance(
                    kw["choices"], ast.Name) else tuple(
                        ast.literal_eval(kw["choices"]))
            else:
                choices = None
            flags[node.args[0].value] = (
                default, kw["type"].id if "type" in kw else None, choices)
    return flags


def test_parser_has_the_jax_drivers_flags_and_defaults():
    from repeatresolver_tpu_torch import paper_run
    port = {}
    for a in paper_run.build_parser()._actions:
        if a.dest == "help":
            continue
        choices = a.choices and tuple(a.choices)
        if choices == tuple(paper_run.STAGES):
            choices = ("STAGES",)
        port[a.option_strings[0]] = (
            a.default, a.type.__name__ if a.type else None, choices)
    assert port.pop("--device") == ("cuda", None, ("cuda", "cpu"))
    jax_flags = _jax_parser_flags()
    assert len(jax_flags) == 13
    # --workdir has no default in the port: the JAX driver's, runs/paper,
    # holds the JAX package's committed reference run
    assert jax_flags.pop("--workdir") == ("runs/paper", None, None)
    assert port.pop("--workdir") == (None, None, None)
    assert {a.dest for a in paper_run.build_parser()._actions
            if a.required} == {"workdir"}
    assert port == jax_flags


def test_cuda_device_raises_without_a_gpu(tmp_path, monkeypatch):
    from repeatresolver_tpu_torch import paper_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper_run.main(["--workdir", str(tmp_path / "w")] + ARGS)
    assert not (tmp_path / "w").exists()

