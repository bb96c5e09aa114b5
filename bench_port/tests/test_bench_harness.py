"""The harness's pieces: files found by name (a dropped-in file too),
the import check, and the frozen roofline counts."""
import json
import os
import shutil

import pytest

from bench_port import roofline
from bench_port.importcheck import forbidden_modules
from bench_port.registry import HERE, Registry

CELL = "realign-tail.tree-1pct-30k"


def test_files_load_by_name():
    reg = Registry()
    wl = reg.workload(CELL)
    assert reg.config(wl["config"])["bandwidth"] == 1000
    assert hasattr(reg.traffic(wl["kind"]), "prepare")
    names = [m["name"] for m in reg.metrics_of(CELL, trace=True)]
    assert "tail.host_pct" in names and "A_roofline.resident" not in names
    for m in names:
        assert callable(reg.reader(m))
    e2e = [m["name"] for m in reg.metrics_of(CELL, trace=False)]
    assert sorted(e2e) == ["setup_s", "tail_cells_per_s"]


def test_every_cell_and_metric_of_the_benchmark_has_its_files():
    reg = Registry()
    b = reg.benchmark()
    for w in b["workloads"]:
        wl = reg.workload(w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        reg.config(w["config"])
        reg.traffic(wl["kind"])
        e2e = [m["name"] for m in reg.metrics_of(w["name"], trace=False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert reg.metrics_of(w["name"], trace=True)
    for m in b["per_layer"]:
        assert m["workloads"]
        reg.reader(m["name"])


def test_a_file_dropped_into_a_copy_is_found(tmp_path):
    root = tmp_path / "bench_port"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(HERE, "workloads", CELL + ".json")) as f:
        wl = json.load(f)
    wl["config"] = "tree-2pct-30k"
    (root / "workloads" / "realign-tail.tree-2pct-30k.json").write_text(
        json.dumps(wl))
    with open(os.path.join(HERE, "configs", "tree-1pct-30k.json")) as f:
        cfg = json.load(f)
    cfg["difference"] = 0.02
    (root / "configs" / "tree-2pct-30k.json").write_text(json.dumps(cfg))
    (root / "metrics" / "tail.cycles.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    bench = Registry().benchmark()
    bench["per_layer"].append({
        "name": "tail.cycles", "unit": "cycles", "better": "higher",
        "source": "program_counter", "layer": "anneal tail",
        "moves": "tail_cells_per_s",
        "workloads": ["realign-tail.tree-2pct-30k"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    reg = Registry(root=str(root), benchmark=str(tmp_path / "BENCHMARK.json"))
    got = reg.workload("realign-tail.tree-2pct-30k")
    assert reg.config(got["config"])["difference"] == 0.02
    names = [m["name"] for m in reg.metrics_of("realign-tail.tree-2pct-30k",
                                               trace=True)]
    assert names == ["tail.cycles"]

    class Ctx:
        units = 3
    assert reg.reader("tail.cycles")(Ctx) == 3.0


def test_import_check_compares_top_level_names_whole():
    assert forbidden_modules(["jax", "jaxlib.xla_client", "flax.linen",
                              "repeatresolver_tpu.models.realigner",
                              "repeatresolver_tpu"]) == [
        "flax.linen", "jax", "jaxlib.xla_client", "repeatresolver_tpu",
        "repeatresolver_tpu.models.realigner"]
    assert forbidden_modules(["repeatresolver_tpu_torch",
                              "repeatresolver_tpu_torch.models.realigner",
                              "jax_free", "numpy", "torch"]) == []


def test_the_bench_and_its_reference_import_nothing_forbidden():
    import subprocess
    import sys
    code = ("import sys, bench_port.run, bench_port.ref.compare, "
            "bench_port.traffic.realign_tail, bench_port.traffic."
            "realign_resident; from bench_port.importcheck import "
            "forbidden_modules; print(forbidden_modules(list(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(HERE), timeout=300)
    assert out.stdout.strip() == "[]", out.stderr
    ref = ("import sys, bench_port.ref.compare, bench_port.gen.msa; "
           "print(sorted({m.split('.')[0] for m in sys.modules} & "
           "{'repeatresolver_tpu_torch', 'torch', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", ref], capture_output=True,
                         text=True, cwd=os.path.dirname(HERE), timeout=300)
    assert out.stdout.strip() == "[]", out.stderr


SM, HZ = 132, 1980e6


def test_frozen_bounds_reproduce_the_smokes():
    # phase 3: 64 x 32,768, band 1000, chunk 128, widen 6 (W2 1,768)
    a = roofline.staircase_bounds(64, 32768, 32768, 1000, 128, 6,
                                  [32768] * 64, SM, HZ)
    assert a["staircase_fill"] == pytest.approx(2.4383, abs=1e-4)
    # phase 9: 64 rows x 32,768 positions at band 1000
    f = roofline.exact_bounds(64, 32768, 32768, 32768, 1000, [30000] * 64,
                              SM, HZ)
    assert f["exact_fill"] == pytest.approx(1.3791, abs=1e-4)


def test_the_shares_count_the_work_the_inputs_need():
    # 64 rows of 30,000 bases at band 1000: 1.92e9 cells x 11 operations,
    # for A at band 1000, not its widened window of 1,768 lanes, and for
    # F over the bases, not the padded 32,768 positions
    want = 64 * 30000 * 1000 * 11 / (SM * 64 * HZ) * 1e3
    a = roofline.staircase_bounds(64, 32768, 32768, 1000, 128, 6,
                                  [30000] * 64, SM, HZ, need=True)
    f = roofline.exact_bounds(64, 32768, 32768, 32768, 1000, [30000] * 64,
                              SM, HZ, need=True)
    assert a["staircase_fill"] == pytest.approx(want, rel=1e-9)
    assert f["exact_fill"] == pytest.approx(want, rel=1e-9)
    assert want == pytest.approx(1.2627, abs=1e-4)


def test_one_reader_serves_a_family_of_metrics():
    reg = Registry()
    assert not os.path.exists(os.path.join(HERE, "metrics",
                                           "idle_pct.tail.py"))

    class Ctx:
        profile = {"busy_s": 3.0, "window_s": 12.0}
    for kind in ("tail", "resident", "maxcorr"):
        assert reg.reader("idle_pct." + kind)(Ctx) == pytest.approx(75.0)


def test_idle_gaps_are_read_from_the_device_trace():
    from bench_port.trace import reduce_device
    # the trace's clock 1,000 ns ahead of the host's; the marker at host 100
    dev = [(1100, 1110, "FillFunctor"), (1200, 1300, "exact_fill"),
           (1250, 1400, "copy"), (2400, 2500, "exact_walk")]
    spans = [("tail.block16", 150, 3000), ("tail.block1", 800, 1000)]
    red = reduce_device(dev, 100, 1600, spans)
    assert red["busy_s"] == pytest.approx(300e-9)
    assert red["window_s"] == pytest.approx(1500e-9)
    assert red["idle_gaps"][0] == ["tail.block1: before exact_walk",
                                   pytest.approx(1000e-9)]
    assert [n for n, _ in red["device_ops"]] == ["copy", "exact_fill",
                                                 "exact_walk"]
    assert reduce_device([], 0, 1, []) == {"busy_s": None}
