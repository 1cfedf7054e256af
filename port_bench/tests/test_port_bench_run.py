"""A run's contract: its last line, the look for a card, the look for JAX
after the window."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from port_bench import run, spec
from port_bench.cell import run_cell
from port_bench.tests.tiny import make_root, native_engine

REPO = spec.ROOT


def test_result_line(tmp_path):
    root = make_root(str(tmp_path))
    r = run_cell("tiny.cell", 2**31 + 9, 0.1, False, time.perf_counter(),
                 device="cpu", engine_factory=native_engine, root=root)
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"smooth_Mbp_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for name, v in r["checks"].items():
        assert v["value"] <= v["limit"], name
    json.dumps(r)


def test_same_seed_same_inputs(tmp_path):
    """One set of graphs for every seed, each graph its own; the seed
    draws their order."""
    from port_bench.traffic import make_graphs, read_inputs
    tr = dict(spec.traffic("hap90"), haplotypes=3, length=2000, graphs=3)
    a, b, c = ([read_inputs(g) for g in make_graphs(tr, s, str(tmp_path))]
               for s in (2**31 + 5, 2**31 + 5, 2**31 + 8))
    assert [g["in_paths"] for g in a] == [g["in_paths"] for g in b]
    assert len({str(g["in_paths"]) for g in a}) == 3
    assert sorted(g["seed"] for g in a) == sorted(g["seed"] for g in c)
    assert [g["seed"] for g in a] != [g["seed"] for g in c]


def test_hap90_set_is_the_measured_one():
    """The bounds were measured on these four graphs: a change to the
    traffic's seeds is a change to the benchmark."""
    from port_bench.traffic import job_seed
    tr = spec.traffic("hap90")
    assert [job_seed(tr["set_seed"], k) for k in range(tr["graphs"])] == [
        319860696204630420, 8374541862188419049, 915340098567393797,
        5571180417072926957]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here: this is the look for a missing one")
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                        "l4000.hap90", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == ""


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in ("smoothxg_tpu_torch", "smoothxg_tpu_torch.ops",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "smoothxg_tpu.io", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert run.forbidden_modules() == ["jaxlib", "smoothxg_tpu"]


def test_harness_imports_no_jax():
    code = ("import sys, port_bench.run, port_bench.cell, "
            "port_bench.reference.judge, port_bench.fillops; "
            "import smoothxg_tpu_torch.pipeline.run, "
            "smoothxg_tpu_torch.ops.poa_engine, smoothxg_tpu_torch.cli; "
            "print(port_bench.run.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


@pytest.mark.cuda
def test_card_runs_cell_1(tmp_path):
    """On the card: cell 1 with a short window, correct, from a directory
    with only the committed files."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                        "l4000.hap90", "--seed", "2147483999", "--seconds",
                        "5", "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_card_checkout_without_the_program_fails(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bare = str(tmp_path / "bare")
    shutil.copytree(spec.HERE, os.path.join(bare, spec.DIR),
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), bare)
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                        "l4000.hap90", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=bare, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode != 0 and p.stdout == ""


def test_trace_reduction():
    """Busy time is the union of the device's intervals; an idle gap is
    named by the phases it overlaps, the longest first."""
    from port_bench import trace
    tr = {"window_s": 10.0,
          "device": [("k", 1, 2), ("k", 1.5, 3), ("m", 6, 7)],
          "spans": [("load", 0, 2.5), ("smooth", 2.5, 8), ("write", 8, 10)]}
    assert trace.busy_s((s, e) for _, s, e in tr["device"]) == 3.0
    b = trace.breakdown(tr)
    assert b["device_ops"] == [["k", 2.5], ["m", 1.0]]
    assert b["idle_gaps"] == [["smooth 3.000 s", 3.0],
                              ["write 2.000 s + smooth 1.000 s", 3.0],
                              ["load 1.000 s", 1.0]]
