"""A benchmark root for the CPU tests: a copy of BENCHMARK.json and the
harness's folder with one more cell, `tiny.cell`, on a tiny traffic mix
(`tiny`: 8 haplotypes x 5 kb), so a whole run fits a test."""
from __future__ import annotations

import json
import os
import shutil

from port_bench import spec

TINY_TRAFFIC = {"haplotypes": 8, "length": 5000, "snv_rate": 0.01,
                "indel_rate": 0.002, "sv_count": 1, "set_seed": 5, "graphs": 2}


def make_root(tmp: str, config: str = "smoothxg-defaults") -> str:
    """A root under `tmp` that holds BENCHMARK.json and a copy of the
    harness, with `tiny.cell` added to it and to every metric."""
    root = os.path.join(tmp, "root")
    shutil.copytree(spec.HERE, os.path.join(root, spec.DIR),
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    b = spec.benchmark()
    b["workloads"].append({"name": "tiny.cell", "config": config,
                           "traffic": "tiny", "chips": 1, "why": "tests"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.cell")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    with open(os.path.join(root, spec.DIR, "traffic", "tiny.json"), "w") as f:
        json.dump(TINY_TRAFFIC, f)
    return root


def native_engine(cfg, device):
    """The port's C++ engine: the same POA on the CPU, in seconds."""
    from smoothxg_tpu_torch.ops.poa_native import NativePOAEngine
    return NativePOAEngine(threads=1)
