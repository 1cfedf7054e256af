"""What the benchmark runs, found by name: a cell in `BENCHMARK.json`, its
configuration's file, its traffic mix (`traffic/<name>.json`) and the
readers of its per-layer metrics (`metrics/<name>.py`).  A new cell,
configuration, traffic mix or metric is a new file and an entry in
`BENCHMARK.json`; nothing here names one."""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DIR = os.path.basename(HERE)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(name: str, root: str = ROOT) -> dict:
    """The cell's entry, with its configuration and traffic loaded and
    its metrics: {"workload", "config", "traffic", "end_to_end",
    "per_layer"}."""
    b = benchmark(root)
    w = _named(b["workloads"], name, "workload")
    centry = _named(b["configs"], w["config"], "config")
    with open(os.path.join(root, centry["file"])) as f:
        config = json.load(f)
    return {"workload": w, "config": config,
            "traffic": traffic(w["traffic"], root),
            "end_to_end": [m for m in b["end_to_end"]
                           if name in m.get("workloads", [name])],
            "per_layer": [m for m in b["per_layer"]
                          if name in m.get("workloads", [name])]}


def traffic(name: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, DIR, "traffic", f"{name}.json")) as f:
        return json.load(f)


def reader(metric: str, root: str = ROOT):
    """The `read(ctx)` of metrics/<metric>.py."""
    path = os.path.join(root, DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
