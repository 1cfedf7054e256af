"""Cells, configurations, traffic mixes and metrics are found by name, and
a new one is a new file with no other file edited."""
import json
import os

import pytest

from port_bench import spec
from port_bench.tests.tiny import make_root


def test_every_cell_loads_its_files():
    b = spec.benchmark()
    for w in b["workloads"]:
        c = spec.cell(w["name"])
        assert c["config"]["argv"]
        assert c["traffic"]["haplotypes"] >= 2
        assert {m["name"] for m in c["end_to_end"]} >= {"setup_s"}
        for m in c["per_layer"]:
            assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("kind", ["config", "traffic", "metric"])
def test_a_new_file_is_found_with_nothing_else_edited(tmp_path, kind):
    root = make_root(str(tmp_path))
    before = {p: open(p, "rb").read() for p in _files(root)}
    d = os.path.join(root, spec.DIR)
    b = spec.benchmark(root)
    if kind == "config":
        c = json.load(open(os.path.join(d, "configs",
                                        "smoothxg-defaults.json")))
        c["argv"] = c["argv"] + ["-Z"]
        json.dump(c, open(os.path.join(d, "configs", "new-cfg.json"), "w"))
        b["configs"].append({"name": "new-cfg", "source": "s",
                             "file": f"{spec.DIR}/configs/new-cfg.json",
                             "reduced": [], "why": "w"})
        b["workloads"].append({"name": "new.cell", "config": "new-cfg",
                               "traffic": "tiny", "chips": 1, "why": "w"})
    elif kind == "traffic":
        json.dump({"haplotypes": 3, "length": 500, "snv_rate": 0.01,
                   "indel_rate": 0.0, "sv_count": 0, "set_seed": 1,
                   "graphs": 1},
                  open(os.path.join(d, "traffic", "new-mix.json"), "w"))
        b["workloads"].append({"name": "new.cell",
                               "config": "smoothxg-defaults",
                               "traffic": "new-mix", "chips": 1, "why": "w"})
    else:
        with open(os.path.join(d, "metrics", "new.metric.py"), "w") as f:
            f.write("def read(ctx):\n    return ctx['mbp'] * 2\n")
        b["workloads"].append({"name": "new.cell",
                               "config": "smoothxg-defaults",
                               "traffic": "tiny", "chips": 1, "why": "w"})
        b["per_layer"].append({"name": "new.metric", "unit": "x",
                               "better": "lower", "source": "host_clock",
                               "layer": "l", "moves": "smooth_Mbp_per_s",
                               "workloads": ["new.cell"]})
    json.dump(b, open(os.path.join(root, "BENCHMARK.json"), "w"))
    c = spec.cell("new.cell", root)
    if kind == "config":
        assert c["config"]["argv"][-1] == "-Z"
    elif kind == "traffic":
        assert c["traffic"]["length"] == 500
    else:
        assert [m["name"] for m in c["per_layer"]] == ["new.metric"]
        assert spec.reader("new.metric", root)({"mbp": 1.5}) == 3.0
    after = {p: open(p, "rb").read() for p in before}
    changed = [p for p in before if before[p] != after[p]]
    assert changed == [os.path.join(root, "BENCHMARK.json")]


def _files(root):
    for dp, _, fs in os.walk(root):
        for f in fs:
            yield os.path.join(dp, f)
