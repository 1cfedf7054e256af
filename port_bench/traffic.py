"""The traffic: pangenomes to smooth, one a job, made by one generator
(the frozen `synth.make_pangenome`) whose parameters a traffic file gives:

  haplotypes, length, snv_rate, indel_rate, sv_count   the generator's
  set_seed    the seed of the set of graphs
  graphs      how many graphs the set holds (graph k's seed is drawn from
              (set_seed, k)); the window's jobs take them in turn, and
              set-up's warm job takes graph k = graphs

Every run smooths the same set, each graph once before any twice, in an
order drawn from --seed: graphs of one shape still differ in their blocks
and so in their work, and a set that moved with the seed would move the
rate with it.  The same seed gives the same bytes in the same order."""
from __future__ import annotations

import os

import numpy as np

from .reference.seqs import read_gfa_paths
from .synth import make_pangenome

GEN_KEYS = ("haplotypes", "length", "snv_rate", "indel_rate", "sv_count")


def job_seed(seed: int, k: int) -> int:
    s = int(seed) % (1 << 64)
    ss = np.random.SeedSequence([s & 0xFFFFFFFF, s >> 32, 0, k])
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


def make_graph(tr: dict, seed: int, path: str) -> dict:
    """Write one graph; returns {"gfa", "seed"}."""
    with open(path, "w") as f:
        f.write(make_pangenome(seed=seed, **{k: tr[k] for k in GEN_KEYS}))
    return {"gfa": path, "seed": seed}


def read_inputs(graph: dict) -> dict:
    """The graph's input paths and their bases (read after the window, so
    set-up does not pay for it)."""
    if "in_paths" not in graph:
        graph["in_paths"] = read_gfa_paths(graph["gfa"])
        graph["bases"] = sum(len(s) for s in graph["in_paths"].values())
    return graph


def order(seed: int, n: int) -> list[int]:
    s = int(seed) % (1 << 64)
    rng = np.random.default_rng([s & 0xFFFFFFFF, s >> 32, 3])
    return [int(k) for k in rng.permutation(n)]


def make_graphs(tr: dict, seed: int, workdir: str) -> list:
    """The set's graphs, in the run's order."""
    return [make_graph(tr, job_seed(tr["set_seed"], k),
                       os.path.join(workdir, f"in{k}.gfa"))
            for k in order(seed, tr["graphs"])]
