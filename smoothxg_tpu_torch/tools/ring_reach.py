"""How far back the predecessor rows of a round task lie: the share of
predecessor reads at a distance d <= R rows, for the ring of recent rows
that csrc/poa_round.cu and csrc/poa_batch.cu keep in shared memory
(RING_ROWS = 8 rows, so distances 1-7 are read from it).

A predecessor read is one (row, predecessor row) pair of a task's DP fill,
as the kernel reads it.  Two layouts: `--layout round` (ops/poa_round.py:
pack_tasks; slots past a row's in-degree repeat the first and are not
read, a row without predecessors reads row 0) and `--layout batch`
(ops/poa_batch.py:pack_tasks, the jax engine's own row order and slots:
each distinct row of a row's slots is read once).  Two sources:
  (default)     the chip smoke's seeded phase-6 round tasks
                (tools/time_chase.round_groups, the seeded plan), on the CPU;
  --main-path   every task the round engine (`--engine pallas`) or, with
                `--layout batch`, the batch engine (`--engine jax`) launches
                on the chip smoke's 16 x 80 kb main path, counted as it is
                packed; needs CUDA, since the tasks come from the kernel's
                alignments.
Prints one line per distance bound and a JSON line.

Usage: python -m smoothxg_tpu_torch.tools.ring_reach [--main-path]
       [--layout round|batch]
"""
from __future__ import annotations

import collections
import json
import os
import sys

import numpy as np

BOUNDS = (1, 2, 4, 7, 8, 16, 32)


def count(hist: collections.Counter, nv, preds) -> None:
    """Add the predecessor distances of packed tasks (nv (B,), preds (B,
    VW, P), ops/poa_round.py's layout) to `hist`."""
    nv = np.asarray(nv)
    preds = np.asarray(preds)
    for b, V in enumerate(nv.tolist()):
        if V <= 0:
            continue
        pr = preds[b, :V].astype(np.int64)
        # real slots: up to the first repeat of slot 0
        rep = np.concatenate([pr[:, 1:] == pr[:, :1],
                              np.ones((V, 1), bool)], axis=1)
        k = rep.argmax(1) + 1
        live = np.arange(pr.shape[1])[None, :] < k[:, None]
        d = (np.arange(1, V + 1)[:, None] - pr)[live]
        hist.update(d.tolist())


def count_batch(hist: collections.Counter, nvalid, pred) -> None:
    """Add the predecessor distances of packed tasks (nvalid (B,), pred
    (Vp, B, P), ops/poa_batch.py's layout) to `hist`: each distinct row
    of a row's slots once."""
    nvalid = np.asarray(nvalid)
    pred = np.asarray(pred)
    for b, V in enumerate(nvalid.tolist()):
        if V <= 0:
            continue
        pr = pred[:V, b].astype(np.int64)
        P = pr.shape[1]
        # a slot is read when no earlier slot names its row
        first = np.ones(pr.shape, bool)
        for k in range(1, P):
            first[:, k] = (pr[:, :k] != pr[:, k:k + 1]).all(1)
        d = (np.arange(1, V + 1)[:, None] - pr)[first]
        hist.update(d.tolist())


def _counter(layout: str):
    """(the layout's pack_tasks module, a function counting its packed
    inputs into a histogram)."""
    if layout == "batch":
        from ..ops import poa_batch as mod
        return mod, lambda h, ins: count_batch(h, ins[4].numpy(),
                                               ins[1].numpy())
    from ..ops import poa_round as mod
    return mod, lambda h, ins: count(h, ins[0].numpy(), ins[5].numpy())


def seeded_tasks(hist: collections.Counter, layout: str = "round") -> str:
    from .time_chase import SEED, round_groups
    mod, add = _counter(layout)
    n = 0
    for _, tasks in round_groups(np.random.default_rng(SEED + 1)):
        for t in tasks:
            ins, _ = mod.pack_tasks([t])
            add(hist, ins)
            n += 1
    return f"the chip smoke's {n} seeded round tasks ({layout} layout)"


def main_path(hist: collections.Counter, layout: str = "round") -> str:
    from .. import cli
    from ..testing.synth import write_pangenome
    mod, add = _counter(layout)
    out = os.path.join("smoke_out", "ring_reach")
    os.makedirs(out, exist_ok=True)
    gfa = write_pangenome(os.path.join(out, "pangenome.gfa"), haplotypes=16,
                          length=80_000, snv_rate=0.01, indel_rate=0.001,
                          sv_count=4, seed=20261016)
    pack = mod.pack_tasks
    n = [0]

    def spy(tasks, *args, **kw):
        ins, orders = pack(tasks, *args, **kw)
        add(hist, ins)
        n[0] += len(tasks)
        return ins, orders

    engine = "jax" if layout == "batch" else "pallas"
    mod.pack_tasks = spy
    try:
        rc, _ = cli.run(["-g", gfa, "-o", os.path.join(out, "out.gfa"), "-m",
                      os.path.join(out, "out.maf"), "-r", "16", "-j", "5k",
                      "-e", "5k", "-l", "700,900,1100", "-t", "1",
                      "--engine", engine])
    finally:
        mod.pack_tasks = pack
    if rc != 0:
        raise SystemExit(f"ring_reach: the main path exited {rc}")
    return (f"the {n[0]} round tasks of the 16 x 80 kb main path "
            f"(--engine {engine})")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    layout = "round"
    if "--layout" in argv:
        layout = argv[argv.index("--layout") + 1]
        if layout not in ("round", "batch"):
            raise SystemExit(f"ring_reach: unknown layout {layout}")
    hist: collections.Counter = collections.Counter()
    what = (main_path(hist, layout) if "--main-path" in argv
            else seeded_tasks(hist, layout))
    total = sum(hist.values())
    share = {R: sum(v for d, v in hist.items() if d <= R) / total
             for R in BOUNDS}
    print(f"ring_reach: {total} predecessor reads over {what}")
    for R in BOUNDS:
        print(f"  d <= {R}: {share[R]:.6f}")
    print(json.dumps({"tool": "ring_reach", "source": what,
                      "reads": total, "max_d": max(hist),
                      "share": {str(R): s for R, s in share.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
