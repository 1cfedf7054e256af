"""The `-t N` pool's start, in fresh processes of the port's CLI whose
kernels and host libraries are already built, so that only the run's own
start (interpreter, imports, the pool's workers) differs between trees.

    python -m smoothxg_tpu_torch.tools.pool_start [TREE ...] [--reps R]
        [--flags="-l 700 -t 4" ...] [--bytes] [--common="..."]
        [--haplotypes H --length L]

Each TREE is the root of a checkout of the repo (by default this one). First
each tree's kernels (when the machine has a card) and host libraries are
built in its own smoothxg_tpu_torch/_build/, untimed. A rep then runs every
flag set on the trees in turns, forward then backward (a b b a), on the chip
smoke's deep pangenome (90 x 80 kb, seed 20261016) with `-r H -j 5k -e 5k`
and the set's flags. A run is `python child.py <flags>`, a script written
under smoke_out/pool_start/ that imports TREE's CLI at its top (so that
every spawned worker imports the CLI again as its main module, as under
`python -m smoothxg_tpu_torch.cli`) and wraps three functions of TREE's
package before the CLI runs: utils/procpool.get_pool (the pool's start), the
pool's worker initializer (a worker ready to take a task, its import time of
the CLI, whether it loaded torch) and pipeline/run.break_blocks (the breaks
phase). Each appends a line to a trace file. Per run: the whole wall on the
host clock, the pipeline's phase lines, each worker's ready time from the
pool's start, the first breaks phase's seconds and how far into it the last
worker became ready (at -t N > 1 breaks hands its chunks to the pool, so it
waits that long at least), and the GFA and MAF sha256. Each rep also times
`import smoothxg_tpu_torch.cli` and `import
smoothxg_tpu_torch.pipeline.breaks`, each alone in a fresh interpreter in
the tree. `--bytes` adds, on the last tree (the change, in `pool_start OLD
NEW`; `--reps 0 --bytes` runs only these), a `-l 700,900,1100 -t 1` run and
a `-t 1 -T 4` one (the finalize pool, prep at one thread), whose GFA and MAF
must be equal. `--common` flags go to every run. Ends with one JSON line.
The default engine needs CUDA; `--common="--engine native"` with a small
`--haplotypes` and `--length` rehearses the tool on a CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import shlex
import shutil
import subprocess
import sys
import time

from .cold_start import ROOT, SEED, _sha

TREE_ENV, TRACE_ENV = "POOL_START_TREE", "POOL_START_TRACE"

CHILD = f'''"""One traced CLI run of the tree named by {TREE_ENV}; written by
smoothxg_tpu_torch/tools/pool_start.py."""
import json
import os
import sys
import time

TREE, TRACE = os.environ["{TREE_ENV}"], os.environ["{TRACE_ENV}"]
sys.path.insert(0, TREE)
_t0 = time.perf_counter()
from smoothxg_tpu_torch import cli  # noqa: E402
CLI_IMPORT_S = time.perf_counter() - _t0
from smoothxg_tpu_torch.pipeline import run as _run  # noqa: E402
from smoothxg_tpu_torch.utils import procpool  # noqa: E402


def _event(what, **kw):
    kw.update(what=what, pid=os.getpid(), t=time.time())
    with open(TRACE, "a") as f:
        f.write(json.dumps(kw) + "\\n")


def _traced_init(init):
    def _init_worker():
        init()
        _event("ready", cli_import_s=CLI_IMPORT_S,
               torch="torch" in sys.modules)
    # pickled by name: a worker finds this wrapper where the pool's own
    # initializer was, since it runs this script before it unpickles
    _init_worker.__module__ = init.__module__
    _init_worker.__qualname__ = init.__qualname__
    return _init_worker


def _traced_get_pool(get_pool):
    def traced(n_workers):
        if procpool._POOL is None:
            _event("pool_start", n=n_workers)
        return get_pool(n_workers)
    return traced


def _traced_breaks(break_blocks):
    def traced(*args, **kw):
        _event("breaks_start")
        try:
            return break_blocks(*args, **kw)
        finally:
            _event("breaks_end")
    return traced


procpool._init_worker = _traced_init(procpool._init_worker)
procpool.get_pool = _traced_get_pool(procpool.get_pool)
_run.break_blocks = _traced_breaks(_run.break_blocks)

if __name__ == "__main__":
    _event("cli_imported", cli_import_s=CLI_IMPORT_S,
           torch="torch" in sys.modules)
    sys.exit(cli.main(sys.argv[1:]))
'''

IMPORT = ("import sys, time; sys.path.insert(0, sys.argv[1]); "
          "t = time.perf_counter(); import smoothxg_tpu_torch.{mod}; "
          "print(time.perf_counter() - t, 'torch' in sys.modules)")

BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from smoothxg_tpu_torch.ops import _build; "
         "[_build.host_lib(n) for n in _build.HOST_NAMES]; "
         "sys.argv[2] == '1' and _build.build()")


def _tag(tree: str) -> str:
    return os.path.relpath(os.path.abspath(tree), ROOT)


def build(tree: str, kernels: bool) -> float:
    """Build `tree`'s host libraries (and kernels): seconds."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", BUILD, tree,
                          "1" if kernels else "0"], capture_output=True,
                         text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"build of {tree} failed: {res.stderr[-2000:]}")
    return time.perf_counter() - t0


def import_time(tree: str, mod: str) -> dict:
    """`import smoothxg_tpu_torch.<mod>` alone in a fresh interpreter."""
    res = subprocess.run([sys.executable, "-c", IMPORT.format(mod=mod), tree],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"import of {mod} failed: {res.stderr[-2000:]}")
    s, torch_loaded = res.stdout.split()
    return {"s": float(s), "torch": torch_loaded == "True"}


def summarize(events: list[dict]) -> dict:
    """The pool's start, its workers' ready times and the first breaks
    phase, from one run's trace."""
    out: dict = {}
    start = next((e for e in events if e["what"] == "pool_start"), None)
    ready = [e for e in events if e["what"] == "ready"]
    if start is not None:
        out["pool_workers"] = start["n"]
        out["ready_s"] = sorted(e["t"] - start["t"] for e in ready)
        out["worker_cli_import_s"] = sorted(e["cli_import_s"] for e in ready)
        out["worker_torch"] = any(e["torch"] for e in ready)
    main = next((e for e in events if e["what"] == "cli_imported"), None)
    if main is not None:
        out["cli_import_s"] = main["cli_import_s"]
    b0 = next((e for e in events if e["what"] == "breaks_start"), None)
    b1 = next((e for e in events if e["what"] == "breaks_end"), None)
    if b0 is not None and b1 is not None:
        out["breaks_s"] = b1["t"] - b0["t"]
        if ready:
            out["ready_into_breaks_s"] = max(
                0.0, max(e["t"] for e in ready) - b0["t"])
    return out


def run(tree: str, work: str, gfa: str, args: list[str], child: str) -> dict:
    """One traced CLI run of `tree` in the fresh directory `work`."""
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    trace = os.path.join(work, "trace.jsonl")
    out, maf = (os.path.join(work, f"out.{x}") for x in ("gfa", "maf"))
    env = dict(os.environ, **{TREE_ENV: os.path.abspath(tree),
                              TRACE_ENV: trace})
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, child, "-g", gfa, "-o", out,
                          "-m", maf, *args], cwd=work, env=env,
                         capture_output=True, text=True, timeout=1800)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"{_tag(tree)} {args}: exit {res.returncode}: "
                           f"{res.stderr[-2000:]}")
    with open(trace) as f:
        events = [json.loads(ln) for ln in f]
    phases = [ln.split("] ", 1)[1] for ln in res.stderr.splitlines()
              if "done in" in ln]
    return {"tree": _tag(tree), "args": args, "wall_s": wall,
            **summarize(events), "phases": phases,
            "gfa": _sha(out), "maf": _sha(maf)}


def _line(k: int, r: dict) -> str:
    brk = next((p for p in r["phases"] if "breaking blocks" in p), "")
    ready = " ".join(f"{s:.2f}" for s in r.get("ready_s", []))
    imp = " ".join(f"{s:.2f}" for s in r.get("worker_cli_import_s", []))
    return (f"run {k} ({r['tree']}, {' '.join(r['args'])}): "
            f"{r['wall_s']:.2f} s wall; {brk}; the last worker ready "
            f"{r.get('ready_into_breaks_s', 0.0):.2f} s into it; workers "
            f"ready [{ready}] s after the pool's start, CLI imports [{imp}] "
            f"s, torch in one: {r.get('worker_torch')}; GFA {r['gfa']}, "
            f"MAF {r['maf']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", default=[ROOT])
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--flags", action="append", default=None,
                    help="a flag set of the timed runs (repeatable); "
                         "default: '-l 700 -t 4' and '-l 700 -t 8'")
    ap.add_argument("--bytes", action="store_true")
    ap.add_argument("--common", default="")
    ap.add_argument("--haplotypes", type=int, default=90)
    ap.add_argument("--length", type=int, default=80_000)
    args = ap.parse_args(argv)
    flag_sets = [shlex.split(f) for f in
                 (args.flags or ["-l 700 -t 4", "-l 700 -t 8"])]
    base_args = ["-r", str(args.haplotypes), "-j", "5k", "-e", "5k",
                 *shlex.split(args.common)]
    sys.path.insert(0, ROOT)
    import torch
    from smoothxg_tpu_torch.testing.synth import write_pangenome
    base = os.path.join(ROOT, "smoke_out", "pool_start")
    os.makedirs(base, exist_ok=True)
    child = os.path.join(base, "child.py")
    with open(child, "w") as f:
        f.write(CHILD)
    gfa = write_pangenome(os.path.join(base, "deep.gfa"),
                          haplotypes=args.haplotypes, length=args.length,
                          seed=SEED)
    kernels = torch.cuda.is_available()
    builds = {_tag(t): build(t, kernels) for t in args.trees}
    print(f"builds (s, untimed for the runs): {builds}", flush=True)
    runs, imports, k = [], [], 0
    for _ in range(args.reps):
        for flags in flag_sets:
            for tree in args.trees + args.trees[::-1]:
                r = run(tree, os.path.join(base, f"run{k}"), gfa,
                        base_args + flags, child)
                runs.append(r)
                print(_line(k, r), flush=True)
                k += 1
        for tree in args.trees + args.trees[::-1]:
            imp = {"tree": _tag(tree),
                   **{m: import_time(tree, m)
                      for m in ("cli", "pipeline.breaks")}}
            imports.append(imp)
            print(f"fresh import ({imp['tree']}): cli {imp['cli']}, "
                  f"pipeline.breaks {imp['pipeline.breaks']}", flush=True)
    same = None
    if args.bytes:
        pair = []
        for extra in (["-t", "1"], ["-t", "1", "-T", "4"]):
            r = run(args.trees[-1], os.path.join(base, f"run{k}"), gfa,
                    base_args + ["-l", "700,900,1100", *extra], child)
            runs.append(r)
            pair.append(r)
            print(_line(k, r), flush=True)
            k += 1
        same = all(pair[0][x] == pair[1][x] for x in ("gfa", "maf"))
        print(f"-t 1 -T 4 bytes equal to -t 1: {same}", flush=True)
    smi = "none (no card)"
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    print(json.dumps({"runs": runs, "imports": imports, "builds": builds,
                      "bytes_equal": same, "card": smi}))
    return 0 if same is not False else 1


if __name__ == "__main__":
    sys.exit(main())
