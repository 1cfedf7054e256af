"""One run of one cell: set-up, the measured window, the check.

Set-up builds the port's host libraries and one
`TorchPOAEngine(device="cuda", threads=1)`, finishes its warm-up (the
kernel library from `smoothxg_tpu_torch/_build/`, every `poa_win`
instantiation loaded, a launch of each variant the configuration uses),
writes the traffic's graphs under TMPDIR, and runs one warm job on a
graph of the traffic's shape outside the window's set (without it the
first job in the window ran 0.4-1.4 s slower than the same graph later,
in the host stages above all).  The window is a closed loop of whole
jobs, one graph at a time, each `run_smoothing(cfg, device="cuda", engine=...)` as
the CLI builds `cfg`; a job starts while the clock is under `--seconds`
and the window ends when the last one ends.  Then the check judges every
job's outputs (`reference/judge.py`)."""
from __future__ import annotations

import contextlib
import gc
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

from . import fillops, spec, trace
from .reference import judge, seqs
from .traffic import job_seed, make_graph, make_graphs, read_inputs

# the limits of the exact numbers; a configuration's file gives the rest
EXACT = ("jobs_failed", "paths_bad", "maf_rows_bad", "maf_cover_bad")


def log(msg: str) -> None:
    print(f"[port_bench] {msg}", file=sys.stderr, flush=True)


def host_usage() -> tuple:
    """This process's user and system CPU seconds: a job's log line sets
    them beside its wall time, to tell a slower host from a preempted
    process."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime, ru.ru_stime


def job_argv(config: dict, traffic: dict, gfa: str, out: str) -> list:
    return (["-g", gfa, "-o", os.path.join(out, "out.gfa"),
             "-m", os.path.join(out, "out.maf"), "-b", out,
             "-r", str(traffic["haplotypes"])] + list(config["argv"]))


def cli_config(argv: list):
    """A job's Config as the CLI builds it (`cli.run`): from the parser,
    add_consensus worked out the same way."""
    from smoothxg_tpu_torch.cli import build_parser, config_from_args
    args = build_parser().parse_args(argv)
    requires_consensus = not args.vanish_consensus
    if args.consensus_spec:
        from smoothxg_tpu_torch.pipeline.consensus_graph import \
            parse_consensus_spec
        _, requires_consensus = parse_consensus_spec(
            args.consensus_spec, requires_consensus)
    add_consensus = bool(args.write_consensus_path_names) or \
        requires_consensus
    return config_from_args(args, add_consensus)


def settings(config: dict, traffic: dict):
    """The Config every job of the cell shares but for its paths: what
    set-up and the check read of it (the band, the alignment mode, the
    consensus prefix) comes from the configuration's argv and nowhere
    else."""
    return cli_config(job_argv(config, traffic, "in.gfa", "."))


def run_job(engine, device, argv: list) -> None:
    """One job as the CLI runs it."""
    from smoothxg_tpu_torch.pipeline.run import run_smoothing
    run_smoothing(cli_config(argv), device=device, engine=engine)


def make_engine(cfg, device):
    """The engine, warmed up, and the port's host C++ libraries built
    (they build at first use, which would otherwise fall in the first
    run's window).  The warm-up launches the variants the jobs' blocks
    take: the run's own (as `pipeline/run.py:make_engine` warms it) and,
    with a --long-poa-band, the global banded one of the long blocks
    (`pipeline/smooth.py`)."""
    from smoothxg_tpu_torch.ops import _build
    from smoothxg_tpu_torch.ops.poa_engine import TorchPOAEngine
    for name in _build.HOST_NAMES:
        _build.host_lib(name)
    eng = TorchPOAEngine(device=device, threads=1)
    locals_ = {cfg.local_alignment and not cfg.use_abpoa}
    banded = {cfg.use_abpoa}
    if cfg.long_poa_band:
        locals_.add(False)
        banded.add(True)
    eng.warmup(locals_=tuple(sorted(locals_, reverse=True)),
               banded=tuple(sorted(banded)))
    return eng


def warm_job(engine, device, config: dict, tr: dict, work: str) -> None:
    """One job in set-up on the graph after the set's last (the same for
    every run), its outputs thrown away; a job that raises here raises
    in the window too, where it is counted."""
    g = make_graph(tr, job_seed(tr["set_seed"], tr["graphs"]),
                   os.path.join(work, "warm.gfa"))
    out = os.path.join(work, "warm")
    os.makedirs(out)
    try:
        run_job(engine, device, job_argv(config, tr, g["gfa"], out))
    except Exception as e:
        log(f"warm job failed: {type(e).__name__}: {e}")
    shutil.rmtree(out, ignore_errors=True)
    os.remove(g["gfa"])


def clock_mhz() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             t_proc: float, device: str = "cuda", engine_factory=None,
             root: str = spec.ROOT) -> dict:
    """Run one cell; returns the result line's object.  `t_proc` is the
    process's start on the perf_counter clock.  `engine_factory(cfg,
    device)` (cfg: `settings`), `device` and `root` (where BENCHMARK.json
    lies) let the tests drive a run on the CPU."""
    import torch
    c = spec.cell(name, root)
    c["root"] = root
    config, tr = c["config"], c["traffic"]
    cuda = device != "cpu"
    work = tempfile.mkdtemp(prefix="port_bench.")
    try:
        return _run(c, config, tr, seed, seconds, traced, t_proc, device,
                    cuda, engine_factory or make_engine, work, torch)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(c, config, tr, seed, seconds, traced, t_proc, device, cuda,
         engine_factory, work, torch) -> dict:
    cfg = settings(config, tr)
    t = time.perf_counter()
    engine = engine_factory(cfg, device)
    t_engine = time.perf_counter() - t
    t = time.perf_counter()
    graphs = make_graphs(tr, seed, work)
    t_graphs = time.perf_counter() - t
    t = time.perf_counter()
    warm_job(engine, device, config, tr, work)
    log(f"set-up: process start to the engine "
        f"{t - t_graphs - t_engine - t_proc:.3f} s, engine and host "
        f"libraries {t_engine:.3f} s, graphs {t_graphs:.3f} s, warm job "
        f"{time.perf_counter() - t:.3f} s")
    tracer = trace.Tracer() if traced else None
    if tracer:
        tracer.install()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    stats0 = dict(engine.stats()) if hasattr(engine, "stats") else {}
    jobs = []
    with tracer.window() if tracer else contextlib.nullcontext():
        t0 = time.perf_counter()
        setup_s = t0 - t_proc
        while time.perf_counter() - t0 < seconds:
            k = len(jobs)
            g = graphs[k % len(graphs)]
            out = os.path.join(work, f"job{k}")
            os.makedirs(out)
            u0 = host_usage()
            ts = time.perf_counter()
            err = None
            try:
                run_job(engine, device, job_argv(config, tr, g["gfa"], out))
            except Exception as e:          # a job that raises has failed
                err = f"{type(e).__name__}: {e}"
            te = time.perf_counter()
            du = [b - a for a, b in zip(u0, host_usage())]
            jobs.append({"graph": g, "out": out, "t0": ts - t0,
                         "t1": te - t0, "error": err})
            log(f"job {k}: graph seed {g['seed']}, {te - ts:.3f} s; cpu "
                f"user {du[0]:.2f} s, system {du[1]:.2f} s"
                + (f", failed: {err}" if err else ""))
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    mem_peak = torch.cuda.max_memory_allocated() if cuda else 0
    stats1 = dict(engine.stats()) if hasattr(engine, "stats") else {}
    if tracer:
        tracer.uninstall()
    bases = sum(read_inputs(j["graph"])["bases"] for j in jobs)
    mbp = bases / 1e6
    metrics = {}
    for m in c["end_to_end"]:
        if m["name"] == "smooth_Mbp_per_s":
            metrics[m["name"]] = {"value": mbp / window_s, "unit": m["unit"]}
        elif m["name"] == "setup_s":
            metrics[m["name"]] = {"value": setup_s, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(mem_peak)}
    result = {"correct": False, "attempted": len(jobs), "failed": 0,
              "metrics": {}, "device": dev_info}
    tr_red = tracer.reduce() if tracer else None
    # the program's state goes before the reference runs
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = check(jobs, cfg, seed, device)
    log(f"check: {time.perf_counter() - t_check:.3f} s, gaps "
        f"{[round(gp) for _, gp in readings['gaps']]}")
    if traced:
        ctx = {"window_s": window_s, "mbp": mbp, "jobs": jobs,
               "smooth": tracer.smooth, "trace": tr_red,
               "stats0": stats0, "stats1": stats1,
               "mem_peak_bytes": mem_peak,
               "fill": fill_work(jobs, cfg) if cuda else None,
               "sms": (torch.cuda.get_device_properties(0)
                       .multi_processor_count if cuda else None),
               "clock_mhz": clock_mhz() if cuda else None}
        metrics = {}
        for m in c["per_layer"]:
            v = spec.reader(m["name"], c["root"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["device"]["busy_s"] = trace.busy_s(
            (s, e) for _, s, e in tr_red["device"])
        result["device"]["window_s"] = tr_red["window_s"]
        result["breakdown"] = trace.breakdown(tr_red)
        log(f"trace reduced in {tr_red['reduce_s']:.3f} s")
    limits = config["limits"]
    gap_limit = limits.get("poa_gap_max")
    failed = {k for k, j in enumerate(jobs) if j["error"]} | \
        set(readings.pop("bad_jobs")) | \
        {a for a, gap in readings.pop("gaps")
         if gap_limit is not None and gap > gap_limit}
    readings["jobs_failed"] = len(failed)
    numbers = {k: {"value": readings[k], "limit": limits.get(k, 0)}
               for k in EXACT + tuple(limits)}
    ok = bool(jobs) and readings["poa_pairs"] > 0 and all(
        v["value"] is not None and v["value"] <= v["limit"]
        for v in numbers.values())
    result.update(correct=ok, failed=len(failed), metrics=metrics)
    result["checks"] = numbers
    for k, v in numbers.items():
        log(f"check {k} = {v['value']} (limit {v['limit']})")
    return result


def check(jobs: list, cfg, seed: int, device) -> dict:
    """The readings of `judge` over the window's jobs; `bad_jobs` lists
    the jobs whose paths or rows the check rejects."""
    js = [{"in_paths": j["graph"]["in_paths"],
           "out_gfa": os.path.join(j["out"], "out.gfa"),
           "out_maf": os.path.join(j["out"], "out.maf"),
           "error": j["error"]} for j in jobs]
    return judge.judge(js, cfg.consensus_path_prefix, seed, device)


def fill_work(jobs: list, cfg) -> dict:
    """The fill's int32 operations over every block of the window's jobs,
    counted from their MAFs (`fillops.block_work`); a block is banded as
    `pipeline/smooth.py` decides it."""
    band = cfg.long_poa_band
    ops = 0
    for j in jobs:
        if j["error"]:
            continue
        for rows in seqs.read_maf(os.path.join(j["out"], "out.maf")):
            uniq, pad, sizes = judge.block_rows(rows,
                                                cfg.consensus_path_prefix)
            banded = cfg.use_abpoa or (bool(band) and bool(sizes) and
                                       max(sizes) + 2 * pad > band)
            cells, pcells = fillops.block_work(uniq, pad, banded)
            ops += fillops.fill_ops(cells, pcells, not banded)
    return {"ops": ops}
