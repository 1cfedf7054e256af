"""Time the path-SGD layout of the prep stage on a seeded generator graph:
the native host backend (csrc/host/sgd.cpp, sequential) against the
batched route on the card (csrc/sgd.cu: a plan launch and a chain launch
an iteration), with each route's mean step rank-jump on the graph in a
shuffled node order (the quality bound of tests/test_parallel.py:186-208:
the card's within 1.2x of native's), the kernels' times an iteration by
CUDA events beside their bounds, the sha256 of the final x, and the rest
of prep (groom, toposort, chop) once.  Prints one line per measurement and
a JSON line.  Needs CUDA.

Usage: python -m smoothxg_tpu_torch.tools.time_sgd [haplotypes] [length]
       [--no-native] [--cpu-iters=N]
(default 64 5000000: the 64 x 5 Mb graph, 6,293,760 path steps;
--no-native skips the host backend, which takes minutes there;
--cpu-iters=N also times N iterations of the plain version on the host's
CPU, the route of device="cpu", and extrapolates them to 100)
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np

SEED = 1
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
# float operations of one term update in csrc/sgd.cu (d, mu, dx, mag,
# delta, rr, upd) and of its share of the fold (two adds, a divide and an
# add a node at most)
SGD_FLOPS_TERM = 20
# a dependent load and store through L2, rounded up from the probes'
# 143 ns L2 load (PERF.md rows 5-24)
L2_ROUND_TRIP_NS = 500.0


def shuffled(g, seed: int = 0):
    """`g` compacted into a random node order (seeded), so the sort has
    work to do: the generator's own order is already path-coherent."""
    ids = list(g.node_ids())
    perm = np.random.default_rng(seed).permutation(len(ids))
    return g.compact([ids[i] for i in perm])


def rank_jump(g, order) -> float:
    """Mean |rank difference| of consecutive path steps under `order`."""
    rank = np.empty(max(order) + 1, dtype=np.int64)
    rank[np.asarray(order)] = np.arange(len(order))
    tot = n = 0
    for steps in g.path_steps:
        r = rank[np.asarray(steps, dtype=np.int64) >> 1]
        tot += int(np.abs(np.diff(r)).sum())
        n += max(len(r) - 1, 0)
    return tot / max(n, 1)


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plan_bound(prob) -> tuple[float, str]:
    """(ms, by) of the plan kernel: its share of the iteration's inputs,
    the draws (9 B a term) and the step arrays (16 B a step) read once,
    against its float work (d and mu, 5 operations a term).  The plan it
    writes is this design's own traffic, which the replaced function
    (smoothxg_tpu/ops/sgd.py:49) never makes, so it is not counted."""
    return _bound(prob.B_pad * 9 + prob.T * 16, prob.B_pad * 5)


def chain_bound(prob) -> tuple[float, str]:
    """(ms, by) of the chain kernel: its share of the iteration's work, x
    read and written once, against the float work of a term's update and
    its share of the fold; the plan it reads is not counted (see
    plan_bound).  The two bounds together are at most the iteration's,
    sgd_bound."""
    return _bound(len(prob.x0) * 8, prob.B_pad * SGD_FLOPS_TERM)


def sgd_bound(prob) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time of one iteration
    (one launch): its inputs read once (the draws, 9 B a term; the step
    arrays, 16 B a step; x) and x written once, over the card's memory
    rate, against its float operations over the float32 rate."""
    return _bound(prob.B_pad * 9 + prob.T * 16 + len(prob.x0) * 8,
                  prob.B_pad * SGD_FLOPS_TERM)


def chain_floor_ms(prob, iter_max: int = 100) -> float:
    """The loop-carried floor of iter_max iterations: one dependent L2
    round trip (x read, then written) a minibatch."""
    return prob.B_pad // 1024 * iter_max * L2_ROUND_TRIP_NS * 1e-6


def time_kernel(torch, prob, dev, iter_max: int = 100):
    """The batched route through ops/sgd.py:sgd_steps, `sgd_solve`'s own
    loop, each step's call made as `sgd_iter` makes it, the plan kernel
    (`sgd_plan`) and then the chain kernel on that plan, with CUDA events
    around each: (final x, plan ms of each iteration, chain ms of each
    iteration)."""
    from ..ops import sgd
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
          for _ in range(iter_max)]
    for (e0, e1, e2), step in zip(ev, sgd.sgd_steps(prob, iter_max,
                                                    device=dev)):
        e0.record()
        plan = sgd.sgd_plan(*step.args[1:])
        e1.record()
        x = step(plan=plan)
        e2.record()
    torch.cuda.synchronize()
    return (x, [a.elapsed_time(b) for a, b, _ in ev],
            [b.elapsed_time(c) for _, b, c in ev])


def time_plain_cpu(prob, iters: int, iter_max: int = 100) -> dict:
    """The first `iters` iterations of the route's plain version on the
    host's CPU (`path_sgd_order(device="cpu")`, `run_smoothing(cfg,
    device="cpu")`): seconds an iteration for the draws and for
    `sgd_reference`, and their sum times iter_max, the whole route's
    estimate."""
    import torch
    from ..ops import sgd
    draws, plain = [], []
    steps = sgd.sgd_steps(prob, iter_max, device="cpu")
    for _ in range(iters):
        t0 = time.perf_counter()
        step = next(steps)
        t1 = time.perf_counter()
        step()
        plain.append(time.perf_counter() - t1)
        draws.append(t1 - t0)
    per_iter = (sum(draws) + sum(plain)) / iters
    return {"cpu_iters": iters, "cpu_threads": torch.get_num_threads(),
            "cpu_draws_s_iter": sum(draws) / iters,
            "cpu_plain_s_iter": sum(plain) / iters,
            "cpu_route_s_estimate": per_iter * iter_max}


def main(argv: list[str]) -> int:
    import torch

    from ..device import resolve
    from ..io.gfa import read_gfa
    from ..ops import sgd
    from ..testing.synth import write_pangenome
    args = [a for a in argv if not a.startswith("--")]
    H = int(args[0]) if args else 64
    L = int(args[1]) if len(args) > 1 else 5_000_000
    dev = resolve("cuda", what="time_sgd times the SGD kernel",
                  instead="it has no CPU mode")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        gfa = write_pangenome(os.path.join(work, "g.gfa"), haplotypes=H,
                              length=L, seed=SEED)
        g = shuffled(read_gfa(gfa).compact())
    prob = sgd.sgd_problem(g)
    out = {"graph": f"{H} x {L} bp, seed {SEED}", "steps": prob.T,
           "nodes": len(prob.x0), "B": prob.B, "B_pad": prob.B_pad,
           "device": torch.cuda.get_device_name(0)}
    print(f"graph {out['graph']}: {prob.T} path steps, {len(prob.x0)} "
          f"nodes, B {prob.B}, B_pad {prob.B_pad} "
          f"({time.perf_counter() - t0:.1f} s to make and read)", flush=True)
    before = rank_jump(g, list(g.node_ids()))
    from ..ops import _build
    _build.load()                    # build and load the kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, plan_ms, chain_ms = time_kernel(torch, prob, dev)
    card_s = time.perf_counter() - t0
    iters = [a + b for a, b in zip(plan_ms, chain_ms)]
    order = np.argsort(x.cpu().numpy().astype(np.float64), kind="stable")
    r_card = rank_jump(g, [prob.node_ids[i] for i in order])
    bound, by = sgd_bound(prob)
    pb, cb = plan_bound(prob), chain_bound(prob)
    out.update(card_sgd_s=card_s, kernel_ms_total=sum(iters),
               kernel_ms_iter=sum(iters) / len(iters),
               kernel_ms_iter_min=min(iters), kernel_ms_iter_max=max(iters),
               plan_ms_iter=sum(plan_ms) / len(plan_ms),
               chain_ms_iter=sum(chain_ms) / len(chain_ms),
               chain_ms_iter_min=min(chain_ms),
               chain_ms_iter_max=max(chain_ms),
               bound_ms_iter=bound, bound_by=by, plan_bound_ms=pb[0],
               chain_bound_ms=cb[0], chain_floor_ms=chain_floor_ms(prob),
               x_sha256=hashlib.sha256(x.cpu().numpy().tobytes()
                                       ).hexdigest(),
               rank_jump_input=before, rank_jump_card=r_card)
    print(f"card: SGD {card_s:.3f} s wall (draws + kernels), kernels "
          f"{sum(iters):.1f} ms over 100 iterations ({min(iters):.3f}-"
          f"{max(iters):.3f} ms an iteration): plan "
          f"{out['plan_ms_iter']:.3f} ms an iteration (bound {pb[0]:.4f} ms "
          f"by {pb[1]}), chain {out['chain_ms_iter']:.3f} ms "
          f"({min(chain_ms):.3f}-{max(chain_ms):.3f}; bound {cb[0]:.4f} ms "
          f"by {cb[1]}); the iteration's bound {bound:.4f} ms by {by}, "
          f"chain floor {out['chain_floor_ms']:.1f} ms for 100; rank-jump "
          f"{r_card:.3f} (input order {before:.1f}); x sha256 "
          f"{out['x_sha256'][:16]}", flush=True)
    cpu_iters = [int(a.split("=", 1)[1]) for a in argv
                 if a.startswith("--cpu-iters=")]
    if cpu_iters:
        out.update(time_plain_cpu(prob, cpu_iters[0]))
        print(f"plain version on the host's CPU ({out['cpu_threads']} "
              f"threads, {cpu_iters[0]} iterations): draws "
              f"{out['cpu_draws_s_iter']:.3f} s + sgd_reference "
              f"{out['cpu_plain_s_iter']:.3f} s an iteration; 100 "
              f"iterations ~{out['cpu_route_s_estimate']:.0f} s", flush=True)
    if "--no-native" not in argv:
        t0 = time.perf_counter()
        order = sgd.path_sgd_order(g, device="native")
        out["native_sgd_s"] = time.perf_counter() - t0
        out["rank_jump_native"] = rank_jump(g, order)
        print(f"native: SGD {out['native_sgd_s']:.3f} s wall, rank-jump "
              f"{out['rank_jump_native']:.3f}", flush=True)
    t0 = time.perf_counter()
    g2 = g.compact([prob.node_ids[i] for i in
                    np.argsort(x.cpu().numpy(), kind="stable")])
    o, flips = g2.groom()
    g2 = g2.compact(o, flips)
    g2 = g2.compact(g2.topological_order()).chop(100)
    out["rest_of_prep_s"] = time.perf_counter() - t0
    print(f"rest of prep (groom, toposort, chop): "
          f"{out['rest_of_prep_s']:.3f} s", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
