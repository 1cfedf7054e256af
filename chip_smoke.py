#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (smoothxg_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one line each or more; any failure exits nonzero and prints no
result:
  1. device: CUDA required; the card's name, power limit and SM clock.
  2. build:  csrc/*.cu (poa_win, poa_round, poa_code, poa_stacked)
     compiled from the checkout, one nvcc process per source started
     together and one link (each kernel's ptxas line); the port's
     host C++ libraries (csrc/host/*.cpp) with g++; the JAX package's
     native/ libraries, for the identity phase's reference subprocess only.
  3. kernel: >= 200 seeded blocks at every engine tier shape through the
     whole-block CUDA kernel and its plain PyTorch version (exact equality
     on meta, exp, paths), every block also held against the native C++
     engine; kernel time against the plain version's on a main-path block.
  4. main path: the port CLI (`-r 16 -j 5k -e 5k -l 700,900,1100 -m out.maf
     -t 1`) on a seeded 16 x 80 kb synthetic pangenome; exit 0 implies the
     lace validation passed; the kernel must carry >= 90% of the blocks.
  5. identity: the JAX package's CLI with --engine native on the same input
     in a subprocess (not an import); GFA and MAF sha256 must match.
  6. round kernel: >= 200 seeded round tasks (local and global, in-degree 1
     to 15, V up to ~4,000, L up to ~2,000, and two past the Pallas
     kernel's code packing: L > 2^15, V > 2^16) through the per-round CUDA
     kernel and its plain PyTorch version (exact equality on codes and
     meta), a subset decoded and held against the oracle poa_host.align;
     kernel time against the plain version's on a main-path task.
  7. round main path: the port CLI with --engine pallas and the same flags
     on the same input; >= 90% of the round tasks on the kernel, GFA and
     MAF sha256 equal to phase 5's.
  8. code kernel: >= 200 seeded blocks (local, global, banded, in-degree up
     to 8 and an overflowing 9, a few at the (8704, 4096) tier) through the
     code-chase CUDA kernel poa_code and its plain PyTorch version (exact
     equality), every block also held against the native engine; its time
     on phase 3's block and on a launch of 132 copies, beside poa_win's.
  9. code main path: run_smoothing with the same flags and
     TorchPOAEngine(shape=(8704, 4096)); >= 90% of the blocks on poa_code,
     GFA and MAF sha256 equal to phase 5's.
 10. stacked kernel: the same for poa_stacked (one warp per POA block,
     in-degree up to 4 and an overflowing 5, one launch of > 132 blocks).
 11. stacked main path: run_smoothing with TorchPOAEngine(kernel=
     "stacked"); >= 90% of the blocks on poa_stacked, identity as phase 9.
Every main path (4, 7, 9, 11) runs with all four kernels' launch counts
set to 0 just before it and read just after: its own kernel must have
launched and no other.  Then the kernels' JSON line, the nvidia-smi line
and the result line.  No module of jax or of the JAX package may be
loaded in this process.
"""
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SMOKE_DIR = os.path.join(HERE, "smoke_out")
SEED = 20261016
T0 = time.perf_counter()
MAIN_FLAGS = ["-r", "16", "-j", "5k", "-e", "5k", "-l", "700,900,1100",
              "-t", "1"]


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(f"[smoke +{time.perf_counter() - T0:.0f}s] {msg}", flush=True)


class Tee(io.StringIO):
    """Keeps a copy of what is written to a stream."""

    def __init__(self, stream):
        super().__init__()
        self.stream = stream

    def write(self, text):
        self.stream.write(text)
        return super().write(text)


def smoothing_phases(log: str) -> list:
    """The pipeline's 'smoothing N blocks done in X s' lines."""
    return [ln.split("] ", 1)[1] for ln in log.splitlines()
            if "] smoothing" in ln and "done in" in ln]


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# int32 operations per DP cell that the fill recurrence needs: the
# function's count, not either kernel's instruction count.  Both kernels
# fill the same recurrence (ops/poa_host.py:84-161), poa_win.cu inside the
# whole-block loop, poa_round.cu once per task:
#   substitution (compare, select, add)                    3
#   E1 and E2 (open, extend, max, floor at NEG)            4 + 4
#   Hq = max(M, E1, E2)                                    2
#   F1 and F2: F(j) = max(F(j-1) - ext, Hq(j-1) - open)    3 + 3
#   H = max(Hq, F1, F2)                                    2
#   local only: Hq floored at 0, the row maximum           1 + 1
# = 23 local, 21 global; plus 3 per cell for each predecessor row past the
# first (the maxima of H, E1 and E2 over the rows).  The graph work around
# the fill (poa_win's topological walk and threading, both kernels'
# tracebacks) is O(V + L) per alignment and not counted, so the bound
# stays a lower one.
OPS_CELL = {True: 23, False: 21}     # by local
OPS_PRED = 3


def fill_ops(cells: int, pcells: int, local: bool) -> int:
    """int32 operations of a fill of `cells` DP cells with `pcells` cells
    of predecessor rows past the first."""
    return OPS_CELL[local] * cells + OPS_PRED * pcells


def round_dp_work(graph, L: int) -> tuple:
    """(cells, pred cells) of one round task: V * (L + 1), and the cells
    of its predecessor rows past each node's first."""
    V = graph.n_nodes()
    extra = sum(len(ps) for ps in graph.preds) - V + graph.preds.count([])
    return V * (L + 1), extra * (L + 1)


def int32_bound_ms(ops: int, clock_mhz: float) -> float:
    """Least time for `ops` int32 operations on the card: 132 SMs x 64
    int32 lanes per clock at the SM clock (nvidia-smi clocks.max.sm).  The
    kernels' inputs and outputs are a few MB, far below this in time at
    3.35 TB/s, so the bound is by operations."""
    return ops / (132 * 64 * clock_mhz * 1e6) * 1e3


def win_dp_work(seqs, paths) -> tuple:
    """(cells, pred cells) the whole-block kernel fills for one block,
    from its sequences and their paths in the final graph: round r aligns
    sequence r against the graph of sequences 0..r-1, whose nodes are the
    union of their paths and whose edges are their consecutive steps; pred
    cells count each node's predecessors past the first."""
    nodes: set = set()
    preds: dict = {}
    cells = pcells = 0
    for r, (s, pth) in enumerate(zip(seqs, paths)):
        pth = [int(v) for v in pth]
        if r:
            cols = len(s) + 1
            cells += len(nodes) * cols
            pcells += sum(max(len(preds.get(v, ())) - 1, 0)
                          for v in nodes) * cols
        nodes.update(pth)
        for u, v in zip(pth, pth[1:]):
            preds.setdefault(v, set()).add(u)
    return cells, pcells


KERNELS = ("poa_win", "poa_round", "poa_code", "poa_stacked")


def wrappers() -> dict:
    """Each kernel's wrapper, which counts its launches, by name."""
    from smoothxg_tpu_torch.ops.poa_code import poa_code
    from smoothxg_tpu_torch.ops.poa_round import poa_round
    from smoothxg_tpu_torch.ops.poa_stacked import poa_stacked
    from smoothxg_tpu_torch.ops.poa_win import poa_win
    return {"poa_win": poa_win, "poa_round": poa_round,
            "poa_code": poa_code, "poa_stacked": poa_stacked}


def drive(run, own: str):
    """Run a main path with every kernel's launch count set to 0 just
    before and read just after.  Returns (run's result, `own`'s count);
    fails unless `own` launched and no other kernel did."""
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    out = run()
    counts = {k: w.launches for k, w in ws.items()}
    if counts[own] <= 0:
        fail(f"the {own} main path launched no {own} kernel")
    other = {k: v for k, v in counts.items() if k != own and v}
    if other:
        fail(f"the {own} main path launched other kernels: {other}")
    return out, counts[own]


def hold_to_plain(got, want, label: str) -> int:
    """Max abs error of a kernel's (meta, exp, paths) against its plain
    version's; fails on any difference (all outputs are integers)."""
    worst = 0
    for name, g, w in zip(("meta", "exp", "paths"), got, want):
        err = int((g.long() - w.long()).abs().max())
        worst = max(worst, err)
        if err:
            fail(f"{label}: kernel != plain version on {name}")
    return worst


def hold_to_native(native, blocks, p, got, label: str) -> int:
    """Every block the kernel did not flag against the native C++ engine's
    graph; returns how many were compared."""
    import numpy as np
    from smoothxg_tpu_torch.ops.poa_engine import rehydrate_device_raw
    graphs = native.poa_block_batch([(sq, [1] * len(sq), p)
                                     for sq in blocks])
    meta, exp, paths = (x.numpy() for x in got)
    n = 0
    for b, (sq, g) in enumerate(zip(blocks, graphs)):
        if meta[b, 1]:
            continue                 # overflow: the engine redoes it
        V = int(meta[b, 0])
        mine = rehydrate_device_raw(
            sq, [1] * len(sq),
            ((exp[b, 0, :V] & 0xFF).astype(np.int32), exp[b, 1, :V],
             exp[b, 2, :V], [paths[b, r, :len(s)]
                             for r, s in enumerate(sq)]))
        if (mine.base != g.base or mine.seq_paths != g.seq_paths
                or mine._topo != g._topo or mine.group != g.group):
            fail(f"{label}: kernel != native engine on block {b}")
        n += 1
    return n


def time_kernel(torch, kern, ins, caps, reps: int = 5):
    """(ms per launch by CUDA events over `reps` launches after a warm
    one, the last outputs)."""
    kern(*ins, caps)
    torch.cuda.synchronize()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    for _ in range(reps):
        got = kern(*ins, caps)
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps, got


def time_copies(torch, kern, ins, caps, copies: int = 132) -> float:
    """ms of one launch of `copies` copies of a one-block batch (one per
    SM), after a warm one."""
    insB = [x.repeat((copies,) + (1,) * (x.dim() - 1)).contiguous()
            for x in ins]
    ms, _ = time_kernel(torch, kern, insB, caps, reps=1)
    return ms


FULL_COPIES = 1056          # 8 POA blocks per SM of a 132-SM card
FULL_CAPS = (1280, 1024)    # (VW, LW) sized to the 16 x ~1 kb timing block


def time_full_card(torch, dev, kern, mkcaps, blk, p) -> float:
    """ms of one launch of FULL_COPIES copies of the timing block at
    FULL_CAPS (after a warm one); fails if a copy overflows them."""
    from smoothxg_tpu_torch.ops.poa_win import pack_blocks
    ins = [x.to(dev) for x in pack_blocks([(blk, p)], FULL_CAPS[1])]
    caps = mkcaps(*FULL_CAPS)
    meta = kern(*ins, caps)[0]
    if int(meta[0, 1]):
        fail(f"the timing block overflows {FULL_CAPS}")
    ms = time_copies(torch, kern, ins, caps, copies=FULL_COPIES)
    torch.cuda.empty_cache()
    return ms


def kernel_phase(torch, dev, clock_mhz):
    """Phase 3.  Returns the kernel's JSON entry fields and its timing
    (block, ms, batch_ms) for phases 8 and 10."""
    import numpy as np
    from smoothxg_tpu_torch.ops.poa_engine import POAParams, TorchPOAEngine
    from smoothxg_tpu_torch.ops.poa_win import (WinCaps, pack_blocks,
                                                poa_win, poa_win_reference)
    from smoothxg_tpu_torch.testing.synth import make_block
    rng = np.random.default_rng(SEED)
    native = TorchPOAEngine(device=dev).fallback
    tiers = TorchPOAEngine.TIERS
    # (tier, local, banded, blocks, (min L, max L), seqs per block, div)
    plan = [(0, True, False, 70, (150, 500), (3, 7), 0.02),
            (0, False, False, 70, (150, 500), (3, 7), 0.02),
            (1, True, False, 20, (300, 900), (3, 6), 0.03),
            (1, False, False, 10, (300, 900), (3, 6), 0.03),
            (2, True, False, 10, (1800, 2600), (3, 4), 0.01),
            (2, False, False, 6, (1800, 2600), (3, 4), 0.01),
            (3, True, False, 6, (3000, 3800), (2, 3), 0.01),
            (3, False, False, 4, (3000, 3800), (2, 3), 0.01),
            (4, False, True, 4, (3600, 4400), (5, 5), 0.01)]
    n_blocks = n_cmp = 0
    max_err = 0
    for ti, local, banded, nb, (lo, hi), (smin, smax), div in plan:
        VW, LW, W = tiers[ti]
        p = POAParams(local=local, wb=311 if banded else -1)
        blocks = [make_block(rng, int(rng.integers(lo, hi)),
                             int(rng.integers(smin, smax + 1)), div)
                  for _ in range(nb)]
        ins = pack_blocks([(sq, p) for sq in blocks], LW)
        caps = WinCaps(VW, LW, W, local, banded)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        got = poa_win(*(x.to(dev) for x in ins), caps)
        torch.cuda.synchronize()
        per_block = (torch.cuda.max_memory_allocated(dev) - before) / nb
        got = [x.cpu() for x in got]
        want = poa_win_reference(*ins, caps)
        max_err = max(max_err, hold_to_plain(
            got, want, f"tier {ti} local={local} banded={banded}"))
        n_cmp += hold_to_native(native, blocks, p, got, f"tier {ti}")
        n_blocks += nb
        say(f"kernel tier V{VW}xL{LW}xW{W} local={local} banded={banded}: "
            f"{nb} blocks equal to the plain version, "
            f"{int((got[0][:, 1] == 0).sum())} equal to native; peak device "
            f"memory {per_block / 1e6:.1f} MB per block of the launch")
    if n_blocks < 200:
        fail(f"only {n_blocks} blocks compared")

    # timing on a main-path block shape: 16 sequences of ~1 kb (-l 1100)
    VW, LW, W = tiers[0]
    p = POAParams(local=True)
    blk = make_block(rng, 1000, 16, 0.01)
    one = [(blk, [1] * 16, p)]
    cpu_ins = pack_blocks([(blk, p)], LW)
    caps = WinCaps(VW, LW, W, True, False)
    t0 = time.perf_counter()
    want = poa_win_reference(*cpu_ins, caps)
    plain_ms = (time.perf_counter() - t0) * 1e3
    ins = [x.to(dev) for x in cpu_ins]
    ms, got = time_kernel(torch, poa_win, ins, caps)
    if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        fail("kernel != plain version on the timing block")
    # a full batch: 132 copies (one per SM), per-block cost; and a full
    # card, 8 copies per SM
    batch_ms = time_copies(torch, poa_win, ins, caps)
    full_ms = time_full_card(
        torch, dev, poa_win,
        lambda VW, LW: WinCaps(VW, LW, LW, True, False), blk, p)
    t0 = time.perf_counter()
    for _ in range(4):
        native.poa_block_batch(one)
    native_ms = (time.perf_counter() - t0) * 1e3 / 4
    cells, pcells = win_dp_work(blk, [want[2][0, r, :len(s)].tolist()
                                      for r, s in enumerate(blk)])
    bound_ms = int32_bound_ms(fill_ops(cells, pcells, True), clock_mhz)
    say(f"kernel timing, one 16 x ~1 kb local block (V={int(want[0][0, 0])}):"
        f" kernel {ms:.3f} ms, plain version {plain_ms:.1f} ms, native C++ "
        f"single thread {native_ms:.1f} ms ({1e3 / native_ms:.2f} blocks/s);"
        f" 132-block launch {batch_ms:.1f} ms "
        f"({132e3 / batch_ms:.1f} blocks/s); {FULL_COPIES} copies at "
        f"V{FULL_CAPS[0]}xL{FULL_CAPS[1]} {full_ms:.1f} ms "
        f"({FULL_COPIES * 1e3 / full_ms:.1f} blocks/s); "
        f"bound {bound_ms:.4f} ms "
        f"({cells} DP cells, {pcells} extra pred cells, "
        f"{OPS_CELL[True]}/cell + {OPS_PRED}/pred int32 ops at "
        f"{clock_mhz:.0f} MHz)")
    say(f"kernel vs plain version: {n_blocks} blocks equal (max abs err "
        f"{max_err}, tolerance 0: all outputs are integers), {n_cmp} equal "
        f"to the native engine")
    return ({"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": "operations",
             "library_ms": None},
            {"block": blk, "ms": ms, "batch_ms": batch_ms,
             "full_ms": full_ms})


def round_phase(torch, dev, clock_mhz):
    """Phase 6.  Returns the round kernel's JSON entry fields."""
    import numpy as np
    from smoothxg_tpu_torch.ops import poa_host
    from smoothxg_tpu_torch.ops.poa_round import (decode_moves, pack_tasks,
                                                  poa_round,
                                                  poa_round_reference)
    from smoothxg_tpu_torch.testing.synth import (make_fan_in_task,
                                                  make_round_task)
    rng = np.random.default_rng(SEED + 1)
    # (local, tasks, (min L, max L), sequences in the graph + 1, div)
    plan = [(True, 60, (150, 600), (3, 8), 0.03),
            (False, 60, (150, 600), (3, 8), 0.03),
            (True, 30, (600, 1200), (4, 12), 0.05),
            (False, 30, (600, 1200), (4, 12), 0.05),
            (True, 6, (1800, 2000), (10, 12), 0.12),
            (False, 6, (1800, 2000), (10, 12), 0.12)]
    groups = []
    for local, nt, (lo, hi), (smin, smax), div in plan:
        p = poa_host.POAParams(local=local)
        groups.append((local, [make_round_task(
            rng, int(rng.integers(lo, hi)), int(rng.integers(smin, smax + 1)),
            div, p) for _ in range(nt)]))
    for local in (True, False):
        p = poa_host.POAParams(local=local)
        groups.append((local, [make_fan_in_task(rng, w, 200, p)
                               for w in range(2, 16)]))
    # past the Pallas kernel's 15/16-bit code packing: a local query longer
    # than 2^15 that ends in the graph's sequence (read from global memory,
    # not shared), and a global query against a chain of more than 2^16
    # nodes
    p = poa_host.POAParams(local=True)
    g, q, _ = make_round_task(rng, 200, 2, 0.03, p)
    groups.append((True, [(g, np.concatenate(
        [rng.choice(np.frombuffer(b"ACGT", np.uint8), 1 << 15), q]), p)]))
    p = poa_host.POAParams(local=False)
    g, q, _ = make_round_task(rng, 66_000, 2, 0.01, p)
    groups.append((False, [(g, q[30_000:30_060].copy(), p)]))
    n_tasks = n_dec = max_err = 0
    degrees: set = set()
    vmax = lmax = 0
    for local, tasks in groups:
        ins, orders = pack_tasks(tasks)
        got = poa_round(*(x.to(dev) for x in ins), local)
        torch.cuda.synchronize()
        got = [x.cpu() for x in got]
        want = poa_round_reference(*ins, local)
        for name, g, w in zip(("codes", "meta"), got, want):
            err = int((g.long() - w.long()).abs().max())
            max_err = max(max_err, err)
            if err:
                fail(f"round kernel != plain version on {name} "
                     f"(local={local}, VW {ins[3].shape[1]})")
        codes, meta = (x.numpy() for x in got)
        if meta[:, 2].any():
            fail(f"round kernel flagged {int((meta[:, 2] != 0).sum())} "
                 f"seeded tasks")
        for b in range(0, len(tasks), 8):
            if decode_moves(codes[b], int(meta[b, 0]), orders[b]) != \
                    poa_host.align(*tasks[b]):
                fail(f"round kernel moves != poa_host.align on task {b}")
            n_dec += 1
        for g, q, _ in tasks:
            degrees.update(len(ps) for ps in g.preds)
            vmax, lmax = max(vmax, g.n_nodes()), max(lmax, len(q))
        n_tasks += len(tasks)
        say(f"round kernel local={local}: {len(tasks)} tasks (VW "
            f"{ins[3].shape[1]}, LS {ins[6].shape[1]}, P {ins[5].shape[2]}) "
            f"equal to the plain version")
    if n_tasks < 200:
        fail(f"only {n_tasks} round tasks compared")
    if not set(range(1, 9)) <= degrees or max(degrees) <= 8:
        fail(f"in-degrees covered: {sorted(degrees)}")

    # timing on a main-path task shape: a ~1 kb query against a graph of
    # seven ~1 kb sequences (V ~ 1,200)
    p = poa_host.POAParams(local=True)
    task = make_round_task(rng, 1000, 8, 0.03, p)
    cpu_ins, _ = pack_tasks([task])
    t0 = time.perf_counter()
    want = poa_round_reference(*cpu_ins, True)
    plain_ms = (time.perf_counter() - t0) * 1e3
    ins = [x.to(dev) for x in cpu_ins]
    poa_round(*ins, True)
    torch.cuda.synchronize()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps = 5
    ev0.record()
    for _ in range(reps):
        got = poa_round(*ins, True)
    ev1.record()
    torch.cuda.synchronize()
    ms = ev0.elapsed_time(ev1) / reps
    if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        fail("round kernel != plain version on the timing task")
    nb = 264
    insB = [x.repeat((nb,) + (1,) * (x.dim() - 1)).contiguous() for x in ins]
    poa_round(*insB, True)
    ev0.record()
    poa_round(*insB, True)
    ev1.record()
    torch.cuda.synchronize()
    batch_ms = ev0.elapsed_time(ev1)
    cells, pcells = round_dp_work(task[0], len(task[1]))
    bound_ms = int32_bound_ms(fill_ops(cells, pcells, True), clock_mhz)
    say(f"round kernel timing, one main-path task (V={task[0].n_nodes()}, "
        f"L={len(task[1])}, local): kernel {ms:.3f} ms, plain version "
        f"{plain_ms:.1f} ms; {nb}-task launch {batch_ms:.1f} ms "
        f"({nb * 1e3 / batch_ms:.1f} tasks/s); bound {bound_ms:.4f} ms "
        f"({cells} DP cells, {pcells} extra pred cells)")
    say(f"round kernel vs plain version: {n_tasks} tasks equal (max abs err "
        f"{max_err}, tolerance 0: all outputs are integers), {n_dec} decoded "
        f"equal to poa_host.align; in-degrees {min(degrees)}-{max(degrees)}, "
        f"V up to {vmax}, L up to {lmax}")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations",
            "library_ms": None}


def chase_phase(torch, dev, clock_mhz, name: str, timing: dict):
    """Phases 8 and 10: poa_code or poa_stacked against its plain version
    and the native engine on >= 200 seeded blocks, then timed on phase 3's
    block and on 132 copies of it, beside poa_win's times (`timing`).
    Returns the kernel's JSON entry fields."""
    import numpy as np
    from smoothxg_tpu_torch.ops.poa_code import (CodeCaps, poa_code,
                                                 poa_code_reference)
    from smoothxg_tpu_torch.ops.poa_engine import POAParams, TorchPOAEngine
    from smoothxg_tpu_torch.ops.poa_stacked import (poa_stacked,
                                                    poa_stacked_reference,
                                                    stacked_caps)
    from smoothxg_tpu_torch.ops.poa_win import pack_blocks
    from smoothxg_tpu_torch.testing.synth import make_block, make_fan_in_block
    if name == "poa_code":
        kern, ref, held, big = poa_code, poa_code_reference, 8, (8704, 4096)

        def mkcaps(VW, LW, local, banded):
            return CodeCaps(VW, LW, local, banded)
    else:
        kern, ref, held, big = (poa_stacked, poa_stacked_reference, 4,
                                (4352, 2048))
        mkcaps = stacked_caps
    rng = np.random.default_rng(SEED + (2 if name == "poa_code" else 3))
    native = TorchPOAEngine(device=dev).fallback
    # (VW, LW, local, wb, blocks, (min L, max L), seqs per block, div); the
    # first launch holds more than 132 blocks, so poa_stacked packs 2 warps
    # per thread block; wb 10 is a band narrower than the rows
    plan = [(1024, 512, True, -1, 140, (20, 80), (2, 4), 0.04),
            (1024, 512, False, -1, 50, (60, 220), (3, 6), 0.03),
            (2048, 512, True, 10, 15, (150, 300), (3, 5), 0.03),
            (2048, 512, False, 10, 15, (150, 300), (3, 5), 0.03),
            (*big, True, -1, 3, (600, 1000), (3, 4), 0.02),
            (*big, False, -1, 3, (600, 1000), (3, 4), 0.02)]
    groups = [((VW, LW, local, wb), [
        make_block(rng, int(rng.integers(lo, hi)),
                   int(rng.integers(smin, smax + 1)), div)
        for _ in range(nb)])
        for VW, LW, local, wb, nb, (lo, hi), (smin, smax), div in plan]
    # in-degree 2 .. held + 1: the last one overflows the predecessor slots
    fans = [make_fan_in_block(rng, w, 60) for w in range(2, held + 2)]
    groups += [((1024, 512, True, -1), fans), ((1024, 512, False, -1), fans)]
    n_blocks = n_native = max_err = 0
    for gi, ((VW, LW, local, wb), blocks) in enumerate(groups):
        p = POAParams(local=local, wb=wb)
        ins = pack_blocks([(sq, p) for sq in blocks], LW)
        caps = mkcaps(VW, LW, local, wb >= 0)
        got = kern(*(x.to(dev) for x in ins), caps)
        torch.cuda.synchronize()
        got = [x.cpu() for x in got]
        want = ref(*ins, caps)
        label = f"{name} V{VW}xL{LW} local={local} wb={wb}"
        max_err = max(max_err, hold_to_plain(got, want, label))
        n_native += hold_to_native(native, blocks, p, got, label)
        flags = got[0][:, 1].tolist()
        if gi >= len(plan) and flags != [0] * (held - 1) + [1]:
            fail(f"{label}: fan-in overflow flags {flags}")
        n_blocks += len(blocks)
        say(f"{label}: {len(blocks)} blocks equal to the plain version "
            f"({sum(flags)} flagged for the native redo), "
            f"{len(blocks) - sum(flags)} equal to native")
    if n_blocks < 200:
        fail(f"only {n_blocks} blocks compared")

    blk = timing["block"]
    p = POAParams(local=True)
    cpu_ins = pack_blocks([(blk, p)], 2048)
    caps = mkcaps(4352, 2048, True, False)
    t0 = time.perf_counter()
    want = ref(*cpu_ins, caps)
    plain_ms = (time.perf_counter() - t0) * 1e3
    if int(want[0][0, 1]):
        fail(f"{name}: phase 3's timing block overflows")
    ins = [x.to(dev) for x in cpu_ins]
    ms, got = time_kernel(torch, kern, ins, caps)
    if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        fail(f"{name} != plain version on the timing block")
    batch_ms = time_copies(torch, kern, ins, caps)
    torch.cuda.empty_cache()
    full_ms = time_full_card(torch, dev, kern,
                             lambda VW, LW: mkcaps(VW, LW, True, False),
                             blk, p)
    cells, pcells = win_dp_work(blk, [want[2][0, r, :len(s)].tolist()
                                      for r, s in enumerate(blk)])
    bound_ms = int32_bound_ms(fill_ops(cells, pcells, True), clock_mhz)
    say(f"{name} timing on phase 3's block (V={int(want[0][0, 0])}, caps "
        f"V4352xL2048): kernel {ms:.3f} ms vs poa_win {timing['ms']:.3f} ms;"
        f" 132-block launch {batch_ms:.1f} ms ({132e3 / batch_ms:.1f} "
        f"blocks/s) vs poa_win {timing['batch_ms']:.1f} ms; "
        f"{FULL_COPIES} copies at V{FULL_CAPS[0]}xL{FULL_CAPS[1]} "
        f"{full_ms:.1f} ms ({FULL_COPIES * 1e3 / full_ms:.1f} blocks/s) vs "
        f"poa_win {timing['full_ms']:.1f} ms; plain version "
        f"{plain_ms:.1f} ms; bound {bound_ms:.4f} ms")
    say(f"{name} vs plain version: {n_blocks} blocks equal (max abs err "
        f"{max_err}, tolerance 0: all outputs are integers), {n_native} "
        f"equal to the native engine")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations",
            "library_ms": None}


def block_main_path(tag: str, own: str, run, clock_mhz) -> int:
    """Phases 4, 9 and 11: one run of the block engine's main path through
    `run` (returns (exit code, engine)), counted by `drive`; a spy keeps
    each block's sequences and final paths for the DP work of the launches
    (read after the wall is taken).  Returns the kernel's launches."""
    from smoothxg_tpu_torch.ops.poa_engine import TorchPOAEngine
    seen = []
    batch = TorchPOAEngine.poa_block_batch

    def spy(self, blocks):
        graphs = batch(self, blocks)
        seen.extend((b[0], g.seq_paths, b[2].local)
                    for b, g in zip(blocks, graphs))
        return graphs

    TorchPOAEngine.poa_block_batch = spy
    log = Tee(sys.stderr)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(log):
            (rc, engine), launches = drive(run, own)
    finally:
        TorchPOAEngine.poa_block_batch = batch
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"{tag} exited {rc}")
    st = engine.stats()
    total = st["device_blocks"] + st["fallbacks"] + st["redo"]
    work = [(*win_dp_work(sq, pth), local) for sq, pth, local in seen]
    cells, pcells = (sum(w[i] for w in work) for i in (0, 1))
    bound = int32_bound_ms(sum(fill_ops(*w) for w in work), clock_mhz)
    say(f"{tag}: {wall:.2f} s wall, {total} blocks, "
        f"{total / wall:.2f} blocks/s end to end "
        f"({'; '.join(smoothing_phases(log.getvalue()))}); "
        f"stats {json.dumps(st)}; {own} launches {launches}; DP work of "
        f"its {len(seen)} blocks {cells} cells, {pcells} extra pred cells, "
        f"bound {bound:.3f} ms")
    if st["device_blocks"] < 0.9 * total:
        fail(f"{tag}: only {st['device_blocks']}/{total} blocks ran on "
             f"the GPU")
    return launches


def same_bytes(tag: str, out: str, maf: str, ref_out: str,
               ref_maf: str) -> None:
    """GFA and MAF sha256 of a port run against phase 5's native run."""
    same = sha256(out) == sha256(ref_out) and sha256(maf) == sha256(ref_maf)
    say(f"{tag} identity: GFA sha256 {sha256(out)[:16]} vs "
        f"{sha256(ref_out)[:16]}, MAF sha256 {sha256(maf)[:16]} vs "
        f"{sha256(ref_maf)[:16]} (--engine native, phase 5)")
    if not same:
        fail(f"{tag} output differs from the native engine's")


def engine_run(gfa: str, out: str, maf: str, engine):
    """The main path through the API with a pre-built engine:
    run_smoothing(config_from_args(<the CLI's flags>), engine=engine)."""
    from smoothxg_tpu_torch import cli
    from smoothxg_tpu_torch.pipeline.run import run_smoothing
    args = cli.build_parser().parse_args(["-g", gfa, "-o", out, "-m", maf,
                                          *MAIN_FLAGS])
    cfg = cli.config_from_args(args, add_consensus=not args.vanish_consensus)
    return lambda: (0, run_smoothing(cfg, engine=engine)[2])


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke test needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(HERE, "smoothxg_tpu_torch")):
        fail("smoothxg_tpu_torch not found: run from a checkout of the repo")
    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    smi = smi[0] if smi else "nvidia-smi: no output"
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True,
                         timeout=60).stdout.split()
    try:
        clock_mhz = float(clk[0])
    except (IndexError, ValueError):
        fail(f"nvidia-smi gave no max SM clock: {clk}")
    say(f"device: {kind} ({smi}, max SM clock {clock_mhz:.0f} MHz), torch "
        f"{torch.__version__}, cuda {torch.version.cuda}, count "
        f"{torch.cuda.device_count()}")

    from smoothxg_tpu_torch.ops import _build
    from smoothxg_tpu_torch.ops.poa_engine import TorchPOAEngine
    t0 = time.perf_counter()
    _build.load()
    t_cuda = time.perf_counter() - t0
    ptxas = _build.build_log["ptxas"].splitlines()
    regs = {}
    for name in KERNELS:
        at = [i for i, ln in enumerate(ptxas)
              if "Compiling entry function" in ln and f"{name}_kernel" in ln]
        used = [ln.strip() for ln in ptxas[at[0]:] if "registers" in ln] \
            if at else []
        regs[name] = used[0] if used else "ptxas: no report"
    say(f"build: CUDA kernels, one nvcc per source for sm_90a started "
        f"together and one link, {t_cuda:.2f} s ({_build.lib_path()}); "
        + "; ".join(f"{n}_kernel: {regs[n]}" for n in KERNELS))
    # the port's host C++ libraries build with g++ at first use; build
    # them here so the main paths' walls are not charged for them
    for name in ("graphcore", "cpoa", "sgd", "wfa"):
        if _build.host_lib(name) is None:
            fail(f"g++ build of csrc/host/{name}.cpp failed")
    say(f"build: the port's host libraries from csrc/host/ with g++: "
        + ", ".join(f"{n} {t:.2f} s" for n, t in
                    _build.host_build_log.items()))
    t0 = time.perf_counter()
    res = subprocess.run(["make", "-C", os.path.join(HERE, "native")],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        fail(f"native build failed: {res.stderr[-800:]}")
    say(f"build: the JAX package's native/ libraries with make, "
        f"{time.perf_counter() - t0:.2f} s, for the identity phase's "
        f"reference subprocess only (the port never loads them)")

    entries = {}
    entries["poa_win"], timing = kernel_phase(torch, dev, clock_mhz)
    torch.cuda.empty_cache()

    from smoothxg_tpu_torch import cli
    from smoothxg_tpu_torch.testing.synth import write_pangenome
    os.makedirs(SMOKE_DIR, exist_ok=True)
    gfa = write_pangenome(os.path.join(SMOKE_DIR, "pangenome.gfa"),
                          haplotypes=16, length=80_000, snv_rate=0.01,
                          indel_rate=0.001, sv_count=4, seed=SEED)

    def outs(tag):
        return (os.path.join(SMOKE_DIR, f"{tag}.gfa"),
                os.path.join(SMOKE_DIR, f"{tag}.maf"))

    out, maf = outs("port")
    launches = {}
    launches["poa_win"] = block_main_path(
        "main path", "poa_win",
        lambda: cli.run(["-g", gfa, "-o", out, "-m", maf, *MAIN_FLAGS]),
        clock_mhz)

    out2, maf2 = outs("native")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "smoothxg_tpu.cli", "-g", gfa, "-o", out2,
         "-m", maf2, *MAIN_FLAGS, "--engine", "native"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=900)
    nwall = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"native reference run exited {res.returncode}: "
             f"{res.stderr[-800:]}")
    say(f"identity: native engine run {nwall:.2f} s "
        f"({'; '.join(smoothing_phases(res.stderr))})")
    same_bytes("main path", out, maf, out2, maf2)

    entries["poa_round"] = round_phase(torch, dev, clock_mhz)

    from smoothxg_tpu_torch.ops.poa_round import TorchRoundPOAEngine
    out3, maf3 = outs("round")
    # each launch's DP work, counted from its tasks as it launches (the
    # graphs grow after the round)
    rwork = []
    launch = TorchRoundPOAEngine._launch

    def round_spy(self, tasks, chunk, local):
        rwork.extend((*round_dp_work(tasks[t][0], len(tasks[t][1])), local)
                     for t in chunk)
        return launch(self, tasks, chunk, local)

    TorchRoundPOAEngine._launch = round_spy
    log = Tee(sys.stderr)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(log):
            (rc, engine), launches["poa_round"] = drive(
                lambda: cli.run(["-g", gfa, "-o", out3, "-m", maf3,
                                 *MAIN_FLAGS, "--engine", "pallas"]),
                "poa_round")
    finally:
        TorchRoundPOAEngine._launch = launch
    rwall = time.perf_counter() - t0
    if rc != 0:
        fail(f"port CLI --engine pallas exited {rc}")
    st = engine.stats()
    tasks = st["device_tasks"] + st["fallbacks"]
    on_kernel = st["device_tasks"] - st["stuck_fallbacks"]
    rcells, rpcells = (sum(w[i] for w in rwork) for i in (0, 1))
    rbound = int32_bound_ms(sum(fill_ops(*w) for w in rwork), clock_mhz)
    say(f"round main path (--engine pallas): {rwall:.2f} s wall, {tasks} "
        f"round tasks, {on_kernel} on the kernel, "
        f"{launches['poa_round']} launches, "
        f"device_wait_s {st['device_wait_s']} "
        f"({'; '.join(smoothing_phases(log.getvalue()))}); "
        f"stats {json.dumps(st)}; DP work of its {len(rwork)} launched "
        f"tasks {rcells} cells, {rpcells} extra pred cells, bound "
        f"{rbound:.3f} ms")
    if on_kernel < 0.9 * tasks:
        fail(f"only {on_kernel}/{tasks} round tasks ran on the kernel")
    same_bytes("round main path", out3, maf3, out2, maf2)

    # phases 8-11: the code-chase kernels and their main paths
    for name, tag, make in (
            ("poa_code", "code",
             lambda: TorchPOAEngine(device=dev, shape=(8704, 4096))),
            ("poa_stacked", "stacked",
             lambda: TorchPOAEngine(device=dev, kernel="stacked"))):
        entries[name] = chase_phase(torch, dev, clock_mhz, name, timing)
        o, m = outs(tag)
        launches[name] = block_main_path(
            f"{tag} main path ({name})", name,
            engine_run(gfa, o, m, make()), clock_mhz)
        same_bytes(f"{tag} main path", o, m, out2, maf2)
        torch.cuda.empty_cache()

    loaded = sorted(m for m in sys.modules if m == "jax"
                    or m.startswith(("jax.", "smoothxg_tpu."))
                    or m == "smoothxg_tpu")
    if loaded:
        fail(f"the port loaded jax or the JAX package: {loaded[:5]}")

    replaces = {"poa_win": "smoothxg_tpu/ops/poa_pallas_win.py:64",
                "poa_round": "smoothxg_tpu/ops/poa_pallas.py:54",
                "poa_code": "smoothxg_tpu/ops/poa_pallas_fused.py:86",
                "poa_stacked": "smoothxg_tpu/ops/poa_pallas_stacked.py:79"}
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda",
         "source": f"smoothxg_tpu_torch/csrc/{n}.cu",
         "replaces": replaces[n], "launches": launches[n], **entries[n]}
        for n in KERNELS]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
