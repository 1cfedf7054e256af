#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (smoothxg_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one line each or more; any failure exits nonzero and prints no
result:
  1. device: CUDA required; the card's name, power limit, SM clock and
     compute mode (phase 20 puts two processes on it).
  2. build:  csrc/*.cu (poa_win, poa_round, poa_code, poa_stacked,
     poa_batch, probes, sgd, minhash, ident, autocorr) compiled from the checkout, one nvcc process per source
     started together and one link (each kernel's ptxas registers: every
     instantiation of poa_win and poa_round with its stack and spills, the
     stage-0 instantiations of poa_code and poa_stacked, every stage, the
     probe kernels' range by family); the port's
     host C++ libraries (csrc/host/*.cpp) with g++; the JAX package's
     native/ libraries, for the identity phase's reference subprocess only.
  3. kernel: >= 200 seeded blocks at every engine tier shape through the
     whole-block CUDA kernel and its plain PyTorch version (exact equality
     on meta, exp, paths), every block also held against the native C++
     engine; kernel time against the plain version's on a main-path block.
     Each launch prints its geometry (where the graph tables sit, the row
     stride LS, shared bytes, blocks an SM, the instantiation's ptxas
     registers, stack and spills), as do the main paths' launches.
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
     kernel time against the plain version's on a main-path task.  Each
     launch prints its geometry (threads a block, one-tile rows with the
     ring of recent rows in shared memory or tiled rows, where the sequence
     and the row tables sit, shared bytes, blocks an SM, ptxas registers,
     stack and spills); the over-int16 and the long-query tasks take their
     own instantiations on the card.
  7. round main path: the port CLI with --engine pallas and the same flags
     on the same input; >= 90% of the round tasks on the kernel, GFA and
     MAF sha256 equal to phase 5's.
  8. code kernel: >= 200 seeded blocks (local, global, banded, in-degree up
     to 8 and an overflowing 9, a few at the (8704, 4096) tier) through the
     code-chase CUDA kernel poa_code and its plain PyTorch version (exact
     equality), every block also held against the native engine; its time
     on phase 3's block and on a launch of 132 copies, beside poa_win's.
     Each launch prints its geometry: POA blocks per thread block (K),
     where the graph tables sit, the row stride LS, shared bytes and the
     instantiation's ptxas registers (so do phases 9-11 and 13).
  9. code main path: run_smoothing with the same flags and
     TorchPOAEngine(shape=(8704, 4096)); >= 90% of the blocks on poa_code,
     GFA and MAF sha256 equal to phase 5's.
 10. stacked kernel: the same for poa_stacked (one warp per POA block,
     in-degree up to 4 and an overflowing 5, one launch of > 132 blocks).
 11. stacked main path: run_smoothing with TorchPOAEngine(kernel=
     "stacked"); >= 90% of the blocks on poa_stacked, identity as phase 9.
 12. probes: every case and variant of the six probe tools
     (smoothxg_tpu_torch/tools/probe_*.py, kernels csrc/probes.cu) equal to
     its plain version at 5,000 steps, then timed at the TPU tools' N (ns
     per step) or between their N1 and N2 (slope and floor), beside the
     bound; a slope <= 0 fails.
 13. stages: poa_code stages 0-7 and poa_stacked stages 0-2 on phase 3's
     timing block and on a launch of 132 copies; stage 0 equal to phases 8
     / 10's outputs, stages 1 and 2 equal to their plain versions; the
     fill / traceback / threading split (tools/profile_fused.py).
 14. sgd at full size: the seeded 64 x 5 Mb generator graph (6.29M path
     steps) prepped by pipeline/prep.py:prep with the default "auto" SGD
     route, which takes csrc/sgd.cu (100 plan and 100 chain launches); on
     one iteration's draws the plan kernel bit-identical to its plain
     version and the chain kernel's x to the iteration's plain version,
     each timed on its own line; 100 iterations timed by CUDA events (plan
     and chain apart) and run again through the route: the same x bytes;
     rank-jump of the card's order <= 1.2 x the native backend's on the
     16 x 1 Mb graph in a shuffled node order (native takes minutes on the
     64 x 5 Mb graph: tools/time_sgd.py measures it there).
 15. split kernels: csrc/minhash.cu's hash step (minhash_hash, sorted in
     shared memory, and minhash_hash_long, in device memory) and
     intersections (minhash_inter by tiles, and minhash_inter_long, a
     block a pair) on 200 seeded blocks (the
     sentinel 16-mer in every fifth), a block of 512 rows, rows of 1 and
     ~20k hashes and a batch of rows of 20k-50k (past both shared-memory
     routes), equal to their plain versions (sorted_sets of
     minhash_hash_reference, minhash_inter_reference) and the distances to
     the numpy mirror; ident (csrc/ident.cu) on 240 seeded pairs
     (off-band, lb = 0, bailed) equal to its plain version and the numpy
     mirror at band 128, and to the plain version at band 32 (both the
     warp kernel) and 288 (the block kernel), and on two pairs past 46,340
     bp equal to the mirror; each timed on a 512-sequence block (the hash
     step as one function) or 2,048 pairs (bands 128, 32 and 288).
 16. main paths: (a) the CLI's default engine with -U 200 on phase 4's
     input (one POA iteration, -l 700), twice: the same GFA and MAF
     bytes, exactly sgd, sgd_plan and poa_win launched; (b) the CLI with --engine native and both split device
     routes on the divergent fixture (io/synth.make_divergent_gfa over the
     generator's 8 x 20 kb pangenome): blocks split, exactly the split
     kernels launched (the MinHash calls' shapes, launches and walls a
     call printed), and the bytes of run_smoothing(cfg, device="cpu").
 17. batch kernel: 204 seeded round tasks (local and global, the XLA
     engine's slot buckets P = 4, 8 and 16, V and L up to ~2,000, a local
     query of 8,400+ bases, past the XLA function's int16 buckets, and a
     global query against a chain of 33,000 nodes, past int16 rows) through
     csrc/poa_batch.cu and its plain PyTorch version (exact equality on
     out, outpos and bv), every 8th task's score held against the oracle
     poa_host.fill; the set must hold a task whose predecessors lie past
     the ring of recent rows and a launch whose row tables sit in device
     memory.  Kernel time on the round timing task (1, 132 and 264 copies)
     against the plain version's.  Each launch prints its geometry (threads
     a block, ring or tiled rows, where the row tables sit, shared bytes,
     blocks an SM, the instantiation's ptxas registers, stack and spills).
 18. jax main path: the port CLI with --engine jax and phase 4's flags;
     >= 90% of the round tasks on poa_batch, GFA and MAF sha256 equal to
     phase 5's.
 19. sharding: parallel/mesh.sharded_poa_round and sharded_pallas_round
     over [card 0, card 0] (and over every visible card when there are
     more) equal to one launch; TorchPOAEngine(devices=[card 0, card 0])
     on phase 3's blocks (and the code and stacked kernels on its first
     group) equal to one shard.
 20. two ranks: two port CLI processes (--dist-size 2, gloo on a free
     local port, -t 4, phase 4's other flags; rank r on card r mod the
     visible cards, so both share a lone card); both exit 0, rank 0's GFA
     and MAF sha256 equal to phase 5's.
 21. autocorr: csrc/autocorr.cu on 128 seeded rows of 2-40 kb (tandem
     repeats of 1-8 kb periods, random rows, runs of N) at the CLI's lag
     grid (1,000-20,000 every 50) equal to its plain version exactly,
     timed beside it and beside a grouped conv1d over one-hot rows (the
     library column, where its counts are exact), with both bounds, the
     launch geometry, the plan (units, rows a route) and the ptxas
     registers of the pack and count kernels; the same on 32 seeded rows
     heavy in escapes (lower case, all N, random bytes, soft-masked); then
     the repeat_batch path on the card, every row's (length, z) equal to
     the host `repeat`'s.
 22. steal: (a) the fused main path in one rank at -t 1 -T 4 through
     run_smoothing (the host steal on by default, the kernel build and
     warm-up in the background): GFA and MAF sha256 equal to phase 5's,
     stats() with the stolen count and the rate estimates, and what held
     the steal back when nothing was stolen; (b) a forced steal on phase
     3's blocks (max_batch 8, rates set on the instance): blocks stolen,
     every graph equal to the steal-off engine's.
 23. sanitizers (smoothxg_tpu_torch/tools/sanitize.py's card part): the
     harness tools/sanitize_drive.py, which launches every kernel entry of
     the library at a small size (poa_win local, global and banded;
     poa_code and poa_stacked with tables in shared and device memory;
     poa_round and poa_batch ring and tiled, poa_batch's tables in shared
     and device memory; sgd_plan and the sgd chain; minhash_hash,
     minhash_inter and their long routes; ident's warp and block kernels;
     autocorr's four routes, units staged and from device memory; a probe
     of each family; poa_batch over two streams) and holds each to its
     plain version, under compute-sanitizer's memcheck, racecheck,
     synccheck and initcheck at once, each in a process of its own (a
     line a tool: version, seconds, kernels covered, reports; a tool that
     does not run on this card says why), and then under the guard
     allocator (testing/guard_alloc.cu: guard bands around every
     allocation, poisons 0x00 and 0xff in memory and in shared memory);
     the expected reports (tools/sanitize.EXPECTED) are printed, and any
     other report, a guard band written or an entry that disagrees with
     its plain version fails.
 24. deep blocks (pggb passes its haplotype count as -r; HPRC's year-1
     graph has 90): (a) blocks of 64 and 96 sequences of ~100 bases
     (make_block's and make_population_block's, seeded) through poa_win,
     poa_code and poa_stacked at the bulk tier, each equal to its plain
     version (run meanwhile in a pool of worker processes) and every
     unflagged block to the native engine; the flags by kernel, with the
     native graph's V and in-degree, and poa_win's flags at the TPU's 4
     predecessor slots; (b) each kernel's time on one block of 16, 64 and
     96 sequences of ~1 kb (tools/time_chase.deep_block), the three
     kernels' outputs equal; (c) the fused CLI on the seeded 90 x 80 kb
     pangenome with -r 90 -j 5k -e 5k -l 700,900,1100 -t 1: >= 90% of the
     blocks on the kernel, the blocks past 48 sequences counted by where
     they ran, the engine, rehydrate and finalize seconds, and GFA and
     MAF sha256 equal to the JAX package's CLI with --engine native on
     the same input (a subprocess started when the phase starts); (d) the
     same input at -t 4 -l 700 in one rank (the finalize pool): exit 0,
     >= 90% of the blocks on the kernel; the phase's seconds.
Every main path (4, 7, 9, 11, the probes' phase 12, 14's prep, 16, 18, 21,
22 (a) and 24 (c), (d)) runs with all seventeen wrappers' launch counts set
to 0 just before it and read just after: its own kernels must have
launched and no other.  Then the
kernels' JSON line, the nvidia-smi line and the result line.  No module
of jax or of the JAX package may be loaded in this process.
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
    """Least time for `ops` int32 operations on the card: 132 SMs x 128
    lanes per clock (each SM's issue rate, tools/_probe.SM_LANES: its
    integer work is not held to the 64 INT32 units) at the SM clock
    (nvidia-smi clocks.max.sm).  The kernels' inputs and outputs are a few
    MB, far below this in time at 3.35 TB/s, so the bound is by
    operations."""
    from smoothxg_tpu_torch.tools._probe import SM_LANES
    return ops / (132 * SM_LANES * clock_mhz * 1e6) * 1e3


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


PROBES = ("probe_scalar", "probe_row", "probe_tile", "probe_step")
SPLIT = ("minhash_hash", "minhash_inter", "ident")
# the split kernels' routes for rows past shared memory: on no main path
LONG = ("minhash_hash_long", "minhash_inter_long")
KERNELS = (("poa_win", "poa_round", "poa_code", "poa_stacked") + PROBES
           + ("sgd", "sgd_plan") + SPLIT + LONG + ("poa_batch", "autocorr"))


def wrappers() -> dict:
    """Each kernel's wrapper, which counts its launches, by name."""
    from smoothxg_tpu_torch.ops.autocorr import autocorr_counts
    from smoothxg_tpu_torch.ops.ident_cuda import ident_counts
    from smoothxg_tpu_torch.ops.minhash_cuda import (minhash_hash,
                                                     minhash_hash_long,
                                                     minhash_inter,
                                                     minhash_inter_long)
    from smoothxg_tpu_torch.ops.poa_batch import poa_batch
    from smoothxg_tpu_torch.ops.poa_code import poa_code
    from smoothxg_tpu_torch.ops.poa_round import poa_round
    from smoothxg_tpu_torch.ops.poa_stacked import poa_stacked
    from smoothxg_tpu_torch.ops.poa_win import poa_win
    from smoothxg_tpu_torch.ops.sgd import sgd_iter, sgd_plan
    from smoothxg_tpu_torch.tools._probe import WRAPPERS
    return {"poa_win": poa_win, "poa_round": poa_round,
            "poa_code": poa_code, "poa_stacked": poa_stacked, **WRAPPERS,
            "sgd": sgd_iter, "sgd_plan": sgd_plan,
            "minhash_hash": minhash_hash,
            "minhash_inter": minhash_inter, "ident": ident_counts,
            "minhash_hash_long": minhash_hash_long,
            "minhash_inter_long": minhash_inter_long,
            "poa_batch": poa_batch, "autocorr": autocorr_counts}


def drive(run, own):
    """Run a main path with every kernel's launch count set to 0 just
    before and read just after.  `own` is a kernel's name or a tuple of
    them.  Returns (run's result, own's count, or {name: count} for a
    tuple); fails unless each of `own` launched and no other kernel
    did."""
    names = (own,) if isinstance(own, str) else tuple(own)
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    out = run()
    counts = {k: w.launches for k, w in ws.items()}
    for name in names:
        if counts[name] <= 0:
            fail(f"the {'/'.join(names)} path launched no {name} kernel")
    other = {k: v for k, v in counts.items() if k not in names and v}
    if other:
        fail(f"the {'/'.join(names)} path launched other kernels: {other}")
    if isinstance(own, str):
        return out, counts[own]
    return out, {k: counts[k] for k in names}


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
                                                poa_win, poa_win_reference,
                                                row_stride)
    from smoothxg_tpu_torch.testing.synth import make_block
    from smoothxg_tpu_torch.tools.time_chase import (PHASE3_PLAN,
                                                     phase3_blocks)
    rng = np.random.default_rng(SEED)
    native = TorchPOAEngine(device=dev).fallback
    tiers = TorchPOAEngine.TIERS
    n_blocks = n_cmp = 0
    max_err = 0
    for (ti, local, banded, nb, _, _, _), blocks in zip(PHASE3_PLAN,
                                                         phase3_blocks(rng)):
        VW, LW, W = tiers[ti]
        p = POAParams(local=local, wb=311 if banded else -1)
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
            f"memory {per_block / 1e6:.1f} MB per block of the launch; "
            f"geometry " + geometry_line("poa_win", nb, caps,
                                         row_stride(ins[1], LW)))
    if n_blocks < 200:
        fail(f"only {n_blocks} blocks compared")

    # timing on a main-path block shape: 16 sequences of ~1 kb (-l 1100),
    # the draw after phase 3's blocks (tools/time_chase.timing_block)
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
    for B, c in ((1, caps), (132, caps),
                 (FULL_COPIES, WinCaps(*FULL_CAPS, FULL_CAPS[1], True,
                                       False))):
        say("kernel timing geometry: " + geometry_line(
            "poa_win", B, c, row_stride(cpu_ins[1], c.LW)))
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
    from smoothxg_tpu_torch.tools.time_chase import (round_groups,
                                                     round_timing_task)
    # the seeded plan (local and global, V up to ~4,000, L up to ~2,000),
    # in-degrees 2-15, and past the Pallas kernel's 15/16-bit code
    # packing: a local query longer than 2^15 that ends in the graph's
    # sequence (read from device memory, not shared), and a global query
    # against a chain of more than 2^16 nodes (row tables in device memory)
    rng = np.random.default_rng(SEED + 1)
    groups = round_groups(rng)
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
        say(f"round kernel local={local}: {len(tasks)} tasks equal to the "
            f"plain version; geometry " + round_geometry_line(
                ins[3].shape[1], ins[6].shape[1], ins[5].shape[2]))
    if n_tasks < 200:
        fail(f"only {n_tasks} round tasks compared")
    if not set(range(1, 9)) <= degrees or max(degrees) <= 8:
        fail(f"in-degrees covered: {sorted(degrees)}")

    # timing on a main-path task shape: a ~1 kb query against a graph of
    # seven ~1 kb sequences (V ~ 1,200; tools/time_chase.round_timing_task)
    task = round_timing_task(rng)
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
    say(f"round kernel timing geometry (the same for 1 and {nb} tasks): "
        + round_geometry_line(cpu_ins[3].shape[1], cpu_ins[6].shape[1],
                              cpu_ins[5].shape[2]))
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


def geometry_line(name: str, B: int, caps, LS: int) -> str:
    """One whole-block launch's geometry: POA blocks per thread block (K),
    grid, where the graph tables sit, row stride, dynamic shared bytes,
    and the ptxas registers of the (stage-0) instantiation it runs."""
    from smoothxg_tpu_torch.ops import _build
    from smoothxg_tpu_torch.ops.poa_win import geometry
    g = geometry(name, B, caps, LS)
    key = ((g["tables"], "banded" if caps.banded else "full")
           if name == "poa_win" else (0, g["tables"]))
    rep = kernel_registers(_build.build_log["ptxas"]).get((name, key), "")
    per_sm = ""
    if name == "poa_win":
        import torch
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        per_sm = f", {2 if B > sms else 1} blocks an SM of 256 threads"
    return (f"{B} blocks at V{caps.VW}xL{caps.LW}: K {g['per_block']}, grid "
            f"{g['grid']}, tables in {g['tables']} memory, LS {LS}, "
            f"{g['smem']} B shared{per_sm}, {used(rep)} registers, "
            f"{spilled(rep)}")


def round_geometry_line(VW: int, LS: int, P: int) -> str:
    """One poa_round launch's geometry at the batch's largest V, L and
    in-degree: threads a block, one-tile rows with the ring or tiles,
    where the sequence and the row tables sit, dynamic shared bytes,
    blocks an SM, and the ptxas registers of the instantiation it runs."""
    from smoothxg_tpu_torch.ops import _build
    from smoothxg_tpu_torch.ops.poa_round import geometry
    g = geometry(VW, LS, P)
    key = ("ring" if g["ring"] else "tiled", g["tables"])
    rep = kernel_registers(_build.build_log["ptxas"]).get(
        ("poa_round", key), "")
    return (f"VW {VW}, LS {LS}, P {P}: {g['threads']} threads, "
            f"{'one-tile rows, ring in shared memory' if g['ring'] else 'tiled rows'}"
            f", sequence in {g['seq']} memory, tables in {g['tables']} "
            f"memory, {g['smem']} B shared, {g['per_sm']} blocks an SM, "
            f"{used(rep)} registers, {spilled(rep)}")


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
    from smoothxg_tpu_torch.ops.poa_win import pack_blocks, row_stride
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
            f"{len(blocks) - sum(flags)} equal to native; geometry "
            + geometry_line(name, len(blocks), caps, row_stride(ins[1], LW)))
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
    timing[f"{name}_out"] = want             # phase 13 holds stage 0 to it
    batch_ms = time_copies(torch, kern, ins, caps)
    torch.cuda.empty_cache()
    full_ms = time_full_card(torch, dev, kern,
                             lambda VW, LW: mkcaps(VW, LW, True, False),
                             blk, p)
    cells, pcells = win_dp_work(blk, [want[2][0, r, :len(s)].tolist()
                                      for r, s in enumerate(blk)])
    bound_ms = int32_bound_ms(fill_ops(cells, pcells, True), clock_mhz)
    for B, c in ((1, caps), (132, caps),
                 (FULL_COPIES, mkcaps(*FULL_CAPS, True, False))):
        say(f"{name} timing geometry: " + geometry_line(
            name, B, c, row_stride(cpu_ins[1], c.LW)))
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


def block_main_path(tag: str, own: str, run, clock_mhz,
                    depth: int | None = None) -> int:
    """Phases 4, 9, 11 and 24: one run of the block engine's main path
    through `run` (returns (exit code, engine)), counted by `drive`; a spy
    on the engine's iterator keeps each block's sequences and final paths
    for the DP work of the launches (read after the wall is taken) and
    where it ran, and a spy on its launches each launch's geometry and
    each launched block's tier.  With `depth`, the blocks of more
    sequences than that are counted by where they ran (the kernel and its
    tier, the native engine after a launch (redone), the native engine
    otherwise: no tier, or stolen), with their share of the DP cells (L0 x
    L summed over the rounds), beside the pipeline's engine, rehydrate and
    finalize seconds.  Returns the kernel's launches."""
    from smoothxg_tpu_torch.ops.poa_engine import TorchPOAEngine
    from smoothxg_tpu_torch.ops.poa_win import stride_for
    seen = []                 # (sequences, paths, local, kind, tier)
    tiers: dict = {}          # id(sequences) -> the tier it launched on
    it = TorchPOAEngine.poa_block_batch_iter

    def it_spy(self, blocks):
        tiers.clear()         # this call's launches
        for i, kind, payload in it(self, blocks):
            sq = blocks[i][0]
            seen.append((sq, payload[3] if kind == "raw" else
                         payload.seq_paths, blocks[i][2].local, kind,
                         tiers.get(id(sq))))
            yield i, kind, payload

    # each launch's geometry, counted by kind
    geos: dict = {}
    launch = TorchPOAEngine._launch

    def launch_spy(self, blocks, chunk, ti, local, banded):
        out = launch(self, blocks, chunk, ti, local, banded)
        for i in chunk:
            tiers[id(blocks[i][0])] = ti
        VW, LW, W = self.tiers[ti]
        line = geometry_line(own, len(chunk),
                             self._kernel(VW, LW, W, local, banded)[1],
                             stride_for(out[-1], LW))
        geos[line] = geos.get(line, 0) + 1
        return out

    TorchPOAEngine.poa_block_batch_iter = it_spy
    TorchPOAEngine._launch = launch_spy
    log = Tee(sys.stderr)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(log):
            (rc, engine), launches = drive(run, own)
    finally:
        TorchPOAEngine.poa_block_batch_iter = it
        TorchPOAEngine._launch = launch
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"{tag} exited {rc}")
    st = engine.stats()
    total = st["device_blocks"] + st["fallbacks"] + st["redo"] + \
        st["stolen"]
    work = [(*win_dp_work(sq, pth), local) for sq, pth, local, _, _ in seen]
    cells, pcells = (sum(w[i] for w in work) for i in (0, 1))
    bound = int32_bound_ms(sum(fill_ops(*w) for w in work), clock_mhz)
    say(f"{tag}: {wall:.2f} s wall, {total} blocks, "
        f"{total / wall:.2f} blocks/s end to end "
        f"({'; '.join(smoothing_phases(log.getvalue()))}); "
        f"stats {json.dumps(st)}; {own} launches {launches}; DP work of "
        f"its {len(seen)} blocks {cells} cells, {pcells} extra pred cells, "
        f"bound {bound:.3f} ms")
    if depth is not None:
        say(f"{tag} by depth: " + depth_line(seen, depth, engine.tiers)
            + "; " + "; ".join(smooth_times(log.getvalue())))
    if geos:
        say(f"{tag} launch geometry: " + "; ".join(
            f"{n} x [{line}]" for line, n in geos.items()))
    if st["device_blocks"] < 0.9 * total:
        fail(f"{tag}: only {st['device_blocks']}/{total} blocks ran on "
             f"the GPU")
    return launches


def depth_line(seen, depth: int, tiers) -> str:
    """Where the blocks of more than `depth` sequences ran, of the spy's
    (sequences, paths, local, kind, tier) records, and their DP cells."""
    import collections
    import statistics

    def cells(sq):
        return sum(len(sq[0]) * len(s) for s in sq[1:])

    deep = [r for r in seen if len(r[0]) > depth]
    on = collections.Counter(
        "V{}xL{}".format(*tiers[r[4]][:2]) for r in deep if r[3] == "raw")
    redone = sum(r[3] == "graph" and r[4] is not None for r in deep)
    native = sum(r[3] == "graph" and r[4] is None for r in deep)
    all_cells = sum(cells(r[0]) for r in seen) or 1
    dev_cells = sum(cells(r[0]) for r in seen if r[3] == "raw")
    depths = [len(r[0]) for r in deep] or [0]
    deep_cells = sum(cells(r[0]) for r in deep)
    return (f"{len(deep)} of {len(seen)} blocks past {depth} sequences "
            f"(depth {min(depths)}-{max(depths)}, median "
            f"{statistics.median(depths)}, {deep_cells / all_cells:.3f} of "
            f"the DP cells): "
            f"{sum(on.values())} on the kernel {dict(on)}, {redone} on "
            f"the native engine after a launch (redone), {native} on the "
            f"native engine without one (no tier, or stolen); the kernel ran "
            f"{dev_cells / all_cells:.3f} of all blocks' DP cells")


def smooth_times(log: str) -> list:
    """The pipeline's per-iteration engine, rehydrate and finalize
    seconds ('[smoothxg_tpu::smooth] N blocks: ...' lines)."""
    return [ln.split("] ", 1)[1] for ln in log.splitlines()
            if "[smoothxg_tpu::smooth] " in ln and " blocks: " in ln]


def same_bytes(tag: str, out: str, maf: str, ref_out: str,
               ref_maf: str) -> None:
    """GFA and MAF sha256 of a port run against phase 5's native run."""
    same = sha256(out) == sha256(ref_out) and sha256(maf) == sha256(ref_maf)
    say(f"{tag} identity: GFA sha256 {sha256(out)[:16]} vs "
        f"{sha256(ref_out)[:16]}, MAF sha256 {sha256(maf)[:16]} vs "
        f"{sha256(ref_maf)[:16]} (--engine native, phase 5)")
    if not same:
        fail(f"{tag} output differs from the native engine's")


# the probe tools of phase 12 with the TPU tools' step counts
PROBE_TOOLS = (("probe_scalar_latency", {"n": 4096}),
               ("probe_smem", {"n": 65536}),
               ("probe_loop", {"n": 65536}),
               ("probe_loop2", {"n1": 65536, "n2": 524288}),
               ("probe_smem2", {"n1": 65536, "n2": 524288}),
               ("probe_stack", {"n1": 65536, "n2": 524288}))
# each family's headline case for the kernels' JSON line, and the TPU
# kernels it stands for (file:line of the builder; its pallas_call line in
# PERF.md)
PROBE_FAMILIES = {
    "probe_scalar": (("scalar", "chase"), "global",
                     "tools/probe_smem.py:27",
                     ["tools/probe_loop.py:56", "tools/probe_loop.py:70",
                      "tools/probe_loop2.py:45", "tools/probe_loop2.py:54",
                      "tools/probe_loop2.py:69", "tools/probe_smem2.py:48",
                      "tools/probe_smem2.py:76"]),
    "probe_row": (("row", "chase"), ("global", 32),
                  "tools/probe_scalar_latency.py:35",
                  ["tools/probe_loop.py:107", "tools/probe_loop.py:127",
                   "tools/probe_loop2.py:86", "tools/probe_loop2.py:99",
                   "tools/probe_loop2.py:114", "tools/probe_smem2.py:97"]),
    "probe_tile": (("tile", "fillrow"), None, "tools/probe_smem2.py:117",
                   ["tools/probe_loop.py:91", "tools/probe_loop2.py:126",
                    "tools/probe_loop2.py:138"]),
    "probe_step": (("step", 8), "block", "tools/probe_stack.py:27", []),
}


def probe_phase(torch, dev, clock_mhz):
    """Phase 12: every case and variant of the six probe tools, driven
    with all launch counts zeroed; returns the probe families' JSON entry
    fields."""
    import importlib
    from smoothxg_tpu_torch.tools import _probe as P
    reps = 3
    errs = {f: 0 for f in PROBES}

    def run_tools():
        for tool, kw in PROBE_TOOLS:
            mod = importlib.import_module(f"smoothxg_tpu_torch.tools.{tool}")
            cases = mod.CASES if hasattr(mod, "CASES") else mod.cases(4096)
            res = P.run_cases(tool, cases, reps=reps, device=dev,
                              clock_mhz=clock_mhz,
                              echo=lambda ln, t=tool: say(f"{t} {ln}"),
                              **kw)
            if not res["ok"]:
                fail(f"{tool}: a probe failed (lines above)")
            family = {c.name: c.family for c in cases}
            for row in res["cases"]:
                fam = f"probe_{family[row['name']]}"
                errs[fam] = max(errs[fam], row["max_abs_err"])
            cap = [r for r in res["cases"] if r["variant"] ==
                   "cap_224KB[shared]"]
            if tool == "probe_smem2" and not cap:
                fail("cap_224KB did not run in shared memory")

    t0 = time.perf_counter()
    _, launches = drive(run_tools, PROBES)
    say(f"probes: the six tools, every case and variant equal to its plain "
        f"version at {P.CHECK_N} steps (tolerance 0: int32), slopes "
        f"positive; launches {launches}; {time.perf_counter() - t0:.1f} s")
    out = {}
    for fam, ((family, kind), var, rep, _) in PROBE_FAMILIES.items():
        case = P.Case(f"{fam}/{kind}", family, kind)
        var = var if var is not None else case.variants[0]
        inp = case.inputs(dev)
        n = P.CHECK_N
        ms = P.measure(lambda: case.call(var, n, inp, dev), reps)
        t0 = time.perf_counter()
        case.reference(n)
        plain_ms = (time.perf_counter() - t0) * 1e3
        out[fam] = {"max_abs_err": errs[fam], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": case.bound(n, clock_mhz),
                    "bound_by": "operations", "library_ms": None,
                    "launches": launches[fam]}
        say(f"headline {case.label(var)} at {n} steps: kernel "
            f"{ms:.4f} ms, plain version {plain_ms:.1f} ms, bound "
            f"{out[fam]['bound_ms']:.5f} ms")
    return out


STAGE_COPIES = 132             # one POA block per SM


def stage_phase(torch, dev, timing: dict) -> None:
    """Phase 13: the profiling stages of poa_code (0-7) and poa_stacked
    (0-2) on phase 3's timing block and on STAGE_COPIES copies of it."""
    from smoothxg_tpu_torch.ops.poa_code import (STAGES, CodeCaps, poa_code,
                                                 poa_code_reference)
    from smoothxg_tpu_torch.ops.poa_engine import POAParams
    from smoothxg_tpu_torch.ops.poa_stacked import STAGES as STK_STAGES
    from smoothxg_tpu_torch.ops.poa_stacked import (poa_stacked,
                                                    poa_stacked_reference,
                                                    stacked_caps)
    from smoothxg_tpu_torch.ops.poa_win import pack_blocks, row_stride
    from smoothxg_tpu_torch.tools.profile_fused import (format_split,
                                                        time_stages)
    blk = timing["block"]
    cpu_ins = pack_blocks([(blk, POAParams(local=True))], 2048)
    ins = [x.to(dev) for x in cpu_ins]
    insB = [x.repeat((STAGE_COPIES,) + (1,) * (x.dim() - 1)).contiguous()
            for x in ins]

    def run():
        for name, kern, ref, caps, stages in (
                ("poa_code", poa_code, poa_code_reference,
                 CodeCaps(4352, 2048, True, False), STAGES),
                ("poa_stacked", poa_stacked, poa_stacked_reference,
                 stacked_caps(4352, 2048, True, False), STK_STAGES)):
            got = [x.cpu() for x in kern(*ins, caps, stage=0)]
            if not all(torch.equal(g, w) for g, w in
                       zip(got, timing[f"{name}_out"])):
                fail(f"{name} stage 0 != its phase 8 / 10 outputs")
            for st in (1, 2):
                got = [x.cpu() for x in kern(*ins, caps, stage=st)]
                hold_to_plain(got, ref(*cpu_ins, caps, st),
                              f"{name} stage {st}")
                gotB = kern(*insB, caps, stage=st)
                if not all(torch.equal(g.cpu(), w.repeat(
                        (STAGE_COPIES,) + (1,) * (w.dim() - 1)))
                        for g, w in zip(gotB, got)):
                    fail(f"{name} stage {st}: the copies differ")
            say(f"{name} stage 0 == phase {8 if name == 'poa_code' else 10}"
                f"'s outputs; stages 1, 2 == their plain versions (max abs "
                f"err 0) on the timing block and its {STAGE_COPIES} copies; "
                f"geometry " + "; ".join(
                    geometry_line(name, B, caps, row_stride(cpu_ins[1],
                                                            2048))
                    for B in (1, STAGE_COPIES)))
            say(format_split(f"{name} timing block (V "
                             f"{int(timing[name + '_out'][0][0, 0])})",
                             time_stages(kern, ins, caps, stages, reps=3)))
            say(format_split(f"{name} {STAGE_COPIES} copies",
                             time_stages(kern, insB, caps, stages, reps=1)))
            torch.cuda.empty_cache()

    t0 = time.perf_counter()
    _, launches = drive(run, ("poa_code", "poa_stacked"))
    say(f"stages: launches {launches}, {time.perf_counter() - t0:.1f} s")


def ptxas_registers(log: str) -> dict:
    """{kernel entry (mangled): 'Used N registers, ...; N bytes stack
    frame, N bytes spill stores, N bytes spill loads'} from ptxas -v."""
    regs, entry, stack = {}, None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
            stack = ""
        elif entry and "stack frame" in ln:
            stack = ln.strip()
        elif entry and "registers" in ln:
            regs[entry] = ln.split(":", 1)[-1].strip() + (
                f"; {stack}" if stack else "")
            entry = None
    return regs


def used(report: str) -> int:
    """The register count of a ptxas report line, -1 without one."""
    return int(report.split("Used ")[1].split()[0]) if "Used " in report \
        else -1


def spilled(report: str) -> str:
    """'stack S B, spills T/L B' of a ptxas report line."""
    import re
    m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                  r"(\d+) bytes spill loads", report)
    return (f"stack {m[1]} B, spills {m[2]}/{m[3]} B" if m
            else "stack ? B, spills ?")


def kernel_registers(log: str) -> dict:
    """{(kernel, template arguments): ptxas report} of the POA kernels'
    instantiations: poa_code_kernel / poa_stacked_kernel<STAGE,
    SMEM_TABLES> as (stage, 'shared' / 'device'), poa_win_kernel<
    SMEM_TABLES, BANDED> as ('shared' / 'device', 'full' / 'banded'),
    poa_round_kernel<RING, TSMEM> and poa_batch_kernel<RING, TSMEM> as
    ('ring' / 'tiled', 'shared' / 'device')."""
    import re
    out = {}
    for e, r in ptxas_registers(log).items():
        m = re.search(r"(poa_(?:win|round|code|stacked|batch))_kernelI"
                      r"((?:L[bi]\d+E)+)E", e)
        if not m:
            continue
        name = m[1]
        args = [int(v) for _, v in re.findall(r"L([bi])(\d+)E", m[2])]
        where = ("device", "shared")
        if name in ("poa_code", "poa_stacked"):
            key = (args[0], where[args[1]])
        elif name == "poa_win":         # <SMEM_TABLES, BANDED>
            key = (where[args[0]], ("full", "banded")[args[1]])
        else:
            key = (("tiled", "ring")[args[0]], where[args[1]])
        out[(name, key)] = r
    return out


def build_summary(log: str) -> str:
    """Each POA kernel's registers, stack and spills (the code-chase
    kernels' stage-0 instantiations with the graph tables in device and in
    shared memory first, then every stage's count; every instantiation of
    poa_win and poa_round), each probe family's register range, and the
    SGD and split-stage kernels' registers, stack and spills (each column
    count of ident's warp kernel)."""
    import re
    regs = ptxas_registers(log)
    inst = kernel_registers(log)
    parts = []
    for name in (*KERNELS[:4], "poa_batch"):
        mine = {k: r for (n, k), r in inst.items() if n == name}
        if name in ("poa_code", "poa_stacked"):
            parts.append(
                f"{name}_kernel stage 0: device tables "
                f"{mine.get((0, 'device'), '?')}; shared tables "
                f"{mine.get((0, 'shared'), '?')} (stages "
                + ", ".join(f"{st}/{t[0]}: {used(r)}"
                            for (st, t), r in sorted(mine.items())) + ")")
        else:
            parts.append(f"{name}_kernel " + ("; ".join(
                f"<{', '.join(k)}>: {used(r)} registers, {spilled(r)}"
                for k, r in sorted(mine.items())) or "ptxas: no report"))
    for fam in PROBES:
        own = [used(r) for e, r in regs.items() if f"{fam}_" in e]
        parts.append(f"{fam} kernels: {len(own)} instantiations, "
                     f"{min(own, default=-1)}-{max(own, default=-1)} "
                     f"registers")
    for name, tag in (("sgd_plan", "sgd_plan_kernel"),
                      ("sgd_chain", "sgd_chain_kernel"),
                      ("minhash_hash (shared)", "minhash_hash_kernelILb0"),
                      ("minhash_hash (device)", "minhash_hash_kernelILb1"),
                      ("minhash_inter", "minhash_inter_kernel"),
                      ("minhash_inter_long", "minhash_inter_long_kernel"),
                      ("ident_block", "ident_block_kernel"),
                      ("autocorr_pack", "autocorr_pack_kernel"),
                      ("autocorr_count", "autocorr_count_kernel")):
        mine = [r for e, r in regs.items() if tag in e]
        parts.append(f"{name} " + (
            f"{used(mine[0])} registers, {spilled(mine[0])}" if mine
            else "ptxas: no report"))
    warp = sorted((int(m[1]), r) for e, r in regs.items()
                  for m in [re.search(r"ident_warp_kernelILi(\d+)E", e)] if m)
    parts.append("ident_warp_kernel " + ("; ".join(
        f"<{c}>: {used(r)} registers, {spilled(r)}" for c, r in warp)
        or "ptxas: no report"))
    return "; ".join(parts)


# phase 14: the SGD layout at full size; phase 16 (b): the divergent fixture
SGD_GRAPH = {"haplotypes": 64, "length": 5_000_000, "seed": 1}
SGD_QUALITY = {"haplotypes": 16, "length": 1_000_000, "seed": 1}
DIVERGENT = {"haplotypes": 8, "length": 20_000, "seed": SEED}
# phase 4's flags at one POA iteration (each iteration preps its input
# again, so three would run the 100-iteration SGD three times), -U 200
SGD_MAIN_FLAGS = [*MAIN_FLAGS[:MAIN_FLAGS.index("-l") + 1], "700",
                  *MAIN_FLAGS[MAIN_FLAGS.index("-l") + 2:], "-U", "200"]
SPLIT_FLAGS = ["-r", "16", "-j", "5k", "-e", "5k", "-l", "700", "-t", "1",
               "--engine", "native", "-I", "0.95", "-E", "0.9", "-d", "2",
               "-D", "2", "-L", "500", "--device-split-minhash",
               "--device-split-wfa"]
# The bounds count the work the function needs, not the kernels' own
# choices.  int32 operations a DP cell of the banded identity's recurrence
# as one sequential row needs them (smoothxg_tpu/ops/ident_jax.py:119-178):
# the cross-row gap I (two adds, a compare, the value's and three counts'
# selects, the opening's add: 8), the diagonal M (the match test with both
# codes' validity, the substitution's select, the add and its INF guard,
# the match and mismatch counts: 9), Hq = min(M, I) (a compare, four
# selects: 5), the in-row gap D(j) = min(D(j-1) + e, Hq(j-1) + o + e) (8,
# as I), H = min(Hq, D) (5) and the band's mask (a compare, two selects: 3)
OPS_IDENT_CELL = 38
# (the MinHash bounds: tools/time_minhash.py:bounds)


def cuda_ms(torch, fn, reps: int = 3) -> float:
    """Mean ms of fn() over `reps` calls after a warm one, by CUDA
    events."""
    fn()
    torch.cuda.synchronize()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    for _ in range(reps):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps


def sgd_phase(torch, dev, graph=SGD_GRAPH, quality=SGD_QUALITY):
    """Phase 14: the 64 x 5 Mb generator graph prepped with the default
    "auto" SGD route (both kernels, counted); on one iteration's draws the
    plan kernel against its plain version and the chain kernel's x against
    the iteration's plain version, each timed; 100 iterations timed and
    then run again through the route (the same bytes); rank-jump of the
    card's order against the native backend's on 16 x 1 Mb in a shuffled
    node order.  Returns sgd's (the chain kernel's) and sgd_plan's JSON
    entry fields."""
    import numpy as np
    from smoothxg_tpu_torch.io.gfa import read_gfa
    from smoothxg_tpu_torch.ops import sgd
    from smoothxg_tpu_torch.pipeline.prep import prep
    from smoothxg_tpu_torch.testing.synth import write_pangenome
    from smoothxg_tpu_torch.tools.time_sgd import (chain_bound,
                                                   chain_floor_ms,
                                                   plan_bound, rank_jump,
                                                   sgd_bound, shuffled,
                                                   time_kernel)
    t0 = time.perf_counter()
    gfa = write_pangenome(os.path.join(SMOKE_DIR, "sgd.gfa"), **graph)
    g = read_gfa(gfa)
    os.remove(gfa)
    prob = sgd.sgd_problem(g)
    n = len(prob.x0)
    say(f"sgd graph {graph}: {prob.T} path steps, {n} nodes, {prob.B} term "
        f"updates an iteration ({prob.B_pad} in {prob.B_pad // 1024} "
        f"minibatches on the card), {time.perf_counter() - t0:.1f} s to "
        f"make and read")
    if prob.B < sgd.SGD_DEVICE_MIN_TERMS:
        fail(f"the sgd graph has {prob.B} term updates, below "
             f"{sgd.SGD_DEVICE_MIN_TERMS}")
    arr = prob.tensors(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    draws = sgd.sgd_draws(gen, prob.T, prob.B_pad, arr["cdf"],
                          prob.zipf_space)
    ins = (*draws, arr["node"], arr["pos"], arr["start"], arr["count"],
           float(prob.etas(100)[0]))
    x0 = torch.from_numpy(prob.x0.astype(np.float32)).to(dev)
    plan = sgd.sgd_plan(*ins)
    plan_p = sgd.sgd_plan_reference(*ins)
    plan_err = int((plan.long() - plan_p.long()).abs().max())
    if not torch.equal(plan, plan_p):
        fail(f"sgd plan kernel != plain version (max abs err {plan_err})")
    runs = plan[4 * prob.B_pad:6 * prob.B_pad]
    runs = runs[runs < 0] >> 11 & 0xfff       # the heads' run lengths
    xk = sgd.sgd_iter(x0.clone(), *ins, plan=plan)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xp = sgd.sgd_reference(x0.clone(), *ins)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = float((xk - xp).abs().max())
    if not torch.equal(xk, xp):
        fail(f"sgd kernel != plain version on one iteration (max abs err "
             f"{err})")
    plan_ms = cuda_ms(torch, lambda: sgd.sgd_plan(*ins))
    plan_plain = cuda_ms(torch, lambda: sgd.sgd_plan_reference(*ins), reps=1)
    xt = x0.clone()
    chain_ms = cuda_ms(torch, lambda: sgd.sgd_iter(xt, *ins, plan=plan))
    say(f"sgd plan kernel: == plain version bit for bit on {prob.B_pad} "
        f"draws ({plan.numel()} words, max abs err {plan_err}, tolerance 0;"
        f" runs of 1 / 2 / 3+ pairs: {int((runs == 1).sum())} / "
        f"{int((runs == 2).sum())} / {int((runs > 2).sum())}, longest "
        f"{int(runs.max())}); {plan_ms:.3f} ms, plain version on the card "
        f"{plan_plain:.1f} ms, bound {plan_bound(prob)[0]:.4f} ms by "
        f"{plan_bound(prob)[1]}")
    say(f"sgd chain kernel: x == the iteration's plain version bit for bit "
        f"(max abs err {err}, tolerance 0); {chain_ms:.3f} ms on that plan, "
        f"plain version of the iteration on the card {plain_ms:.1f} ms, "
        f"bound {chain_bound(prob)[0]:.4f} ms by {chain_bound(prob)[1]}, "
        f"chain floor {chain_floor_ms(prob, 1):.3f} ms")
    del xk, xp, xt, plan, plan_p, runs
    t0 = time.perf_counter()
    g2, launches = drive(lambda: prep(g, 100, device=dev), ("sgd", "sgd_plan"))
    prep_s = time.perf_counter() - t0
    if launches != {"sgd": 100, "sgd_plan": 100}:
        fail(f"prep launched the sgd kernels {launches} times, not 100 each")
    say(f"sgd main path: prep (default auto route) {prep_s:.2f} s wall, "
        f"{g2.node_count()} nodes after chop, launches {launches}")
    del g2
    t0 = time.perf_counter()
    x1, plans, chains = time_kernel(torch, prob, dev)
    card_s = time.perf_counter() - t0
    x2 = sgd.sgd_solve(prob, device=dev)
    digest = [hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]
              for x in (x1, x2)]
    if digest[0] != digest[1]:
        fail(f"sgd: two full runs differ: {digest}")
    bound, by = sgd_bound(prob)
    ms = sum(chains) / len(chains)
    say(f"sgd 100 iterations: {card_s:.3f} s wall (draws + kernels), "
        f"kernels {sum(plans) + sum(chains):.1f} ms: plan {sum(plans):.1f} "
        f"ms ({sum(plans) / len(plans):.3f} an iteration, "
        f"{min(plans):.3f}-{max(plans):.3f}), chain {sum(chains):.1f} ms "
        f"({ms:.3f} an iteration, {min(chains):.3f}-{max(chains):.3f}); the "
        f"iteration's bound {bound:.4f} ms by {by} (inputs once), chain "
        f"floor {chain_floor_ms(prob):.1f} ms for 100 (one 0.5 us L2 round "
        f"trip a minibatch); two full runs give the same x bytes "
        f"({digest[0]})")
    del x1, x2, arr, draws, ins, x0
    torch.cuda.empty_cache()
    gq = write_pangenome(os.path.join(SMOKE_DIR, "sgd_quality.gfa"),
                         **quality)
    gq = shuffled(read_gfa(gq).compact())
    t0 = time.perf_counter()
    rn = rank_jump(gq, sgd.path_sgd_order(gq, device="native"))
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc = rank_jump(gq, sgd.path_sgd_order(gq, device="cuda"))
    card_q = time.perf_counter() - t0
    say(f"sgd quality on {quality} in a shuffled order (input rank-jump "
        f"{rank_jump(gq, list(gq.node_ids())):.1f}): card {rc:.3f} in "
        f"{card_q:.2f} s, native {rn:.3f} in {native_s:.2f} s "
        f"(bound: card <= 1.2 x native)")
    if rc > 1.2 * rn:
        fail(f"sgd: the card's rank-jump {rc:.3f} > 1.2 x native's {rn:.3f}")
    pb, cb = plan_bound(prob), chain_bound(prob)
    return {"sgd": {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": cb[0], "bound_by": cb[1], "library_ms": None,
                    "launches": launches["sgd"]},
            "sgd_plan": {"max_abs_err": plan_err,
                         "ms": sum(plans) / len(plans),
                         "plain_ms": plan_plain, "bound_ms": pb[0],
                         "bound_by": pb[1], "library_ms": None,
                         "launches": launches["sgd_plan"]}}


def _seq(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _mutate(rng, s: str, p: float) -> str:
    """Substitutions, 1-3 bp insertions and deletions, each at rate p/3."""
    out = []
    for ch in s:
        r = rng.random()
        if r < p / 3:
            continue
        if r < 2 * p / 3:
            out.append(_seq(rng, int(rng.integers(1, 4))))
        elif r < p:
            ch = "ACGT"[("ACGT".index(ch) + 1) % 4]
        out.append(ch)
    return "".join(out)


def minhash_blocks(rng, n_blocks: int):
    """Seeded MinHash blocks: mutated copies of a base sequence (0-20%),
    unrelated and short sequences, non-ACGT bases, and in every fifth
    block the 16-mer whose hash is the sentinel."""
    from smoothxg_tpu_torch.ops.minhash_cuda import SENTINEL_KMER
    for b in range(n_blocks):
        base = _seq(rng, int(rng.integers(100, 2000)))
        n = int(rng.integers(2, 24))
        seqs = [_mutate(rng, base, float(rng.choice([0, 0.01, 0.05, 0.2])))
                for _ in range(n)]
        seqs += [_seq(rng, int(rng.integers(0, 600))), "ACG",
                 base[:50] + "N" * 5 + base[50:]]
        if b % 5 == 0:
            seqs.append(base[:30] + SENTINEL_KMER + base[30:])
        yield seqs


def ident_pairs(rng, n: int):
    """Seeded pairs for the banded identity: related at 0-30% divergence
    with indels, off-band (a 300 bp insertion), unrelated, lb = 0, and a
    per-pair max_score (len(a) as the pipeline passes, a tenth of it for
    bailed pairs)."""
    pairs, ms = [], []
    for t in range(n):
        a = _seq(rng, int(rng.integers(1, 1000)))
        if t % 10 == 7:
            cut = int(rng.integers(0, len(a)))
            b = a[:cut] + _seq(rng, 300) + a[cut:]
        elif t % 10 == 8:
            b = _seq(rng, int(rng.integers(0, 1000)))
        elif t % 10 == 9:
            b = ""
        else:
            b = _mutate(rng, a, float(rng.choice([0, 0.02, 0.1, 0.3])))
        pairs.append((a, b) if t % 2 else (b, a))
        ms.append(max(len(a), len(b)) // (10 if t % 10 == 6 else 1))
    return pairs, ms


def hold_minhash(torch, mc, codes, lens, k: int, label: str):
    """Both routes of the hash step and of the intersections on one batch
    against their plain versions, exact (the shared-memory hash route and
    the tile route where the batch fits them).  Returns the plain (hs,
    counts, inter)."""
    hs, counts = mc.sorted_sets(mc.minhash_hash_reference(codes, lens, k))
    B, L = codes.shape
    routes = [mc.minhash_hash_long]
    if mc.hash_smem(L, k) <= mc.SMEM_MAX:
        routes.append(mc.minhash_hash)
    for route in routes:
        got = route(codes, lens, k)
        if not (torch.equal(got[0], hs) and torch.equal(got[1], counts)):
            fail(f"{route.__name__} != plain version on {label}")
    ref = mc.minhash_inter_reference(hs, counts,
                                     *mc.triu_pairs(B, codes.device))
    got = {"minhash_inter_long": mc.minhash_inter_long(hs, counts)}
    if mc.tile_rows(B, L):
        got["minhash_inter"] = mc.minhash_inter(hs, counts)
    for name, g in got.items():
        if not torch.equal(g, ref):
            fail(f"{name} != plain version on {label}")
    return hs, counts, ref


def split_phase(torch, dev, clock_mhz, n_blocks=200, n_pairs=240,
                long_pairs=(46_400, 47_000), deep=512):
    """Phase 15: the hash step and the intersections of csrc/minhash.cu
    (each in both routes) and ident (csrc/ident.cu) against their plain
    versions on the card and the numpy mirrors on seeded blocks and pairs,
    exact; then timed on a deep block.  Returns the kernels' JSON entry
    fields."""
    import numpy as np
    from smoothxg_tpu_torch.ops import ident_cuda as ic
    from smoothxg_tpu_torch.ops import minhash_cuda as mc
    from smoothxg_tpu_torch.tools.time_minhash import bounds, long_block
    rng = np.random.default_rng(SEED + 15)
    t0 = time.perf_counter()
    n_hash = n_pairs_mh = 0
    for b, seqs in enumerate(minhash_blocks(rng, n_blocks)):
        k = 16 if b % 4 else 11
        codes, lens = (torch.from_numpy(a).to(dev)
                       for a in mc.encode_batch(seqs))
        hold_minhash(torch, mc, codes, lens, k, f"block {b}")
        d = mc.DeviceMinHash(k, device=dev).distance_matrix(seqs)
        if not np.array_equal(d, mc.host_distance_matrix(seqs, k)):
            fail(f"minhash distances != the numpy mirror on block {b}")
        n_hash += int(codes.numel())
        n_pairs_mh += len(seqs) * (len(seqs) - 1) // 2
    say(f"minhash: {n_blocks} blocks ({n_hash} positions, {n_pairs_mh} "
        f"pairs, k 16 and 11, the sentinel 16-mer in every fifth): "
        f"minhash_hash and minhash_hash_long equal to sorted_sets("
        f"minhash_hash_reference), minhash_inter (one tile) and "
        f"minhash_inter_long equal to minhash_inter_reference, "
        f"distances equal to the numpy mirror (tolerance 0), "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # the long-row cases draw from their own generator, so the ident pairs
    # and the timing blocks below are those of earlier smokes
    lrng = np.random.default_rng(SEED + 151)
    big = _seq(lrng, 20_000)
    cases = {"rows of 1 and ~20k hashes": ["A" * 16, big, _mutate(lrng, big,
                                                                  0.01)],
             "rows of 20k-50k (past both shared-memory routes)":
                 long_block(lrng)}
    for label, seqs in cases.items():
        codes, lens = (torch.from_numpy(a).to(dev)
                       for a in mc.encode_batch(seqs))
        _, counts, _ = hold_minhash(torch, mc, codes, lens, 16, label)
        d = mc.DeviceMinHash(16, device=dev).distance_matrix(seqs)
        if not np.array_equal(d, mc.host_distance_matrix(seqs, 16)):
            fail(f"minhash distances != the numpy mirror on {label}")
        B, L = codes.shape
        R = mc.tile_rows(B, L)
        say(f"minhash {label}: counts {counts.tolist()}, routes: hash "
            f"{'shared' if mc.hash_smem(L, 16) <= mc.SMEM_MAX else 'device'}"
            f" memory, intersections "
            f"{f'tiles of {R} rows' if R else 'a block a pair'}; both "
            f"routes of each equal to the plain versions, distances to the "
            f"numpy mirror")
    say(f"minhash long-row cases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pairs, ms = ident_pairs(rng, n_pairs)
    packed = ic.pack_pairs([ic._prep_pair(a, b) for a, b in pairs])
    ins = [packed[n].to(dev) for n in ("a", "aoff", "la", "b", "boff", "lb")]
    got = ic.ident_counts(*ins)
    if not torch.equal(got, ic.ident_counts_reference(*ins)):
        fail("ident != plain version")
    mirror = np.array([ic.host_banded_identity(a, b, return_counts=True)
                       for a, b in pairs])
    if not np.array_equal(got.cpu().numpy(), mirror):
        fail("ident != the numpy mirror")
    idents = ic.DeviceBandedIdentity(device=dev).identities(pairs, ms)
    # the mirror's bail and identity (host_banded_identity's last lines)
    want = [0.0 if sc >= ic.INF or sc >= m else
            ic.identity_from_counts(mm, xx, gg)
            for (sc, mm, xx, gg), m in zip(mirror.tolist(), ms)]
    if idents != want:
        fail("ident identities != the numpy mirror's")
    bailed = sum(1 for (sc, *_), m in zip(mirror, ms) if sc >= m)
    for band in (32, 288):              # the warp kernel, the block kernel
        if not torch.equal(ic.ident_counts(*ins, band),
                           ic.ident_counts_reference(*ins, band)):
            fail(f"ident != plain version at band {band}")
    say(f"ident: {n_pairs} pairs (off-band, unrelated, lb = 0, {bailed} "
        f"bailed by max_score) equal to the plain version and the numpy "
        f"mirror, counts and identities (tolerance 0), at band 128 and "
        f"equal to the plain version at 32 (warp kernel) and 288 (block "
        f"kernel), {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    longs = []
    for L in long_pairs:
        a = _seq(rng, L)
        longs.append((a, _mutate(rng, a, 0.01)))
    packed = ic.pack_pairs([ic._prep_pair(a, b) for a, b in longs])
    got = ic.ident_counts(*(packed[n].to(dev) for n in
                            ("a", "aoff", "la", "b", "boff", "lb")))
    mirror = np.array([ic.host_banded_identity(a, b, return_counts=True)
                       for a, b in longs])
    if not np.array_equal(got.cpu().numpy(), mirror):
        fail("ident != the numpy mirror on the pairs past 46,340 bp")
    say(f"ident: pairs of {[max(len(a), len(b)) for a, b in longs]} bp "
        f"(past the int32 center bound) equal to the numpy mirror, "
        f"identities {[round(ic.identity_from_counts(*c[1:]), 6) for c in mirror.tolist()]}, "
        f"{time.perf_counter() - t0:.1f} s")

    # timing: a deep block of 512 sequences of ~1.4 kb, held to the plain
    # versions first
    base = _seq(rng, 1400)
    seqs = [_mutate(rng, base, 0.05) for _ in range(deep)]
    codes, lens = (torch.from_numpy(a).to(dev)
                   for a in mc.encode_batch(seqs))
    B, L = codes.shape
    k = 16
    hs, counts, _ = hold_minhash(torch, mc, codes, lens, k,
                                 f"the {B}-row block")
    hash_ms = cuda_ms(torch, lambda: mc.minhash_hash(codes, lens, k))
    hash_long_ms = cuda_ms(torch, lambda: mc.minhash_hash_long(codes, lens,
                                                               k))
    hash_plain = cuda_ms(torch, lambda: mc.sorted_sets(
        mc.minhash_hash_reference(codes, lens, k)))
    h = mc.minhash_hash_reference(codes, lens, k)
    hash_lib = cuda_ms(torch, lambda: torch.sort(h, dim=1))
    pa, pb = mc.triu_pairs(B, dev)
    inter_ms = cuda_ms(torch, lambda: mc.minhash_inter(hs, counts))
    inter_long_ms = cuda_ms(torch, lambda: mc.minhash_inter_long(hs, counts),
                            reps=1)
    inter_plain = cuda_ms(torch, lambda: mc.minhash_inter_reference(
        hs, counts, pa, pb), reps=1)
    half = len(pa) // 2
    inter_lib = cuda_ms(torch, lambda: torch.sort(torch.cat(
        [hs[pa[:half].long()], hs[pb[:half].long()]], dim=1), dim=1),
        reps=1) * len(pa) / half
    del h, pa, pb
    torch.cuda.empty_cache()
    (hash_bound, hash_by), (inter_bound, inter_by) = bounds(
        B, L, counts.cpu().numpy(), clock_mhz)
    say(f"minhash timing, {B} x ~1.4 kb block (k {k}, {B * (B - 1) // 2} "
        f"pairs): hash step (hash, sort, dedup) minhash_hash "
        f"{hash_ms:.4f} ms, minhash_hash_long {hash_long_ms:.4f} ms, plain "
        f"{hash_plain:.3f} ms, torch.sort of the rows {hash_lib:.4f} ms, "
        f"bound {hash_bound:.4f} ms by {hash_by}; minhash_inter (tiles of "
        f"{mc.tile_rows(B, L)} rows) {inter_ms:.4f} ms, minhash_inter_long "
        f"{inter_long_ms:.3f} ms, plain {inter_plain:.1f} ms, torch.sort of "
        f"the concatenated pairs {inter_lib:.1f} ms, bound "
        f"{inter_bound:.4f} ms by {inter_by}")
    longs = cases["rows of 20k-50k (past both shared-memory routes)"]
    lcodes, llens = (torch.from_numpy(a).to(dev)
                     for a in mc.encode_batch(longs))
    lhash = cuda_ms(torch, lambda: mc.minhash_hash_long(lcodes, llens, k))
    lhs, lcounts = mc.minhash_hash_long(lcodes, llens, k)
    linter = cuda_ms(torch, lambda: mc.minhash_inter_long(lhs, lcounts))
    say(f"minhash timing, rows of {[len(q) for q in longs]} bp: "
        f"minhash_hash_long {lhash:.3f} ms, minhash_inter_long "
        f"{linter:.3f} ms")
    del lhs, lcounts, lcodes, llens
    pairs = [(s, _mutate(rng, s, 0.05)) for s in seqs[:64]] * (deep // 16)
    packed = ic.pack_pairs([ic._prep_pair(a, b) for a, b in pairs])
    ins = [packed[n].to(dev) for n in ("a", "aoff", "la", "b", "boff", "lb")]
    ident_ms = cuda_ms(torch, lambda: ic.ident_counts(*ins))
    ident_plain = cuda_ms(torch, lambda: ic.ident_counts_reference(*ins),
                          reps=1)
    other = {band: cuda_ms(torch, lambda: ic.ident_counts(*ins, band))
             for band in (32, 288)}
    cells = int(ins[2].long().sum()) * 128
    ident_bound = int32_bound_ms(cells * OPS_IDENT_CELL, clock_mhz)
    say(f"ident timing, {len(pairs)} pairs of ~1.4 kb (band 128): kernel "
        f"{ident_ms:.3f} ms, plain {ident_plain:.1f} ms, bound "
        f"{ident_bound:.4f} ms by operations ({cells} cells x "
        f"{OPS_IDENT_CELL} int32 ops); band 32 (warp kernel) "
        f"{other[32]:.3f} ms, band 288 (block kernel) {other[288]:.3f} ms")
    hash_fields = {"max_abs_err": 0, "plain_ms": hash_plain,
                   "bound_ms": hash_bound, "bound_by": hash_by,
                   "library_ms": hash_lib}
    inter_fields = {"max_abs_err": 0, "plain_ms": inter_plain,
                    "bound_ms": inter_bound, "bound_by": inter_by,
                    "library_ms": inter_lib}
    return {
        "minhash_hash": {"ms": hash_ms, **hash_fields},
        "minhash_hash_long": {"ms": hash_long_ms, **hash_fields},
        "minhash_inter": {"ms": inter_ms, **inter_fields},
        "minhash_inter_long": {"ms": inter_long_ms, **inter_fields},
        "ident": {"max_abs_err": 0, "ms": ident_ms, "plain_ms": ident_plain,
                  "bound_ms": ident_bound, "bound_by": "operations",
                  "library_ms": None}}


def sgd_main_path(gfa: str) -> int:
    """Phase 16 (a): the CLI's default engine with -U 200 (B = steps x 200
    >= 5M: the SGD kernels in prep) and one POA iteration, twice: exit 0
    (lace validation), the same GFA and MAF bytes, exactly sgd, sgd_plan
    and poa_win launched.  Returns sgd's launches of the first run."""
    from smoothxg_tpu_torch import cli
    from smoothxg_tpu_torch.io.gfa import read_gfa
    from smoothxg_tpu_torch.ops.sgd import SGD_DEVICE_MIN_TERMS, sgd_problem
    B = sgd_problem(read_gfa(gfa), min_term_updates_factor=200).B
    if B < SGD_DEVICE_MIN_TERMS:
        fail(f"-U 200 gives {B} term updates, below {SGD_DEVICE_MIN_TERMS}")
    digests, first = [], None
    for r in range(2):
        out = os.path.join(SMOKE_DIR, f"sgd_main_{r}.gfa")
        maf = os.path.join(SMOKE_DIR, f"sgd_main_{r}.maf")
        log = Tee(sys.stderr)
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(log):
            (rc, _), launches = drive(
                lambda: cli.run(["-g", gfa, "-o", out, "-m", maf,
                                 *SGD_MAIN_FLAGS]),
                ("sgd", "sgd_plan", "poa_win"))
        wall = time.perf_counter() - t0
        if rc != 0:
            fail(f"the -U 200 main path exited {rc}")
        digests.append((sha256(out), sha256(maf)))
        first = first or launches
        say(f"sgd main path run {r + 1} (CLI default engine, "
            f"{' '.join(SGD_MAIN_FLAGS)}, B = {B}): {wall:.2f} s wall, launches {launches}, GFA sha256 "
            f"{digests[-1][0][:16]}, MAF sha256 {digests[-1][1][:16]} "
            f"({'; '.join(smoothing_phases(log.getvalue()))})")
    if digests[0] != digests[1]:
        fail("the -U 200 main path gave other bytes on its second run")
    return first["sgd"]


def split_main_path() -> dict:
    """Phase 16 (b): the CLI with --engine native and both split device
    routes on the divergent fixture (make_divergent_gfa over the
    generator's 8 x 20 kb pangenome): exactly the split kernels launched,
    splits in break_stats, and the GFA and MAF bytes of the same run
    through run_smoothing(cfg, device="cpu") (the plain versions).  Each
    DeviceMinHash.distance_matrix call of the kernels' run is recorded:
    its rows, longest row, pairs, the launches it made and its host-to-host
    wall.  Returns the split kernels' launches."""
    import re
    import statistics
    from smoothxg_tpu_torch import cli
    from smoothxg_tpu_torch.io.synth import make_divergent_gfa
    from smoothxg_tpu_torch.ops import minhash_cuda as mc
    from smoothxg_tpu_torch.pipeline.run import run_smoothing
    from smoothxg_tpu_torch.testing.synth import write_pangenome
    src = write_pangenome(os.path.join(SMOKE_DIR, "divergent_src.gfa"),
                          **DIVERGENT)
    div = os.path.join(SMOKE_DIR, "divergent.gfa")
    make_divergent_gfa(src, div, tiles=2, seed=7)
    calls = []                  # (rows, longest, pairs, launches, ms)
    dmat = mc.DeviceMinHash.distance_matrix

    def dmat_spy(self, seqs, mask=None):
        el = [len(q) for q, m in zip(seqs, [True] * len(seqs) if mask is None
                                     else mask) if m]
        before = (mc.minhash_hash.launches, mc.minhash_inter.launches)
        t0 = time.perf_counter()
        out = dmat(self, seqs, mask)
        ms = (time.perf_counter() - t0) * 1e3
        calls.append((len(el), max(el, default=0),
                      len(el) * (len(el) - 1) // 2,
                      (mc.minhash_hash.launches - before[0],
                       mc.minhash_inter.launches - before[1]), ms))
        return out

    outs = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(SMOKE_DIR, f"split_{dev}.gfa")
        maf = os.path.join(SMOKE_DIR, f"split_{dev}.maf")
        argv = ["-g", div, "-o", out, "-m", maf, *SPLIT_FLAGS]
        log = Tee(sys.stderr)
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(log):
            if dev == "cuda":
                mc.DeviceMinHash.distance_matrix = dmat_spy
                try:
                    (rc, _), launches = drive(lambda: cli.run(argv), SPLIT)
                finally:
                    mc.DeviceMinHash.distance_matrix = dmat
            else:
                args = cli.build_parser().parse_args(argv)
                run_smoothing(cli.config_from_args(
                    args, add_consensus=not args.vanish_consensus),
                    device="cpu")
                rc = 0
        wall = time.perf_counter() - t0
        if rc != 0:
            fail(f"the split main path exited {rc}")
        split = [int(n) for n in re.findall(r"split (\d+) blocks",
                                            log.getvalue())]
        outs[dev] = (sha256(out), sha256(maf))
        say(f"split main path ({'CLI, the kernels' if dev == 'cuda' else 'run_smoothing(device=cpu), the plain versions'}"
            f"): {wall:.2f} s wall, blocks split {split}, GFA sha256 "
            f"{outs[dev][0][:16]}, MAF sha256 {outs[dev][1][:16]}"
            + (f", launches {launches}" if dev == "cuda" else ""))
        if not split or not max(split):
            fail("the split main path split no block")
        if dev == "cuda":
            per = sorted({c[3] for c in calls})
            walls = [c[4] for c in calls]
            say(f"split main path MinHash calls: {len(calls)}, rows "
                f"{min(c[0] for c in calls)}-{max(c[0] for c in calls)}, "
                f"longest row {max(c[1] for c in calls)} bp, pairs "
                f"{sum(c[2] for c in calls)} ({min(c[2] for c in calls)}-"
                f"{max(c[2] for c in calls)} a call), launches a call "
                f"(minhash_hash, minhash_inter) {per}, wall a call "
                f"{statistics.fmean(walls):.3f} ms (median "
                f"{statistics.median(walls):.3f}, {min(walls):.3f}-"
                f"{max(walls):.3f}, host to host)")
            if per != [(1, 1)]:
                fail(f"a MinHash call made other launches than one of each "
                     f"step: {per}")
    if outs["cuda"] != outs["cpu"]:
        fail("the split main path's kernels and plain versions gave other "
             "bytes")
    return launches


# phase 17's seeded plan: (local, tasks, (min L, max L), sequences in the
# graph + 1, div), then fan-in tasks and the long local query
BATCH_PLAN = ((True, 72, (150, 500), (3, 6), 0.03),
              (False, 72, (150, 500), (3, 6), 0.03),
              (True, 12, (600, 1200), (4, 8), 0.05),
              (False, 12, (600, 1200), (4, 8), 0.05),
              (True, 3, (1800, 2000), (3, 5), 0.05),
              (False, 3, (1800, 2000), (3, 5), 0.05))


def batch_groups(rng) -> list:
    """Phase 17's task groups, [(local, P or None, [(graph, query,
    params), ...]), ...]: BATCH_PLAN (P the slot bucket of each group's
    largest in-degree), fan-in tasks of in-degree 2-4, 5-8 and 9-15 packed
    at P = 4, 8 and 16, local and global, a local query of 8,400+ bases
    that ends in the graph's sequence, and a global query against a chain
    of 33,000 nodes (past int16 rows: its row tables stay in device
    memory)."""
    import numpy as np
    from smoothxg_tpu_torch.ops.poa_host import POAParams
    from smoothxg_tpu_torch.testing.synth import (make_fan_in_task,
                                                  make_round_task)
    groups = []
    for local, nt, (lo, hi), (smin, smax), div in BATCH_PLAN:
        p = POAParams(local=local)
        groups.append((local, None, [make_round_task(
            rng, int(rng.integers(lo, hi)), int(rng.integers(smin, smax + 1)),
            div, p) for _ in range(nt)]))
    for local in (True, False):
        p = POAParams(local=local)
        for P, widths in ((4, range(2, 5)), (8, range(5, 9)),
                          (16, range(9, 16))):
            groups.append((local, P, [make_fan_in_task(rng, w, 200, p)
                                      for w in widths]))
    p = POAParams(local=True)
    g, q, _ = make_round_task(rng, 200, 2, 0.03, p)
    groups.append((True, None, [(g, np.concatenate(
        [rng.choice(np.frombuffer(b"ACGT", np.uint8), 8300), q]), p)]))
    p = POAParams(local=False)
    g, q, _ = make_round_task(rng, 33_000, 2, 0.01, p)
    groups.append((False, None, [(g, q[20_000:20_040].copy(), p)]))
    return groups


def oracle_score(graph, seq, p) -> int:
    """The best score of poa_host's fill: the best cell (local), the best
    sink row at the last column (global)."""
    from smoothxg_tpu_torch.ops import poa_host
    H, _, _, _, row_of, _ = poa_host.fill(graph, seq, p)
    if p.local:
        return int(H.max())
    return max(int(H[row_of[v], len(seq)]) for v in graph.topo_order()
               if not graph.succs[v])


def batch_geometry_line(B: int, Vp: int, Lp: int, P: int) -> str:
    """A poa_batch launch's geometry (csrc/poa_batch.cu:poa_batch_geometry)
    and the ptxas registers of the instantiation it runs."""
    from smoothxg_tpu_torch.ops import _build
    from smoothxg_tpu_torch.ops.poa_batch import geometry
    g = geometry(B, Vp, Lp, P)
    rep = kernel_registers(_build.build_log["ptxas"]).get(
        ("poa_batch", (g["route"], g["tables"])), "")
    rows = ("one-tile rows, ring in shared memory" if g["route"] == "ring"
            else "tiled rows")
    return (f"B {B}, Vp {Vp}, Lp {Lp}, P {P}: {g['threads']} threads, "
            f"{rows}, tables in {g['tables']} memory, {g['smem']} B shared, "
            f"{g['per_sm']} blocks an SM, scratch "
            f"{g['scratch_bytes'] / 1e6:.1f} MB, {used(rep)} registers, "
            f"{spilled(rep)}")


def batch_phase(torch, dev, clock_mhz):
    """Phase 17.  Returns the batch kernel's JSON entry fields."""
    import collections

    import numpy as np
    from smoothxg_tpu_torch.ops.poa_batch import (geometry, pack_tasks,
                                                  poa_batch,
                                                  poa_batch_reference)
    from smoothxg_tpu_torch.tools.ring_reach import count_batch
    from smoothxg_tpu_torch.tools.time_chase import round_timing_task
    rng = np.random.default_rng(SEED + 4)
    n_tasks = n_oracle = max_err = 0
    slots: set = set()
    routes: set = set()
    reach: collections.Counter = collections.Counter()
    vmax = lmax = 0
    for local, P, tasks in batch_groups(rng):
        ins, _ = pack_tasks(tasks, P)
        got = poa_batch(*(x.to(dev) for x in ins), local)
        torch.cuda.synchronize()
        got = [x.cpu() for x in got]
        t0 = time.perf_counter()
        want = poa_batch_reference(*ins, local)
        plain_s = time.perf_counter() - t0
        for name, g, w in zip(("out", "outpos", "bv"), got, want):
            err = int((g.long() - w.long()).abs().max())
            max_err = max(max_err, err)
            if err:
                fail(f"batch kernel != plain version on {name} (local="
                     f"{local}, P {ins[1].shape[2]}, V {ins[0].shape[0]})")
        for b in range(0, len(tasks), 8):
            if int(got[2][b]) != oracle_score(*tasks[b]):
                fail(f"batch kernel score != poa_host.fill on task {b}")
            n_oracle += 1
        Vp, Lp, Pk = ins[0].shape[0], ins[2].shape[1], ins[1].shape[2]
        geo = geometry(len(tasks), Vp, Lp, Pk)
        routes.add((geo["route"], geo["tables"]))
        hist: collections.Counter = collections.Counter()
        count_batch(hist, ins[4].numpy(), ins[1].numpy())
        if geo["route"] == "ring":
            reach.update(hist)
        slots.add(Pk)
        vmax, lmax = max(vmax, Vp), max(lmax, Lp)
        n_tasks += len(tasks)
        say(f"batch kernel local={local} P={Pk}: {len(tasks)} "
            f"tasks (V up to {Vp}, L up to {Lp}, predecessors up to "
            f"{max(hist)} rows back) equal to the plain version "
            f"({plain_s:.1f} s); geometry "
            + batch_geometry_line(len(tasks), Vp, Lp, Pk))
    if n_tasks < 200:
        fail(f"only {n_tasks} batch tasks compared")
    if not {4, 8, 16} <= slots or lmax <= 8200:
        fail(f"slots covered {sorted(slots)}, longest query {lmax}")
    far = sum(v for d, v in reach.items() if d >= 8)
    if not far:
        fail("no ring-route task read a predecessor past the ring")
    if not any(t == "device" for _, t in routes):
        fail(f"no launch kept its row tables in device memory: {routes}")
    say(f"batch kernel routes {sorted(routes)}; on the ring route "
        f"{far} of {sum(reach.values())} predecessor reads past the ring "
        f"(8+ rows back, from device memory)")

    # timing on phase 6's main-path task shape (V ~1,200, L ~1,000)
    task = round_timing_task()
    cpu_ins, _ = pack_tasks([task])
    Vp, Lp, Pk = (cpu_ins[0].shape[0], cpu_ins[2].shape[1],
                  cpu_ins[1].shape[2])
    t0 = time.perf_counter()
    want = poa_batch_reference(*cpu_ins, True)
    plain_ms = (time.perf_counter() - t0) * 1e3
    ins = [x.to(dev) for x in cpu_ins]
    ms = cuda_ms(torch, lambda: poa_batch(*ins, True), reps=5)
    got = poa_batch(*ins, True)
    if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        fail("batch kernel != plain version on the timing task")
    copies = {}
    for nb in (132, 264):
        insB = [x.repeat_interleave(nb, dim=1 if x.dim() >= 2 and k < 2
                                    else 0).contiguous()
                for k, x in enumerate(ins)]
        copies[nb] = cuda_ms(torch, lambda: poa_batch(*insB, True), reps=1)
        got = poa_batch(*insB, True)
        if not all(torch.equal(g[-1].cpu(), w[0]) for g, w in zip(got, want)):
            fail(f"batch kernel != plain version on copy {nb} of the "
                 f"timing task")
        del insB, got
        torch.cuda.empty_cache()
    cells, pcells = round_dp_work(task[0], len(task[1]))
    bound_ms = int32_bound_ms(fill_ops(cells, pcells, True), clock_mhz)
    say(f"batch kernel timing, one main-path task (V={task[0].n_nodes()}, "
        f"L={len(task[1])}, local): kernel {ms:.3f} ms, plain version "
        f"{plain_ms:.1f} ms; " + "; ".join(
            f"{nb}-task launch {t:.3f} ms ({nb * 1e3 / t:.1f} tasks/s)"
            for nb, t in copies.items())
        + f"; bound {bound_ms:.5f} ms ({cells} DP cells, {pcells} extra "
        f"pred cells); geometry " + "; ".join(
            batch_geometry_line(nb, Vp, Lp, Pk) for nb in (1, 132, 264)))
    say(f"batch kernel vs plain version: {n_tasks} tasks equal (max abs err "
        f"{max_err}, tolerance 0: all outputs are integers), {n_oracle} "
        f"scores equal to poa_host.fill; slot buckets {sorted(slots)}, V up "
        f"to {vmax}, L up to {lmax}")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations",
            "library_ms": None}


def jax_main_path(gfa: str, ref_out: str, ref_maf: str, clock_mhz) -> int:
    """Phase 18: the port CLI with --engine jax and phase 4's flags,
    counted by `drive`; a spy keeps each launch's DP work and shape.
    Returns poa_batch's launches."""
    import collections
    from smoothxg_tpu_torch import cli
    from smoothxg_tpu_torch.ops.poa_batch import (TorchBatchPOAEngine,
                                                  slots_for)
    out, maf = (os.path.join(SMOKE_DIR, f"jax.{x}") for x in ("gfa", "maf"))
    work, shapes = [], []
    run_chunk = TorchBatchPOAEngine._run_chunk

    def spy(self, tasks, chunk, local, results, orders):
        work.extend((*round_dp_work(tasks[t][0], len(tasks[t][1])), local)
                    for t in chunk)
        shapes.append((len(chunk), max(tasks[t][0].n_nodes() for t in chunk),
                       max(len(tasks[t][1]) for t in chunk),
                       slots_for(max(len(ps) for t in chunk
                                     for ps in tasks[t][0].preds))))
        return run_chunk(self, tasks, chunk, local, results, orders)

    TorchBatchPOAEngine._run_chunk = spy
    log = Tee(sys.stderr)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(log):
            (rc, engine), launches = drive(
                lambda: cli.run(["-g", gfa, "-o", out, "-m", maf,
                                 *MAIN_FLAGS, "--engine", "jax"]),
                "poa_batch")
    finally:
        TorchBatchPOAEngine._run_chunk = run_chunk
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"port CLI --engine jax exited {rc}")
    st = engine.stats()
    tasks = st["device_tasks"] + st["fallbacks"]
    cells, pcells = (sum(w[i] for w in work) for i in (0, 1))
    bound = int32_bound_ms(sum(fill_ops(*w) for w in work), clock_mhz)
    say(f"jax main path (--engine jax): {wall:.2f} s wall, {tasks} round "
        f"tasks, {st['device_tasks']} on the kernel, {launches} launches, "
        f"device_wait_s {st['device_wait_s']} "
        f"({'; '.join(smoothing_phases(log.getvalue()))}); stats "
        f"{json.dumps(st)}; DP work of its {len(work)} launched tasks "
        f"{cells} cells, {pcells} extra pred cells, bound {bound:.3f} ms")
    from smoothxg_tpu_torch.ops.poa_batch import geometry
    Bs, Vs, Ls, Ps = zip(*shapes)
    kinds = collections.Counter(
        (g["route"], g["tables"], g["per_sm"])
        for g in (geometry(*x) for x in shapes))
    say(f"jax main path launch geometry: {len(shapes)} launches of "
        f"{min(Bs)}-{max(Bs)} tasks, V {min(Vs)}-{max(Vs)}, L "
        f"{min(Ls)}-{max(Ls)}, P {sorted(set(Ps))}; (route, tables, blocks "
        f"an SM): launches {dict(kinds)}; the largest: "
        + batch_geometry_line(*max(shapes, key=lambda x: x[0] * x[1] * x[2])))
    if st["device_tasks"] < 0.9 * tasks:
        fail(f"only {st['device_tasks']}/{tasks} round tasks ran on the "
             f"kernel")
    same_bytes("jax main path", out, maf, ref_out, ref_maf)
    return launches


def shard_phase(torch, dev) -> None:
    """Phase 19: the sharded round functions and TorchPOAEngine(devices=)
    against one launch or one shard, over [card 0, card 0] and, with more
    cards, over all of them."""
    import numpy as np
    from smoothxg_tpu_torch.ops import poa_batch as pb
    from smoothxg_tpu_torch.ops import poa_round as pr
    from smoothxg_tpu_torch.ops.poa_engine import POAParams, TorchPOAEngine
    from smoothxg_tpu_torch.parallel.mesh import (sharded_pallas_round,
                                                  sharded_poa_round)
    from smoothxg_tpu_torch.testing.synth import make_round_task
    from smoothxg_tpu_torch.tools.time_chase import (PHASE3_PLAN,
                                                     phase3_blocks)
    n = torch.cuda.device_count()
    meshes = [[dev, dev]] + ([[torch.device("cuda", k) for k in range(n)]]
                             if n > 1 else [])
    rng = np.random.default_rng(SEED + 5)
    tasks = [make_round_task(rng, int(rng.integers(200, 700)),
                             int(rng.integers(3, 9)), 0.03,
                             POAParams(local=local))
             for local in (True, False) for _ in range(24)]
    for local in (True, False):
        mine = [t for t in tasks if t[2].local == local]
        ins, _ = pb.pack_tasks(mine)
        one = [x.cpu() for x in pb.poa_batch(*(x.to(dev) for x in ins),
                                             local)]
        rins, _ = pr.pack_tasks(mine)
        pallas = pr.to_pallas_inputs(*rins)
        VW, LW, P = pallas[3].shape[1] * 128 // (2 + rins[5].shape[2]), \
            pallas[4].shape[2], rins[5].shape[2]
        rone = [x.cpu() for x in pr.poa_round(
            *(x.to(dev) for x in pr.from_pallas_layout(*pallas, P)), local)]
        for mesh in meshes:
            got = sharded_poa_round(mesh, *ins, local=local)
            if not all(torch.equal(g.cpu(), w) for g, w in zip(got, one)):
                fail(f"sharded_poa_round over {mesh} != one launch")
            got = sharded_pallas_round(mesh, *pallas, VW=VW, LW=LW, P=P,
                                       local=local)
            if not all(torch.equal(g.cpu(), w) for g, w in zip(got, rone)):
                fail(f"sharded_pallas_round over {mesh} != one launch")
        say(f"sharding: {len(mine)} round tasks (local={local}) through "
            f"sharded_poa_round and sharded_pallas_round over "
            f"{' and '.join(str([str(d) for d in m]) for m in meshes)} "
            f"equal to one launch of poa_batch / poa_round")

    groups = phase3_blocks(np.random.default_rng(SEED))
    blocks = [(sq, [1] * len(sq), POAParams(local=local,
                                            wb=311 if banded else -1))
              for (_, local, banded, *_), grp in zip(PHASE3_PLAN, groups)
              for sq in grp]

    def raw(engine, blks):
        out = {}
        for i, kind, payload in engine.poa_block_batch_iter(blks):
            out[i] = ((kind, payload.base, payload.seq_paths)
                      if kind == "graph" else
                      (kind, *(np.asarray(x).tolist() for x in payload[:3]),
                       [np.asarray(x).tolist() for x in payload[3]],
                       payload[4]))
        return out

    for tag, kw, blks in (("win", {}, blocks),
                          ("code", {"shape": (8704, 4096)},
                           blocks[:PHASE3_PLAN[0][3]]),
                          ("stacked", {"kernel": "stacked"},
                           blocks[:PHASE3_PLAN[0][3]])):
        want = raw(TorchPOAEngine(device=dev, **kw), blks)
        for mesh in meshes:
            eng = TorchPOAEngine(device=dev, devices=mesh, **kw)
            if raw(eng, blks) != want:
                fail(f"TorchPOAEngine({tag}, devices={mesh}) != one shard")
        say(f"sharding: TorchPOAEngine kernel {tag}, {len(blks)} of phase "
            f"3's blocks over each mesh equal to one shard "
            f"(stats {json.dumps(eng.stats())})")
        torch.cuda.empty_cache()


def ranks_phase(gfa: str, ref_out: str, ref_maf: str) -> None:
    """Phase 20: two ranks of the port CLI (--dist-size 2, -t 4, phase 4's
    other flags): both exit 0, each smooths its shard of the blocks on the
    card (its engine's blocks are those of its all-gather payloads, and at
    least 90% of them ran on the kernel, as on the main path), the shards
    add up to every block, and rank 0's bytes equal phase 5's."""
    import ast
    import re
    from smoothxg_tpu_torch.testing.ranks import run_ranks
    flags = [*MAIN_FLAGS[:MAIN_FLAGS.index("-t")], "-t", "4"]
    out, maf = (os.path.join(SMOKE_DIR, f"ranks.{x}") for x in ("gfa", "maf"))
    t0 = time.perf_counter()
    res = run_ranks(["-g", gfa, "-o", out, "-m", maf, *flags], 2,
                    timeout=600)
    wall = time.perf_counter() - t0
    shards = []
    for r, (rc, err) in enumerate(res):
        if rc != 0:
            fail(f"rank {r} of the two-rank run exited {rc}: {err[-1500:]}")
        eng = [ln for ln in err.splitlines() if "::engine]" in ln]
        gather = [ln.split("] ", 1)[-1] for ln in err.splitlines()
                  if "all-gather payload" in ln]
        say(f"two ranks, rank {r}: exit 0 ({'; '.join(smoothing_phases(err))}"
            f"); {'; '.join(gather)}; {eng[-1] if eng else 'no engine line'}")
        if not eng:
            fail(f"rank {r} printed no engine stats")
        st = ast.literal_eval(eng[-1].split("] ", 1)[1])
        shard = sum(int(re.search(r" for (\d+) blocks", ln).group(1))
                    for ln in gather)
        total = st["device_blocks"] + st["fallbacks"] + st["redo"]
        if total != shard or shard == 0:
            fail(f"rank {r}: its engine took {total} blocks, its shard "
                 f"holds {shard}")
        if st["kernel_launches"] == 0 or st["device_blocks"] < 0.9 * shard:
            fail(f"rank {r}: {st['kernel_launches']} kernel launches, "
                 f"{st['device_blocks']}/{shard} blocks on the card")
        shards.append(shard)
    blocks = sum(int(re.match(r"smoothing (\d+) blocks", ln).group(1))
                 for ln in smoothing_phases(res[0][1]))
    if sum(shards) != blocks:
        fail(f"the ranks' shards {shards} do not add up to the run's "
             f"{blocks} blocks")
    say(f"two ranks (--dist-size 2, {' '.join(flags)}): {wall:.2f} s wall, "
        f"shards {shards} of {blocks} blocks, each on the card")
    same_bytes("two-rank main path", out, maf, ref_out, ref_maf)


def conv1d_counts(torch, buf, lens, lags, want):
    """The match counts by one grouped torch.nn.functional.conv1d over
    one-hot rows (a channel a symbol of the batch, each row's one-hot the
    weight of its own groups, its input shifted by the first lag, the
    stride the grid's): (ms of the call, "exact") when they equal `want`
    exactly, else (None, the reason).  Timed here as a yardstick only."""
    import numpy as np
    B, Lpad = buf.shape
    G, lag0 = len(lags), int(lags[0])
    stride = int(lags[1] - lags[0]) if G > 1 else 1
    dev = want.device
    syms = np.unique(np.concatenate([buf[b, :n] for b, n in
                                     enumerate(lens)]))
    rows = torch.from_numpy(buf).to(dev)
    live = torch.arange(Lpad, device=dev)[None, :] < \
        torch.from_numpy(lens).to(dev)[:, None]
    w = ((rows[:, None, :] == torch.from_numpy(syms).to(dev)[None, :, None])
         & live[:, None, :]).float()                       # (B, S, Lpad)
    S = len(syms)
    x = torch.zeros((B, S, (G - 1) * stride + Lpad), device=dev)
    x[:, :, :Lpad - lag0] = w[:, :, lag0:]
    x, w = x.reshape(1, B * S, -1), w.reshape(B * S, 1, Lpad)

    def run():
        return torch.nn.functional.conv1d(x, w, stride=stride, groups=B * S)

    try:
        got = run().reshape(B, S, G).sum(1).round().to(torch.int32)
    except RuntimeError as e:
        return None, f"conv1d raised: {str(e)[:120]}"
    if not torch.equal(got, want):
        return None, (f"not exact: max abs err "
                      f"{int((got.long() - want.long()).abs().max())}")
    return cuda_ms(torch, run, reps=3), \
        f"exact ({S} symbols, {B * S} groups of {Lpad} taps)"


def autocorr_plan_line(stats: dict, lens, lags) -> str:
    """A plan's units (position compares a unit: mean and max of the
    stretch x lag group), those read from device memory, and its rows a
    route."""
    from smoothxg_tpu_torch.ops.autocorr import unit_positions
    pos = unit_positions(stats, lens, lags)
    return (f"{stats['units']} units of {stats['lags_per_unit']} lags x a "
            f"stretch ({pos.mean():.0f} position compares a unit on "
            f"average, at most {pos.max()}), {stats['device_units']} from "
            f"device memory; rows a route {stats['routes']}")


def autocorr_phase(torch, dev, clock_mhz):
    """Phase 21.  Returns the kernel's JSON entry fields and its launches
    on the repeat_batch path."""
    from smoothxg_tpu_torch.ops import _build
    from smoothxg_tpu_torch.ops.autocorr import (autocorr_counts,
                                                 autocorr_counts_reference,
                                                 geometry, repeat,
                                                 repeat_batch)
    from smoothxg_tpu_torch.tools.time_autocorr import (LAGS, batch, bounds,
                                                        escape_rows,
                                                        phase21_rows)
    # phase 21's rows (tandem, random, runs of N) and the escape-heavy ones
    # (lower case, all N, random bytes, soft-masked), seeded from SEED + 21
    # and + 22, at the CLI's defaults (-c 1000, -C 20000, stride 50)
    seqs = phase21_rows(seed=SEED + 21)
    min_lag, max_lag, stride = LAGS
    buf, lens, lags = batch(seqs)
    B, G, Lpad = len(seqs), len(lags), buf.shape[1]
    ins = [torch.from_numpy(x).to(dev) for x in (buf, lens, lags)]
    stats: dict = {}
    got = autocorr_counts(*ins, stats=stats)
    want = autocorr_counts_reference(*ins)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err:
        fail(f"autocorr kernel != plain version: max abs err {err}")
    ms = cuda_ms(torch, lambda: autocorr_counts(*ins), reps=20)
    plain_ms = cuda_ms(torch, lambda: autocorr_counts_reference(*ins))
    lib_ms, lib_note = conv1d_counts(torch, buf, lens, lags, want)
    torch.cuda.empty_cache()
    # the least time: every window's positions at 16 a lane operation (two
    # 32-position planes, two operations a word) at 132 SMs x 128 lanes x
    # clock, or the rows read once and the counts written once; beside it
    # the first design's bound, a lane operation a 4-byte word compare
    bd = bounds(lens, lags, clock_mhz)
    bound_ms = max(bd["density_ms"], bd["bytes_ms"])
    bound_by = "operations" if bd["density_ms"] >= bd["bytes_ms"] \
        else "bytes"
    geo = geometry(B, Lpad, G)
    regs = {name: f"{used(r)} registers, {spilled(r)}"
            for e, r in ptxas_registers(_build.build_log["ptxas"]).items()
            for name in ("autocorr_pack_kernel", "autocorr_count_kernel")
            if name in e}
    say(f"autocorr: {B} rows of {int(lens.min())}-{int(lens.max())} bases "
        f"({int(lens.sum())} in all; tandem, random, runs of N), {G} lags "
        f"{int(lags[0])}-{int(lags[-1])} every {stride}: kernels equal to "
        f"the plain version (max abs err 0, tolerance 0: integer counts); "
        f"kernels {ms:.4f} ms a call, plain version {plain_ms:.3f} ms, "
        f"grouped conv1d over one-hot rows "
        f"{'%.3f ms' % lib_ms if lib_ms is not None else 'none'} "
        f"({lib_note}); bound {bound_ms:.4f} ms by {bound_by} "
        f"({bd['positions']} position compares at 16 a lane operation at "
        f"{clock_mhz:.0f} MHz: {bd['density_ms']:.4f} ms; {bd['bytes']} B "
        f"at 3.35 TB/s: {bd['bytes_ms']:.4f} ms; the first design's "
        f"{bd['word_compares']} 4-byte word compares: "
        f"{bd['word_ms']:.4f} ms)")
    say(f"autocorr geometry: {geo['pack_blocks']} pack blocks (a chunk of "
        f"8,192 positions of a row each), then {geo['grid']} persistent "
        f"count blocks of {geo['threads']} threads ({geo['blocks_per_sm']} "
        f"an SM, {geo['smem']} B shared each in two staging buffers, a unit "
        f"list of up to "
        f"{geo['unit_cap']}); plan: {autocorr_plan_line(stats, lens, lags)};"
        f" ptxas {regs or 'no report'}")
    # the escape-heavy batch: lower case, all N, random bytes, soft-masked
    eseqs = escape_rows(seed=SEED + 22)
    ebuf, elens, elags = batch(eseqs)
    eins = [torch.from_numpy(x).to(dev) for x in (ebuf, elens, elags)]
    estats: dict = {}
    egot = autocorr_counts(*eins, stats=estats)
    ewant = autocorr_counts_reference(*eins)
    torch.cuda.synchronize()
    eerr = int((egot.long() - ewant.long()).abs().max())
    if eerr:
        fail(f"autocorr kernel != plain version on the escape-heavy batch: "
             f"max abs err {eerr}")
    ems = cuda_ms(torch, lambda: autocorr_counts(*eins), reps=20)
    ebd = bounds(elens, elags, clock_mhz)
    say(f"autocorr, escape-heavy batch: {len(eseqs)} rows of "
        f"{int(elens.min())}-{int(elens.max())} bases (lower case, all N, "
        f"random bytes, soft-masked), {len(elags)} lags: equal to the plain "
        f"version (max abs err 0); kernels {ems:.4f} ms a call, bound "
        f"{max(ebd['density_ms'], ebd['bytes_ms']):.4f} ms (the first "
        f"design's {ebd['word_ms']:.4f} ms); plan: "
        f"{autocorr_plan_line(estats, elens, elags)}")
    t0 = time.perf_counter()
    res, launches = drive(lambda: repeat_batch(seqs, min_lag, max_lag,
                                               stride=stride, device=dev),
                          "autocorr")
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = [repeat(s, min_lag, max_lag, stride=stride) for s in seqs]
    host_s = time.perf_counter() - t0
    bad = [i for i, (a, r) in enumerate(zip(res, ref))
           if (a.length, a.z_score) != (r.length, r.z_score)]
    if bad:
        fail(f"repeat_batch != repeat on rows {bad[:5]}")
    say(f"autocorr main path (repeat_batch on {dev}): {launches} launches "
        f"(the pack and count kernels), {wall:.3f} s host to host; all {B} "
        f"rows' (length, z) equal to repeat's "
        f"({sum(r.length > 0 for r in res)} repeats found; repeat on the "
        f"host {host_s:.2f} s)")
    return ({"max_abs_err": max(err, eerr), "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": lib_ms}, launches)


def steal_main_path(gfa: str, ref_out: str, ref_maf: str) -> int:
    """Phase 22 (a): the fused main path in one rank at -t 1 -T 4 through
    run_smoothing (the engine make_engine builds: the steal on by default,
    the warm-up in the background); GFA and MAF sha256 equal to phase 5's.
    Prints stats() and, when nothing was stolen, whether the gate (no call
    held more device-eligible blocks than max_batch x cards) or the rates
    held it back.  Returns poa_win's launches."""
    from smoothxg_tpu_torch import cli
    from smoothxg_tpu_torch.ops.poa_engine import TorchPOAEngine
    from smoothxg_tpu_torch.pipeline.run import run_smoothing
    out, maf = (os.path.join(SMOKE_DIR, f"steal.{x}") for x in ("gfa", "maf"))
    args = cli.build_parser().parse_args(["-g", gfa, "-o", out, "-m", maf,
                                          *MAIN_FLAGS, "-T", "4"])
    cfg = cli.config_from_args(args, add_consensus=not args.vanish_consensus)
    calls, picks = [], []         # blocks a call; (candidates, stolen)
    it, select = (TorchPOAEngine.poa_block_batch_iter,
                  TorchPOAEngine._select_steal)

    def it_spy(self, blocks):
        calls.append(len(blocks))
        return it(self, blocks)

    def select_spy(self, blocks, dev):
        n = sum(map(len, dev.values()))
        got = select(self, blocks, dev)
        picks.append((n, len(got)))
        return got

    TorchPOAEngine.poa_block_batch_iter = it_spy
    TorchPOAEngine._select_steal = select_spy
    log = Tee(sys.stderr)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(log):
            engine, launches = drive(lambda: run_smoothing(cfg)[2], "poa_win")
    finally:
        TorchPOAEngine.poa_block_batch_iter = it
        TorchPOAEngine._select_steal = select
    wall = time.perf_counter() - t0
    st = engine.stats()
    if not picks:
        why = (f"the gate: no call held more than max_batch x cards = "
               f"{engine.max_batch * len(engine.devices)} device-eligible "
               f"blocks (calls of {calls} blocks)")
    elif not st["stolen"]:
        why = (f"the rates: {picks} (candidates, stolen) at "
               f"{st['dev_rows_per_s']} rows/s, {st['host_cells_per_s']} "
               f"cells/s a worker")
    else:
        why = f"(candidates, stolen) a call {picks}"
    say(f"steal main path (-t 1 -T 4, steal={engine.steal}): {wall:.2f} s "
        f"wall, {st['stolen']} blocks stolen, {why} "
        f"({'; '.join(smoothing_phases(log.getvalue()))}); poa_win launches "
        f"{launches}; stats {json.dumps(st)}")
    same_bytes("steal main path", out, maf, ref_out, ref_maf)
    return launches


def steal_phase(torch, dev) -> None:
    """Phase 22 (b): a forced steal on phase 3's blocks: max_batch 8 and
    rates set on the instance so that about half the device rows go to
    the native pool; every graph equals the steal-off engine's."""
    import numpy as np
    from smoothxg_tpu_torch.ops.poa_engine import POAParams, TorchPOAEngine
    from smoothxg_tpu_torch.tools.time_chase import (PHASE3_PLAN,
                                                     phase3_blocks)
    blocks = [(sq, [1] * len(sq), POAParams(local=local,
                                             wb=311 if banded else -1))
              for (_, local, banded, *_), group in zip(
                  PHASE3_PLAN, phase3_blocks(np.random.default_rng(SEED)))
              for sq in group]
    graphs, stats = {}, {}
    for tag, steal in (("steal", True), ("off", False)):
        eng = TorchPOAEngine(device=dev, threads=4, max_batch=8, steal=steal)
        nat, rows = (sum(eng._steal_costs(b[0])[k] for b in blocks)
                     for k in (0, 1))
        eng._dev_rows_ps, eng._host_cells_ps = 1.0, nat / rows / 3
        t0 = time.perf_counter()
        graphs[tag] = eng.poa_block_batch(blocks)
        stats[tag] = (time.perf_counter() - t0, eng.stats())
    wall, st = stats["steal"]
    done = st["stolen"] + st["device_blocks"] + st["fallbacks"] + st["redo"]
    if not st["stolen"] or done != len(blocks):
        fail(f"forced steal: {st['stolen']} stolen, {done} of {len(blocks)} "
             f"blocks accounted for")
    for b, (g, h) in enumerate(zip(graphs["steal"], graphs["off"])):
        if list(g.base) != list(h.base) or [list(p) for p in g.seq_paths] \
                != [list(p) for p in h.seq_paths]:
            fail(f"forced steal: block {b}'s graph differs from the "
                 f"steal-off engine's")
    say(f"forced steal on phase 3's {len(blocks)} blocks (max_batch 8, "
        f"threads 4): {st['stolen']} stolen, {st['device_blocks']} on the "
        f"kernel, {st['redo']} redone; every graph equal to the steal-off "
        f"engine's ({wall:.2f} s against {stats['off'][0]:.2f} s); rates "
        f"after: {st['dev_rows_per_s']} rows/s, {st['host_cells_per_s']} "
        f"cells/s a worker")


def sanitize_phase() -> None:
    """Phase 23: tools/sanitize.py's card part, its harness in child
    processes (the four compute-sanitizer tools at once, then the guard
    allocator); fails on any report outside tools/sanitize.EXPECTED, a
    guard band written or an entry unequal to its plain version."""
    from smoothxg_tpu_torch.tools import sanitize
    t0 = time.perf_counter()
    res = sanitize.run_card(echo=say,
                            log_dir=os.path.join(SMOKE_DIR, "sanitize"))
    ran = [r["tool"] for r in res["tools"] if r["supported"]]
    say(f"sanitizers: {time.perf_counter() - t0:.1f} s; compute-sanitizer "
        f"{res['version']} ({res['path']}) ran {len(ran)} of "
        f"{len(sanitize.TOOLS)} tools {ran}; the guard allocator "
        f"{'passed' if res['guard']['ok'] else 'FAILED'}")
    if not res["ok"]:
        fail("sanitizers: " + json.dumps(
            [r for r in res["tools"] + [res["guard"]] if not r.get("ok")])
            [:3000])


# phase 24: deep blocks.  pggb passes its haplotype count as -r, so a
# block holds about as many sequences as the pangenome has haplotypes;
# HPRC's year-1 release graph has 90
DEEP_HAPS = 90
DEEP_ARGS = ["-r", str(DEEP_HAPS), "-j", "5k", "-e", "5k"]
DEEP_FLAGS = DEEP_ARGS + ["-l", "700,900,1100", "-t", "1"]
DEEP_SEQS = (64, 96)         # sequences of the kernels' deep blocks
DEEP_LEN = 100               # their bases (the plain versions' time)
DEEP_KERNELS = ("poa_win", "poa_code", "poa_stacked")


def plain_outputs(name: str, ins, caps) -> tuple:
    """A whole-block kernel's plain version on numpy inputs, in a worker
    process of phase 24's pool (one thread); returns its numpy outputs
    and its seconds."""
    import torch
    from smoothxg_tpu_torch.ops.poa_code import poa_code_reference
    from smoothxg_tpu_torch.ops.poa_stacked import poa_stacked_reference
    from smoothxg_tpu_torch.ops.poa_win import poa_win_reference
    torch.set_num_threads(1)
    ref = {"poa_win": poa_win_reference, "poa_code": poa_code_reference,
           "poa_stacked": poa_stacked_reference}[name]
    t0 = time.perf_counter()
    out = ref(*(torch.from_numpy(x) for x in ins), caps)
    return [x.numpy() for x in out], time.perf_counter() - t0


def deep_kernels_phase(torch, dev, pool) -> None:
    """Phase 24 (a): blocks of 64 and 96 sequences (make_block's copies,
    each with its own indels, and make_population_block's, copies of 8
    founders) through the three whole-block kernels at the bulk tier
    (4352, 2048), local, at the predecessor slots the engine launches
    them with, each equal to its plain version (run in `pool`'s worker
    processes meanwhile) and every block it did not flag to the native
    engine; poa_win also at the TPU's 4 predecessor slots, to count what
    they flag, with each block's native V and in-degree."""
    import dataclasses

    import numpy as np
    from smoothxg_tpu_torch.ops.poa_engine import POAParams, TorchPOAEngine
    from smoothxg_tpu_torch.ops.poa_win import pack_blocks, row_stride
    from smoothxg_tpu_torch.testing.synth import (make_block,
                                                  make_population_block)
    from smoothxg_tpu_torch.tools.time_chase import CAPS, block_kernel
    kern = {name: block_kernel(name) for name in DEEP_KERNELS}
    caps = {name: mk(*CAPS) for name, (_, mk) in kern.items()}
    native = TorchPOAEngine(device=dev).fallback
    p = POAParams(local=True)
    groups = []
    for n in DEEP_SEQS:
        rng = np.random.default_rng(SEED + 24 + n)
        groups.append((n, [make_block(rng, DEEP_LEN, n, 0.01),
                           make_population_block(rng, DEEP_LEN, n, 0.01)]))
    runs = []
    for n, blocks in groups:
        ins = pack_blocks([(sq, p) for sq in blocks], CAPS[1])
        for name in DEEP_KERNELS:
            fut = pool.submit(plain_outputs, name,
                              [x.numpy() for x in ins], caps[name])
            got = kern[name][0](*(x.to(dev) for x in ins), caps[name])
            torch.cuda.synchronize()
            runs.append((n, blocks, ins, name, fut,
                         [x.cpu() for x in got]))
        tpu = kern["poa_win"][0](
            *(x.to(dev) for x in ins),
            dataclasses.replace(caps["poa_win"], pcap=4))[0].cpu()
        graphs = native.poa_block_batch([(sq, [1] * n, p)
                                         for sq in blocks])
        why = []
        for sq, g in zip(blocks, graphs):
            preds: dict = {}
            for pth in g.seq_paths:
                for u, v in zip(pth, pth[1:]):
                    preds.setdefault(v, set()).add(u)
            why.append((len(g.base), max(map(len, preds.values()))))
        say(f"deep blocks of {n} sequences (make_block, population) "
            f"of ~{DEEP_LEN} bases: native V {[v for v, _ in why]}, "
            f"in-degree {[d for _, d in why]}; poa_win at the TPU's 4 "
            f"predecessor slots flags {int(tpu[:, 1].sum())} of "
            f"{len(blocks)}")
    flagged: dict = {}
    for n, blocks, ins, name, fut, got in runs:
        want = [torch.from_numpy(x) for x in fut.result()[0]]
        label = f"{name} deep {n}"
        err = hold_to_plain(got, want, label)
        n_nat = hold_to_native(native, blocks, p, got, label)
        flags = got[0][:, 1].tolist()
        flagged.setdefault(name, []).extend(flags)
        say(f"{label}: {len(blocks)} blocks equal to the plain version "
            f"(max abs err {err}), {n_nat} equal to native, flags "
            f"{flags} at {caps[name].pcap} predecessor slots; V "
            f"{got[0][:, 0].tolist()}; geometry " + geometry_line(
                name, len(blocks), caps[name],
                row_stride(ins[1], CAPS[1])))
    say("deep blocks redone (overflow flag) by kernel: " + ", ".join(
        f"{name} {sum(f)} of {len(f)} ({caps[name].pcap} slots)"
        for name, f in flagged.items()))


def deep_plain(pool) -> dict:
    """Phase 24 (c), submitted first (the longest jobs of `pool`): each
    whole-block kernel's plain version on the deep timing block, all 96
    sequences of tools/time_chase.deep_block."""
    from smoothxg_tpu_torch.ops.poa_engine import POAParams
    from smoothxg_tpu_torch.ops.poa_win import pack_blocks
    from smoothxg_tpu_torch.tools import time_chase
    ins = [x.numpy() for x in pack_blocks(
        [(time_chase.deep_block(), POAParams(local=True))],
        time_chase.CAPS[1])]
    return {name: pool.submit(plain_outputs, name, ins,
                              time_chase.block_kernel(name)[1](
                                  *time_chase.CAPS))
            for name in DEEP_KERNELS}


def hold_deep_plain(torch, dev, got: dict, plain: dict) -> None:
    """Phase 24 (c): each kernel's outputs on the deep timing block (R 96,
    from phase 24 (b)) equal to its plain version (deep_plain's futures)
    and to the native engine."""
    from smoothxg_tpu_torch.ops.poa_engine import POAParams, TorchPOAEngine
    from smoothxg_tpu_torch.tools import time_chase
    deep = time_chase.deep_block()
    p = POAParams(local=True)
    native = TorchPOAEngine(device=dev).fallback
    t0 = time.perf_counter()
    for name in DEEP_KERNELS:
        out, plain_s = plain[name].result()
        label = f"{name} deep timing block (R {len(deep)})"
        err = hold_to_plain(got[name], [torch.from_numpy(x) for x in out],
                            label)
        n_nat = hold_to_native(native, [deep], p, got[name], label)
        say(f"{label}: equal to the plain version (max abs err {err}; "
            f"plain version {plain_s:.1f} s on one worker), {n_nat} of 1 "
            f"equal to native")
    say(f"deep timing block's plain versions: waited "
        f"{time.perf_counter() - t0:.1f} s for them")


def deep_timing_phase(torch, dev, clock_mhz) -> dict:
    """Phase 24 (b): each whole-block kernel on one block of the first
    16, 64 and 96 sequences of tools/time_chase.deep_block (CUDA events,
    the fastest of 2 launches after a warm one), the three kernels'
    outputs equal to each other, beside the fill's bound.  Returns each
    kernel's outputs at the deepest R."""
    from smoothxg_tpu_torch.ops.poa_engine import POAParams
    from smoothxg_tpu_torch.ops.poa_win import pack_blocks, row_stride
    from smoothxg_tpu_torch.tools import time_chase
    from smoothxg_tpu_torch.tools._probe import measure
    deep = time_chase.deep_block()
    p = POAParams(local=True)
    for r in time_chase.DEEP:
        ins = [x.to(dev) for x in pack_blocks([(deep[:r], p)],
                                              time_chase.CAPS[1])]
        times, outs = {}, {}
        for name in DEEP_KERNELS:
            kern, mkcaps = time_chase.block_kernel(name)
            caps = mkcaps(*time_chase.CAPS)
            outs[name] = [x.cpu() for x in kern(*ins, caps)]
            if int(outs[name][0][0, 1]):
                fail(f"{name}: the deep timing block flags at R {r}")
            times[name] = measure(lambda: kern(*ins, caps), 2)
        for name in DEEP_KERNELS[1:]:
            if not all(torch.equal(a, b) for a, b in zip(
                    outs[name], outs["poa_win"])):
                fail(f"{name} != poa_win on the deep timing block, R {r}")
        paths = outs["poa_win"][2]
        cells, pcells = win_dp_work(deep[:r], [
            paths[0, k, :len(s)].tolist() for k, s in enumerate(deep[:r])])
        bound = int32_bound_ms(fill_ops(cells, pcells, True), clock_mhz)
        say(f"deep timing R {r} (V {int(outs['poa_win'][0][0, 0])}, LS "
            f"{row_stride(ins[1], time_chase.CAPS[1])}): " + ", ".join(
                f"{n} {ms:.3f} ms" for n, ms in times.items())
            + f" (outputs equal); bound {bound:.4f} ms ({cells} DP cells, "
            f"{pcells} extra pred cells)")
    return outs


def deep_phase(torch, dev, clock_mhz) -> None:
    """Phase 24: deep blocks through the three whole-block kernels, then
    the fused CLI on the 90 x 80 kb pangenome at -t 1 (bytes equal to the
    JAX package's --engine native run, started in a subprocess first)
    and at -t 4 -l 700 in one rank.  The plain versions run meanwhile in
    a pool of spawned workers, shut down before the -t 4 run."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from smoothxg_tpu_torch import cli
    from smoothxg_tpu_torch.testing.synth import write_pangenome
    from smoothxg_tpu_torch.utils import procpool
    t0 = time.perf_counter()
    pool = ProcessPoolExecutor(
        max_workers=len(DEEP_SEQS) * len(DEEP_KERNELS),
        mp_context=multiprocessing.get_context("spawn"))
    gfa = write_pangenome(os.path.join(SMOKE_DIR, "deep.gfa"),
                          haplotypes=DEEP_HAPS, length=80_000, seed=SEED)
    out, maf, ref_out, ref_maf = (
        os.path.join(SMOKE_DIR, f"deep_{t}.{x}")
        for t in ("port", "native") for x in ("gfa", "maf"))
    with open(os.path.join(SMOKE_DIR, "deep_native.log"), "w") as ref_log:
        ref = subprocess.Popen(
            [sys.executable, "-m", "smoothxg_tpu.cli", "-g", gfa, "-o",
             ref_out, "-m", ref_maf, *DEEP_FLAGS, "--engine", "native"],
            cwd=HERE, env=dict(os.environ, JAX_PLATFORMS="cpu"),
            stdout=ref_log, stderr=subprocess.STDOUT)
        try:
            plain = deep_plain(pool)
            deep_kernels_phase(torch, dev, pool)
            torch.cuda.empty_cache()
            got = deep_timing_phase(torch, dev, clock_mhz)
            torch.cuda.empty_cache()
            block_main_path(
                f"deep main path ({DEEP_HAPS} x 80 kb, -t 1)", "poa_win",
                lambda: cli.run(["-g", gfa, "-o", out, "-m", maf,
                                 *DEEP_FLAGS]), clock_mhz, depth=48)
            hold_deep_plain(torch, dev, got, plain)
            rc = ref.wait(timeout=900)
        finally:
            pool.shutdown(cancel_futures=True)
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    with open(os.path.join(SMOKE_DIR, "deep_native.log")) as f:
        ref_text = f.read()
    if rc != 0:
        fail(f"deep native reference exited {rc}: {ref_text[-800:]}")
    say(f"deep identity: native engine run "
        f"({'; '.join(smoothing_phases(ref_text))})")
    same_bytes("deep main path", out, maf, ref_out, ref_maf)
    o4, m4 = (os.path.join(SMOKE_DIR, f"deep_t4.{x}") for x in ("gfa", "maf"))
    block_main_path(
        f"deep main path ({DEEP_HAPS} x 80 kb, -t 4 -l 700, one rank)",
        "poa_win", lambda: cli.run(["-g", gfa, "-o", o4, "-m", m4,
                                    *DEEP_ARGS, "-l", "700", "-t", "4"]),
        clock_mhz, depth=48)
    procpool.shutdown()
    say(f"deep phase: {time.perf_counter() - t0:.1f} s")


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
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.split()
    say(f"device: {kind} ({smi}, max SM clock {clock_mhz:.0f} MHz, compute "
        f"mode {','.join(mode) or '?'}), torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, count {torch.cuda.device_count()}")

    from smoothxg_tpu_torch.ops import _build
    from smoothxg_tpu_torch.ops.poa_engine import TorchPOAEngine
    t0 = time.perf_counter()
    _build.load()
    t_cuda = time.perf_counter() - t0
    say(f"build: CUDA kernels, one nvcc per source for sm_90a started "
        f"together and one link, {t_cuda:.2f} s ({_build.lib_path()}); "
        + build_summary(_build.build_log["ptxas"]))
    # the port's host C++ libraries build with g++ at first use; build
    # them here so the main paths' walls are not charged for them
    for name in _build.HOST_NAMES:
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
    rshapes = []                 # each launch's (VW, LS, P)
    launch = TorchRoundPOAEngine._launch

    def round_spy(self, tasks, chunk, local):
        rwork.extend((*round_dp_work(tasks[t][0], len(tasks[t][1])), local)
                     for t in chunk)
        rshapes.append((
            max(1, *(tasks[t][0].n_nodes() for t in chunk)),
            max(1, *(len(tasks[t][1]) for t in chunk)),
            max([1] + [len(ps) for t in chunk for ps in tasks[t][0].preds])))
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
    from smoothxg_tpu_torch.ops.poa_round import geometry as round_geometry
    rgeos: dict = {}              # launches and shared bytes, by layout
    for shape in rshapes:
        g = round_geometry(*shape)
        key = (g["threads"], g["ring"], g["seq"], g["tables"], g["per_sm"])
        rgeos.setdefault(key, []).append(g["smem"])
    say(f"round main path launch geometry (VW {min(v for v, _, _ in rshapes)}"
        f"-{max(v for v, _, _ in rshapes)}, LS "
        f"{min(ls for _, ls, _ in rshapes)}-{max(ls for _, ls, _ in rshapes)}"
        f", P up to {max(p for _, _, p in rshapes)}): " + "; ".join(
            f"{len(sm)} x [{t} threads, "
            f"{'ring' if ring else 'tiled'}, sequence in {sq} memory, "
            f"tables in {tb} memory, {min(sm)}-{max(sm)} B shared, {ps} "
            f"blocks an SM]" for (t, ring, sq, tb, ps), sm in rgeos.items()))
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

    # phases 12-13: the probes and the code-chase kernels' stages
    entries.update(probe_phase(torch, dev, clock_mhz))
    for fam in PROBES:
        launches[fam] = entries[fam].pop("launches")
    stage_phase(torch, dev, timing)

    # phases 14-16: the SGD layout at full size, the split stage's kernels,
    # and the main paths through them
    entries.update(sgd_phase(torch, dev))
    for name in ("sgd", "sgd_plan"):
        launches[name] = entries[name].pop("launches")
    torch.cuda.empty_cache()
    entries.update(split_phase(torch, dev, clock_mhz))
    torch.cuda.empty_cache()
    sgd_main_path(gfa)
    launches.update(split_main_path())
    # the long-row routes: no main path's rows reach them, and drive holds
    # every main path to its own kernels
    launches.update({name: 0 for name in LONG})

    # phases 17-20: --engine jax's batch kernel and main path, sharding
    # over cards and streams, and a two-rank run
    entries["poa_batch"] = batch_phase(torch, dev, clock_mhz)
    torch.cuda.empty_cache()
    launches["poa_batch"] = jax_main_path(gfa, out2, maf2, clock_mhz)
    shard_phase(torch, dev)
    torch.cuda.empty_cache()
    ranks_phase(gfa, out2, maf2)

    # phases 21-22: the batched autocorrelation screen, and the host steal
    entries["autocorr"], launches["autocorr"] = autocorr_phase(
        torch, dev, clock_mhz)
    torch.cuda.empty_cache()
    steal_main_path(gfa, out2, maf2)
    steal_phase(torch, dev)
    torch.cuda.empty_cache()

    # phase 23: every kernel entry under compute-sanitizer and the guard
    # allocator
    sanitize_phase()

    # phase 24: deep blocks through the three whole-block kernels, and the
    # main path at pggb's haplotype depth, at -t 1 and -t 4 in one rank
    deep_phase(torch, dev, clock_mhz)

    loaded = sorted(m for m in sys.modules if m == "jax"
                    or m.startswith(("jax.", "smoothxg_tpu."))
                    or m == "smoothxg_tpu")
    if loaded:
        fail(f"the port loaded jax or the JAX package: {loaded[:5]}")

    replaces = {"poa_win": "smoothxg_tpu/ops/poa_pallas_win.py:64",
                "poa_round": "smoothxg_tpu/ops/poa_pallas.py:54",
                "poa_code": "smoothxg_tpu/ops/poa_pallas_fused.py:86",
                "poa_stacked": "smoothxg_tpu/ops/poa_pallas_stacked.py:79",
                "sgd": "smoothxg_tpu/ops/sgd.py:49",
                "sgd_plan": "smoothxg_tpu/ops/sgd.py:49",
                "minhash_hash": "smoothxg_tpu/ops/minhash_jax.py:107",
                "minhash_inter": "smoothxg_tpu/ops/minhash_jax.py:139",
                "minhash_hash_long": "smoothxg_tpu/ops/minhash_jax.py:107",
                "minhash_inter_long": "smoothxg_tpu/ops/minhash_jax.py:139",
                "ident": "smoothxg_tpu/ops/ident_jax.py:62",
                "poa_batch": "smoothxg_tpu/ops/poa_jax.py:146",
                "autocorr": "smoothxg_tpu/ops/autocorr.py:74"}
    sources = {"minhash_hash": "minhash", "minhash_inter": "minhash",
               "minhash_hash_long": "minhash", "minhash_inter_long": "minhash",
               "sgd_plan": "sgd", "autocorr": "autocorr"}
    kernels = []
    for n in KERNELS:
        if n in PROBE_FAMILIES:
            extra = {"source": "smoothxg_tpu_torch/csrc/probes.cu",
                     "replaces": PROBE_FAMILIES[n][2],
                     "also_replaces": PROBE_FAMILIES[n][3]}
        else:
            extra = {"source": "smoothxg_tpu_torch/csrc/"
                               f"{sources.get(n, n)}.cu",
                     "replaces": replaces[n]}
        kernels.append({"name": n, "route": "cuda", **extra,
                        "launches": launches[n], **entries[n]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
