"""Time the POA kernels (csrc/poa_win.cu, poa_round.cu, poa_code.cu,
poa_stacked.cu) of the checkout it runs in, on the chip smoke's timing
shapes, so that two versions of them can be compared in turns on one card
(run it from the root of each checkout in one call: old, new, new, old).

Cases, each the fastest of `reps` launches after a warm one (CUDA events):
  whole-block kernels (poa_win, poa_code, poa_stacked):
    block  the chip smoke's phase-3 timing block (16 x ~1 kb, local, V
           1,207) at caps (4352, 2048), one launch
    132    132 copies of it in one launch (one per SM)
    1056   1,056 copies at caps (1280, 1024) (8 per SM)
    R16, R64, R96
           one block of the first 16, 64 and 96 sequences of the deep
           timing block (`deep_block`: 96 x ~1 kb from 8 founders, the
           shape of a block at pggb's -r 90; V 1,107 / 1,268 / 1,369,
           in-degree at most 4) at caps (4352, 2048), one launch each
    T3072  one block of 16 sequences of ~2.5 kb at caps (6144, 3072), the
           tier whose graph tables leave shared memory at poa_win's 8
           predecessor slots
  long blocks (--long; poa_win, poa_stacked, and `native`, the native C++
  engine's wall on the same block, for blocks the parent tree ran there):
    L4000  the block of the most DP cells of the CLI's default -l 4000 at
           --long-poa-band 0 on the chip smoke's 16 x 80 kb pangenome
           (`default_blocks`: 16 x ~4.6 kb, local, full width) at its tier
           (8704, 8704)
    L4000b the default band's banded block whose window passes the
           windowed tier's 3,072 columns (15 sequences of 1,100-4,546
           bases, global, banded) at the same full-width tier
    T3072  the wide block (above) at (6144, 3072), so that the three cases
           of poa_win's cluster route run in one call beside native
  (each long case's line gives poa_win's route: its cluster size, 1 for
  the one-CTA kernel, and where its row metadata sits)
  round kernel (poa_round):
    task   the chip smoke's phase-6 timing task (a ~1 kb local query
           against a graph of seven ~1 kb sequences, V ~ 1,220)
    132    132 copies of it in one launch
    264    264 copies
Each case's outputs are digested (sha256 of the wrapper's outputs), so that
two checkouts can be seen to compute the same bytes.  Prints one line per
case and a JSON line.  Needs CUDA.

Usage: python -m smoothxg_tpu_torch.tools.time_chase [reps] [--pcap=N]
[--long] [kernel ...] (kernels: poa_win poa_round poa_code poa_stacked;
default all four; --pcap: poa_win's predecessor slots, default
ops/poa_win.PCAP, so that 4, the TPU's, can be timed against it in turns;
--long: only the long-block cases, of poa_win, poa_stacked and native by
default; `native` needs no tier of the card's table, so this copy of the
tool times an older tree's native engine from that tree's root)
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np

SEED = 20261016
# the chip smoke's phase-3 plan (chip_smoke.py:kernel_phase): (tier,
# local, banded, blocks, (min L, max L), seqs per block, div); the timing
# block is the next draw of the same generator
PHASE3_PLAN = ((0, True, False, 70, (150, 500), (3, 7), 0.02),
               (0, False, False, 70, (150, 500), (3, 7), 0.02),
               (1, True, False, 20, (300, 900), (3, 6), 0.03),
               (1, False, False, 10, (300, 900), (3, 6), 0.03),
               (2, True, False, 10, (1800, 2600), (3, 4), 0.01),
               (2, False, False, 6, (1800, 2600), (3, 4), 0.01),
               (3, True, False, 6, (3000, 3800), (2, 3), 0.01),
               (3, False, False, 4, (3000, 3800), (2, 3), 0.01),
               (4, False, True, 4, (3600, 4400), (5, 5), 0.01))
# the chip smoke's phase-6 plan (chip_smoke.py:round_phase), drawn from
# SEED + 1: (local, tasks, (min L, max L), sequences in the graph + 1,
# div); then a fan-in task of each in-degree 2-15, local and global, and
# the two tasks past the Pallas kernel's code packing; the timing task is
# the next draw
ROUND_PLAN = ((True, 60, (150, 600), (3, 8), 0.03),
              (False, 60, (150, 600), (3, 8), 0.03),
              (True, 30, (600, 1200), (4, 12), 0.05),
              (False, 30, (600, 1200), (4, 12), 0.05),
              (True, 6, (1800, 2000), (10, 12), 0.12),
              (False, 6, (1800, 2000), (10, 12), 0.12))
CAPS = (4352, 2048)
WIDE_CAPS = (6144, 3072)
DEEP = (16, 64, 96)        # sequences of the deep timing block's cases
FULL_CAPS = (1280, 1024)
COPIES = (132, 1056)
ROUND_COPIES = (132, 264)
KERNELS = ("poa_win", "poa_round", "poa_code", "poa_stacked")
# the long-block cases: the CLI's default -l 4000 on the chip smoke's
# 16 x 80 kb pangenome, the tier its long blocks take, the kernels timed
LONG_FLAGS = ["-r", "16", "-j", "5k", "-e", "5k", "-l", "4000", "-t", "1"]
LONG_CAPS = (8704, 8704)
LONG_KERNELS = ("poa_win", "poa_stacked", "native")


def phase3_blocks(rng) -> list:
    """The chip smoke's phase-3 blocks, by tier group, from `rng`."""
    from ..testing.synth import make_block
    return [[make_block(rng, int(rng.integers(lo, hi)),
                        int(rng.integers(smin, smax + 1)), div)
             for _ in range(nb)]
            for _, _, _, nb, (lo, hi), (smin, smax), div in PHASE3_PLAN]


def timing_block() -> list:
    """The chip smoke's timing block: 16 sequences of ~1 kb."""
    from ..testing.synth import make_block
    rng = np.random.default_rng(SEED)
    phase3_blocks(rng)
    return make_block(rng, 1000, 16, 0.01)


def deep_block() -> list:
    """The deep timing block: 96 sequences of ~1 kb, copies of 8 founders
    with private SNVs (testing/synth.make_population_block)."""
    from ..testing.synth import make_population_block
    return make_population_block(np.random.default_rng(SEED + 24), 1000,
                                 max(DEEP), 0.01)


def round_groups(rng) -> list:
    """The chip smoke's phase-6 task groups, [(local, [(graph, query,
    params), ...]), ...], from `rng`: the seeded plan, the fan-in tasks
    (in-degree 2-15), a local query longer than 2^15 (read from device
    memory by the kernel) and a global query against a chain of more than
    2^16 nodes."""
    from ..ops import poa_host
    from ..testing.synth import make_fan_in_task, make_round_task
    groups = []
    for local, nt, (lo, hi), (smin, smax), div in ROUND_PLAN:
        p = poa_host.POAParams(local=local)
        groups.append((local, [make_round_task(
            rng, int(rng.integers(lo, hi)), int(rng.integers(smin, smax + 1)),
            div, p) for _ in range(nt)]))
    for local in (True, False):
        p = poa_host.POAParams(local=local)
        groups.append((local, [make_fan_in_task(rng, w, 200, p)
                               for w in range(2, 16)]))
    p = poa_host.POAParams(local=True)
    g, q, _ = make_round_task(rng, 200, 2, 0.03, p)
    groups.append((True, [(g, np.concatenate(
        [rng.choice(np.frombuffer(b"ACGT", np.uint8), 1 << 15), q]), p)]))
    p = poa_host.POAParams(local=False)
    g, q, _ = make_round_task(rng, 66_000, 2, 0.01, p)
    groups.append((False, [(g, q[30_000:30_060].copy(), p)]))
    return groups


def round_timing_task(rng=None) -> tuple:
    """The chip smoke's round timing task, the draw after round_groups
    (from `rng` when the caller has just drawn the groups from it)."""
    from ..ops import poa_host
    from ..testing.synth import make_round_task
    if rng is None:
        rng = np.random.default_rng(SEED + 1)
        round_groups(rng)
    return make_round_task(rng, 1000, 8, 0.03,
                           poa_host.POAParams(local=True))


def digest(out) -> str:
    h = hashlib.sha256()
    for x in out:
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def copies(ins, n: int, dev) -> list:
    """n copies of a one-block (or one-task) batch, on `dev`."""
    return [x.repeat((n,) + (1,) * (x.dim() - 1)).contiguous().to(dev)
            for x in ins]


def wide_block() -> list:
    """The T3072 case's block: 16 sequences of ~2.5 kb."""
    from ..testing.synth import make_block
    return make_block(np.random.default_rng(SEED + 3), 2500, 16, 0.01)


def block_kernel(label: str, pcap: int | None = None):
    """(wrapper, caps of (VW, LW[, local, banded])) of a whole-block
    kernel at a full-width tier, local and unbanded by default; poa_win at
    `pcap` predecessor slots (default its PCAP)."""
    from ..ops.poa_code import CodeCaps, poa_code
    from ..ops.poa_stacked import poa_stacked, stacked_caps
    from ..ops.poa_win import PCAP, WinCaps, poa_win
    return {
        "poa_win": (poa_win, lambda VW, LW, local=True, banded=False:
                    WinCaps(VW, LW, LW, local, banded, pcap=pcap or PCAP)),
        "poa_code": (poa_code, lambda VW, LW, local=True, banded=False:
                     CodeCaps(VW, LW, local, banded)),
        "poa_stacked": (poa_stacked, lambda VW, LW, local=True,
                        banded=False: stacked_caps(VW, LW, local, banded)),
    }[label]


class _Captured(Exception):
    """Raised by `_Capture` once it holds a run's blocks."""


class _Capture:
    """An engine that keeps the first POA call's blocks and stops the
    run there (the smoothing run's load, prep and block finding are all
    `default_blocks` needs)."""

    def __init__(self):
        self.blocks: list = []

    def poa_block_batch(self, blocks):
        self.blocks = list(blocks)
        raise _Captured


def default_blocks(band: str) -> list:
    """The POA blocks, (sequences, weights, POAParams), of the CLI's
    default -l 4000 (LONG_FLAGS) at --long-poa-band `band` on the chip
    smoke's 16 x 80 kb pangenome (seed SEED), as the engine receives
    them."""
    import tempfile

    from .. import cli
    from ..pipeline.run import run_smoothing
    from ..testing.synth import write_pangenome
    cap = _Capture()
    with tempfile.TemporaryDirectory() as d:
        gfa = write_pangenome(os.path.join(d, "pangenome.gfa"),
                              haplotypes=16, length=80_000, seed=SEED)
        args = cli.build_parser().parse_args(
            ["-g", gfa, "-o", os.path.join(d, "out.gfa"), *LONG_FLAGS,
             "--long-poa-band", band, "--engine", "native"])
        try:
            run_smoothing(cli.config_from_args(
                args, add_consensus=not args.vanish_consensus),
                device="cpu", engine=cap)
        except _Captured:
            pass
    return cap.blocks


def long_blocks() -> dict:
    """The long-block cases' blocks, by case, chosen by their shape (not by
    the tier table, so an older tree picks the same): of --long-poa-band
    0's full-width blocks past 4,095 bp, the one of the most DP cells; of
    the default band's banded blocks, the first whose window (the abPOA
    band, 2 (wb + wf L) + spread + 1) passes 3,072 columns."""
    def window(sq, p):
        lens = [len(s) for s in sq]
        bw = p.wb + (p.wf_milli * max(lens)) // 1000
        return 2 * bw + max(lens) - min(lens) + 1

    full = [b for b in default_blocks("0")
            if b[2].wb < 0 and max(map(len, b[0])) > 4095]
    banded = [b for b in default_blocks("4k")
              if b[2].wb >= 0 and window(b[0], b[2]) > 3072]
    if not full or not banded:
        raise SystemExit(f"time_chase: no long block (full width "
                         f"{len(full)}, banded {len(banded)})")
    return {"L4000": max(full, key=lambda b: sum(
                len(b[0][0]) * len(s) for s in b[0][1:])),
            "L4000b": banded[0]}


def long_cases(label: str, dev, reps: int, blocks: dict) -> dict:
    """A whole-block kernel, or the native engine (`native`, host wall,
    the fastest of `reps` calls), on each long block at its caps
    (LONG_CAPS, T3072's WIDE_CAPS)."""
    row = {}
    for case, (sq, w, p) in blocks.items():
        caps = WIDE_CAPS if case == "T3072" else LONG_CAPS
        route = ""
        if label == "native":
            from ..ops.poa_native import NativePOAEngine
            eng = NativePOAEngine()
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                g = eng.poa_block_batch([(sq, w, p)])[0]
                times.append((time.perf_counter() - t0) * 1e3)
            h = hashlib.sha256(repr((g.base, g.seq_paths)).encode())
            row[case] = {"ms": min(times), "digest": h.hexdigest()[:16],
                         "V": len(g.base)}
        else:
            import torch
            from ..ops.poa_win import pack_blocks
            from ._probe import measure
            kern, mkcaps = block_kernel(label)
            cpu = pack_blocks([(sq, p)], caps[1])
            ins = [x.to(dev) for x in cpu]
            c = mkcaps(*caps, p.local, p.wb >= 0)
            out = kern(*ins, c)
            if int(out[0][0, 1]):
                raise SystemExit(f"{label} {case}: the block overflows "
                                 f"{caps}")
            if label == "poa_win":
                from ..ops.poa_win import geometry, row_stride
                g = geometry(label, 1, c, row_stride(cpu[1], caps[1]))
                route = (f", cluster {g['cluster']}, row metadata in "
                         f"{g['meta']} memory")
            row[case] = {"ms": measure(lambda: kern(*ins, c), reps),
                         "digest": digest(out), "V": int(out[0][0, 0])}
            del ins, out
            torch.cuda.empty_cache()
        where = ("one core" if label == "native"
                 else f"V{caps[0]}xL{caps[1]}{route}")
        print(f"{label} {case} ({len(sq)} sequences of {min(map(len, sq))}"
              f"-{max(map(len, sq))}, {'local' if p.local else 'global'}"
              f"{', banded' if p.wb >= 0 else ''}, V {row[case]['V']} on "
              f"{where}): {row[case]['ms']:.3f} ms, outputs "
              f"{row[case]['digest']}", flush=True)
    return row


def block_cases(label: str, dev, reps: int, pcap: int | None = None) -> dict:
    """A whole-block kernel on the timing block, 132 and 1,056 copies, on
    the deep timing block at the depths DEEP, and on the wide block."""
    import torch
    from ..ops.poa_host import POAParams
    from ..ops.poa_win import pack_blocks
    from ._probe import measure
    kern, mkcaps = block_kernel(label, pcap)
    blk, deep = timing_block(), deep_block()
    p = POAParams(local=True)
    row = {}
    for case, sq, caps, n in (
            ("block", blk, CAPS, 1), ("132", blk, CAPS, COPIES[0]),
            ("1056", blk, FULL_CAPS, COPIES[1]),
            *((f"R{r}", deep[:r], CAPS, 1) for r in DEEP),
            ("T3072", wide_block(), WIDE_CAPS, 1)):
        ins = copies(pack_blocks([(sq, p)], caps[1]), n, dev)
        c = mkcaps(*caps)
        out = kern(*ins, c)
        if int(out[0][:, 1].sum()):
            raise SystemExit(f"{label} {case}: the timing block overflows "
                             f"{caps}")
        ms = measure(lambda: kern(*ins, c), reps)
        row[case] = {"ms": ms, "digest": digest(out), "V": int(out[0][0, 0])}
        print(f"{label} {case} ({n} x {len(sq)} sequences, V"
              f"{row[case]['V']} at V{caps[0]}xL{caps[1]}): {ms:.3f} ms, "
              f"outputs {row[case]['digest']}", flush=True)
        del ins, out
        torch.cuda.empty_cache()
    return row


def round_cases(dev, reps: int) -> dict:
    """poa_round on the timing task, 132 and 264 copies."""
    import torch
    from ..ops.poa_round import pack_tasks, poa_round
    from ._probe import measure
    task = round_timing_task()
    one, _ = pack_tasks([task])
    row = {}
    for case, n in (("task", 1), ("132", ROUND_COPIES[0]),
                    ("264", ROUND_COPIES[1])):
        ins = copies(one, n, dev)
        out = poa_round(*ins, True)
        if int(out[1][:, 2].abs().sum()):
            raise SystemExit(f"poa_round {case}: the timing task is flagged")
        ms = measure(lambda: poa_round(*ins, True), reps)
        row[case] = {"ms": ms, "digest": digest(out),
                     "V": task[0].n_nodes(), "L": len(task[1])}
        print(f"poa_round {case} ({n} x V{task[0].n_nodes()} x "
              f"L{len(task[1])}): {ms:.3f} ms, outputs {row[case]['digest']}",
              flush=True)
        del ins, out
        torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    reps = int(argv.pop(0)) if argv and argv[0].isdigit() else 3
    pcap = None
    if argv and argv[0].startswith("--pcap="):
        pcap = int(argv.pop(0).split("=", 1)[1])
    long = bool(argv) and argv[0] == "--long"
    if long:
        argv.pop(0)
    known = LONG_KERNELS if long else KERNELS
    names = argv or list(known)
    bad = [n for n in names if n not in known]
    if bad:
        print(f"time_chase: unknown kernels {bad} (one of {known})",
              file=sys.stderr)
        return 1
    from ..device import resolve
    from ._probe import card
    try:
        dev = resolve("cuda")
    except RuntimeError as e:
        print(f"time_chase: {e}", file=sys.stderr)
        return 1
    name, smi, mhz = card()
    if long:
        from ..ops.poa_host import POAParams
        blocks = long_blocks()
        blocks["T3072"] = (wide_block(), [1] * 16, POAParams(local=True))
        res = {n: long_cases(n, dev, reps, blocks) for n in names}
    else:
        res = {n: round_cases(dev, reps) if n == "poa_round"
               else block_cases(n, dev, reps, pcap) for n in names}
    print(json.dumps({"tool": "time_chase", "device": {
        "kind": name, "smi": smi, "max_sm_mhz": mhz}, "reps": reps,
        "pcap": pcap, **res}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
