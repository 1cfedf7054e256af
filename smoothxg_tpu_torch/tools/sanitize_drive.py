"""Launch every kernel entry of the port's CUDA library once, at a small
size, and hold each output to its plain PyTorch version: the harness that
tools/sanitize.py runs on the card under compute-sanitizer's memcheck,
racecheck, synccheck and initcheck, and under the guard allocator of
testing/guard_alloc.cu.

    python -m smoothxg_tpu_torch.tools.sanitize_drive [--guard LIB]
        [--pytest ARGS...]

The entries (ENTRIES): poa_win local, global and banded, on one CTA and
on its cluster route (rows past one tile); poa_code and
poa_stacked with their graph tables in shared and in device memory;
poa_round's ring and tiled routes; poa_batch's ring and tiled routes with
its row tables in shared and in device memory; sgd_plan and the sgd
cluster chain; minhash_hash, minhash_inter and their _long routes; ident's
warp and block kernels; autocorr's four routes with units staged in
shared memory and read from device memory; one kernel of each probe
family; and poa_batch sharded over two streams of the card
(parallel/mesh.py).  On the card each entry also checks from the launch
geometry that it took the routes it names.

With --guard LIB (the built guard allocator) every allocation of the run
goes through it: each entry runs twice, under the poison bytes 0x00 and
0xff (in the allocations and, by a kernel launched just before, in every
SM's shared memory), each time held to the plain version, and the guard
bands of every allocation are checked after each entry.

Prints a line an entry and, last, one JSON object {"entries": [...],
"launches": {...}, "device": ..., "guard": {...} or null}; exits 1 when an
entry disagrees with its plain version, misses a route or launches no
kernel, or a guard band was written.  run(torch.device("cpu")) runs the
plain versions against themselves (a rehearsal of the harness's own code).
`--pytest ARGS...` runs pytest with ARGS in place of the entries (with
--guard: on the guard allocator, poison 0xff, and its bands checked at the
end), and prints the same JSON object without entries.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time

import numpy as np
import torch

SEED = 20261018
POISONS = (0x00, 0xff)


def wrappers() -> dict:
    """Each kernel wrapper of the library, which counts its launches, by
    name."""
    from ..ops.autocorr import autocorr_counts
    from ..ops.ident_cuda import ident_counts
    from ..ops.minhash_cuda import (minhash_hash, minhash_hash_long,
                                    minhash_inter, minhash_inter_long)
    from ..ops.poa_batch import poa_batch
    from ..ops.poa_code import poa_code
    from ..ops.poa_round import poa_round
    from ..ops.poa_stacked import poa_stacked
    from ..ops.poa_win import poa_win
    from ..ops.sgd import sgd_iter, sgd_plan
    from ._probe import WRAPPERS
    return {"poa_win": poa_win, "poa_round": poa_round,
            "poa_code": poa_code, "poa_stacked": poa_stacked, **WRAPPERS,
            "sgd": sgd_iter, "sgd_plan": sgd_plan,
            "minhash_hash": minhash_hash, "minhash_inter": minhash_inter,
            "minhash_hash_long": minhash_hash_long,
            "minhash_inter_long": minhash_inter_long, "ident": ident_counts,
            "poa_batch": poa_batch, "autocorr": autocorr_counts}


class Mismatch(AssertionError):
    pass


def hold(label: str, got, want) -> None:
    """Each output equal to the plain version's (all integers, and sgd.cu
    sums in the plain version's order: exact)."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    for k, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g.cpu(), w.cpu()):
            raise Mismatch(f"{label}: output {k} differs from the plain "
                           "version")


def on(dev, ins):
    return [x.to(dev) for x in ins]


def cover(dev, seen: set, want: set, what: str) -> None:
    """On the card, the launches took every route of `want`."""
    if dev.type == "cuda" and not want <= seen:
        raise Mismatch(f"{what}: routes {sorted(want - seen)} not taken "
                       f"(took {sorted(seen)})")


# ---------------------------------------------------------------------------
# the entries: name -> fn(dev), each holding its outputs to the plain version
# ---------------------------------------------------------------------------

def _win(dev):
    from ..ops.poa_host import POAParams
    from ..ops.poa_win import (WinCaps, geometry, pack_blocks, poa_win,
                               poa_win_reference, row_stride)
    from ..testing.synth import make_block
    rng = np.random.default_rng(SEED)
    seen = set()
    for local, banded in ((True, False), (False, False), (False, True)):
        p = POAParams(1, 4, 6, 2, 26, 1, local=local,
                      wb=40 if banded else -1)
        blocks = [(make_block(rng, 150 + 50 * i, 3, 0.02), p)
                  for i in range(3)]
        VW, LW, W = (2048, 1024, 512) if banded else (1024, 512, 512)
        ins = pack_blocks(blocks, LW)
        caps = WinCaps(VW, LW, W, local, banded)
        hold(f"poa_win local={local} banded={banded}",
             poa_win(*on(dev, ins), caps), poa_win_reference(*ins, caps))
        if dev.type == "cuda":
            seen.add(geometry("poa_win", 3, caps,
                              row_stride(ins[1], LW))["cluster"])
    # rows past one 2,048-column tile: the cluster route (a 2,100-base
    # sequence against a short graph, so few rows), full width and banded
    for local, banded in ((True, False), (False, True)):
        sq = make_block(rng, 2140, 3, 0.02)
        p = POAParams(1, 4, 6, 2, 26, 1, local=local,
                      wb=100 if banded else -1)
        ins = pack_blocks([([sq[0][:100], sq[1][:100], sq[2][:2100]], p)],
                          2304)
        caps = WinCaps(4096, 2304, 2304, local, banded)
        hold(f"poa_win cluster route local={local} banded={banded}",
             poa_win(*on(dev, ins), caps), poa_win_reference(*ins, caps))
        if dev.type == "cuda":
            seen.add(geometry("poa_win", 1, caps,
                              row_stride(ins[1], 2304))["cluster"])
    cover(dev, seen, {1, 2}, "poa_win clusters")


def _chase(name):
    def run(dev):
        from ..ops.poa_code import CodeCaps, poa_code, poa_code_reference
        from ..ops.poa_host import POAParams
        from ..ops.poa_stacked import (poa_stacked, poa_stacked_reference,
                                       stacked_caps)
        from ..ops.poa_win import geometry, pack_blocks, row_stride
        from ..testing.synth import make_block, make_fan_in_block
        kern, ref, mkcaps, held = {
            "poa_code": (poa_code, poa_code_reference, CodeCaps, 8),
            "poa_stacked": (poa_stacked, poa_stacked_reference,
                            stacked_caps, 4)}[name]
        rng = np.random.default_rng(SEED + 1)
        seen = set()
        # VW 1024: the graph tables in shared memory; the (8704, 4096)
        # tier's: in device memory
        for VW, LW, local in ((1024, 512, True), (1024, 512, False),
                              (8704, 4096, False)):
            p = POAParams(1, 4, 6, 2, 26, 1, local=local)
            blocks = [make_block(rng, 120 + 40 * i, 3, 0.03)
                      for i in range(3)] + [make_fan_in_block(rng, held, 30)]
            ins = pack_blocks([(sq, p) for sq in blocks], LW)
            caps = mkcaps(VW, LW, local, False)
            hold(f"{name} VW={VW} local={local}", kern(*on(dev, ins), caps),
                 ref(*ins, caps))
            if dev.type == "cuda":
                seen.add(geometry(name, len(blocks), caps,
                                  row_stride(ins[1], LW))["tables"])
        cover(dev, seen, {"shared", "device"}, f"{name} tables")
    return run


def _round(dev):
    from ..ops.poa_host import POAParams
    from ..ops.poa_round import (geometry, pack_tasks, poa_round,
                                 poa_round_reference)
    from ..testing.synth import make_block, make_fan_in_task, make_round_task
    from ..ops.poa_graph import POAGraph
    rng = np.random.default_rng(SEED + 2)
    seen = set()
    for local in (True, False):
        p = POAParams(local=local)
        tasks = [make_round_task(rng, 150 + 100 * i, 3, 0.03, p)
                 for i in range(3)]
        tasks.append(make_fan_in_task(rng, 12, 100, p))
        # a 2,300-base read over a 60-base seed: rows past 2,048 columns
        read = make_block(rng, 2300, 1, 0.0)[0]
        g = POAGraph()
        g.add_sequence(read[1000:1060], 1)
        for t in (tasks, [(g, read, p)]):
            ins, _ = pack_tasks(t)
            hold(f"poa_round local={local} L={ins[6].shape[1]}",
                 poa_round(*on(dev, ins), local),
                 poa_round_reference(*ins, local))
            if dev.type == "cuda":
                geo = geometry(ins[3].shape[1], ins[6].shape[1],
                               ins[5].shape[2])
                seen.add("ring" if geo["ring"] else "tiled")
    cover(dev, seen, {"ring", "tiled"}, "poa_round rows")


def _batch_tasks(rng):
    """poa_batch's task groups: (local, [tasks]) of small tasks (ring
    rows, tables in shared memory), a query past 2,048 columns (tiled
    rows) and a global query against a chain of 17,000 nodes (its row
    tables, 14 bytes a node at P 4, past a block's 227 KB)."""
    from ..ops.poa_host import POAParams
    from ..testing.synth import make_fan_in_task, make_round_task
    groups = []
    for local in (True, False):
        p = POAParams(local=local)
        groups.append((local, [make_round_task(rng, 150 + 100 * i, 3, 0.03,
                                               p) for i in range(3)]
                       + [make_fan_in_task(rng, 12, 100, p)]))
    p = POAParams(local=True)
    g, q, _ = make_round_task(rng, 200, 2, 0.03, p)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    groups.append((True, [(g, np.concatenate([rng.choice(acgt, 2200), q]),
                           p)]))
    p = POAParams(local=False)
    g, q, _ = make_round_task(rng, 17_000, 2, 0.01, p)
    groups.append((False, [(g, q[2000:2012].copy(), p)]))
    return groups


def _batch(dev):
    from ..ops.poa_batch import (geometry, pack_tasks, poa_batch,
                                 poa_batch_reference)
    rng = np.random.default_rng(SEED + 3)
    seen = set()
    for local, tasks in _batch_tasks(rng):
        ins, _ = pack_tasks(tasks)
        hold(f"poa_batch local={local} V={ins[0].shape[0]} "
             f"L={ins[2].shape[1]}", poa_batch(*on(dev, ins), local),
             poa_batch_reference(*ins, local))
        if dev.type == "cuda":
            geo = geometry(len(tasks), ins[0].shape[0], ins[2].shape[1],
                           ins[1].shape[2])
            seen.update({geo["route"], f"tables {geo['tables']}"})
    cover(dev, seen, {"ring", "tiled", "tables shared", "tables device"},
          "poa_batch")


def _shards(dev):
    """poa_batch with the batch cut over two streams of one card."""
    from ..ops.poa_batch import pack_tasks, poa_batch_reference
    from ..parallel.mesh import sharded_poa_round
    rng = np.random.default_rng(SEED + 4)
    local, tasks = _batch_tasks(rng)[0]
    ins, _ = pack_tasks(tasks)
    hold("poa_batch over two streams",
         sharded_poa_round([dev, dev], *ins, local=local),
         poa_batch_reference(*ins, local))


def _sgd(dev):
    from ..io.gfa import read_gfa
    from ..ops import sgd
    from ..testing.synth import make_pangenome
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "in.gfa")
        with open(path, "w") as f:
            f.write(make_pangenome(haplotypes=4, length=3000, seed=5))
        prob = sgd.sgd_problem(read_gfa(path))
    arr = prob.tensors(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.from_numpy(prob.x0.astype(np.float32)).to(dev)
    eta = float(prob.etas(1)[0])
    ins = (*sgd.sgd_draws(gen, prob.T, prob.B_pad, arr["cdf"],
                          prob.zipf_space),
           arr["node"], arr["pos"], arr["start"], arr["count"], eta)
    plan = sgd.sgd_plan(*ins)
    hold("sgd_plan", plan, sgd.sgd_plan_reference(*ins))
    want = sgd.sgd_reference(x.clone(), *ins)
    hold("sgd chain", sgd.sgd_iter(x.clone(), *ins, plan=plan), want)


def _minhash(dev):
    from ..ops import minhash_cuda as mc
    rng = np.random.default_rng(SEED + 5)
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, 600))
    seqs = [base[i:] + base[:i] for i in range(0, 200, 20)]
    seqs += [mc.SENTINEL_KMER + base, "ACGT" * 30, ""]
    codes, lens = on(dev, [torch.from_numpy(a)
                           for a in mc.encode_batch(seqs)])
    want = mc.sorted_sets(mc.minhash_hash_reference(codes.cpu(), lens.cpu(),
                                                    16))
    for route in (mc.minhash_hash, mc.minhash_hash_long):
        hold(route.__name__, route(codes, lens, 16), want)
    hs, counts = on(dev, want)
    ref = mc.minhash_inter_reference(want[0], want[1],
                                     *mc.triu_pairs(len(seqs)))
    for route in (mc.minhash_inter, mc.minhash_inter_long):
        hold(route.__name__, route(hs, counts), ref)


def _ident(dev):
    from ..ops import ident_cuda as ic
    rng = np.random.default_rng(SEED + 6)
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, 500))
    pairs = [(base[i:] + base[:i], base) for i in range(0, 100, 10)]
    pairs += [(base, base[:200] + base[260:]), ("", base), (base, "")]
    packed = ic.pack_pairs([ic._prep_pair(a, b) for a, b in pairs])
    ins = [packed[n] for n in ("a", "aoff", "la", "b", "boff", "lb")]
    for band in (128, 288):                 # the warp kernel, the block one
        hold(f"ident band={band}", ic.ident_counts(*on(dev, ins), band),
             ic.ident_counts_reference(*ins, band))


def _autocorr(dev):
    from ..ops import autocorr as ac
    from . import time_autocorr as ta
    rng = np.random.default_rng(SEED + 7)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    # an escape every 400 positions: route 2 (escape words below 3 in 10)
    few = acgt[rng.integers(0, 4, 6000)]
    few[100::400] = rng.integers(0, 256, len(few[100::400]))
    seqs = ta.phase21_rows(4) + ta.escape_rows(4) + [few]
    buf, lens, lags = ta.batch(seqs)
    # a lag group whose windows no staging buffer holds (lags 1 and
    # 20,001 of a byte-route row): its units read device memory
    lags = np.concatenate([lags[:40], [1, 20001, 3]]).astype(np.int32)
    ins = [torch.from_numpy(x) for x in (buf, lens, lags)]
    stats = {}
    got = ac.autocorr_counts(*on(dev, ins),
                             stats=stats if dev.type == "cuda" else None)
    hold("autocorr", got, ac.autocorr_counts_reference(*ins))
    if dev.type == "cuda":
        seen = {r for r in ac.ROUTES if stats["routes"][r] > 0}
        if 0 < stats["device_units"]:
            seen.add("device units")
        if stats["device_units"] < stats["units"]:
            seen.add("staged units")
        cover(dev, seen, {*ac.ROUTES, "device units", "staged units"},
              "autocorr")


def _probes(dev):
    from . import _probe
    for case in (_probe.Case("chase", "scalar", "chase"),
                 _probe.Case("mread", "row", "mread"),
                 _probe.Case("fillrow", "tile", "fillrow"),
                 _probe.Case("K=4", "step", 4)):
        want = case.reference(500)
        for var in case.variants:
            hold(f"probe_{case.family} {case.label(var)}",
                 case.call(var, 500, case.inputs(dev), dev), want)


# name, the wrappers it must launch, fn
ENTRIES = [
    ("poa_win: local, global, banded, one CTA and clusters", ("poa_win",),
     _win),
    ("poa_code: tables in shared and in device memory", ("poa_code",),
     _chase("poa_code")),
    ("poa_stacked: tables in shared and in device memory", ("poa_stacked",),
     _chase("poa_stacked")),
    ("poa_round: ring and tiled rows", ("poa_round",), _round),
    ("poa_batch: ring and tiled rows, tables in shared and device memory",
     ("poa_batch",), _batch),
    ("sgd_plan and the sgd cluster chain", ("sgd_plan", "sgd"), _sgd),
    ("minhash_hash, minhash_inter and their long routes",
     ("minhash_hash", "minhash_hash_long", "minhash_inter",
      "minhash_inter_long"), _minhash),
    ("ident: warp and block kernels", ("ident",), _ident),
    ("autocorr: four routes, units staged and from device memory",
     ("autocorr",), _autocorr),
    ("probes: a kernel of each family",
     ("probe_scalar", "probe_row", "probe_tile", "probe_step"), _probes),
    ("poa_batch sharded over two streams (parallel/mesh.py)",
     ("poa_batch",), _shards),
]


class Guard:
    """The guard allocator (testing/guard_alloc.cu), installed as
    PyTorch's CUDA allocator before the first allocation."""

    def __init__(self, path: str):
        self.lib = ctypes.CDLL(path)
        self.lib.guard_check.restype = ctypes.c_longlong
        self.lib.guard_allocations.restype = ctypes.c_longlong
        self.lib.guard_first.restype = ctypes.c_char_p
        torch.cuda.memory.change_current_allocator(
            torch.cuda.memory.CUDAPluggableAllocator(path, "guard_malloc",
                                                     "guard_free"))

    def poison(self, byte: int) -> None:
        self.lib.guard_set_poison(byte)
        rc = self.lib.guard_poison_smem(byte)
        if rc != 0:
            raise RuntimeError(f"guard_poison_smem: CUDA error {rc}")

    def check(self) -> int:
        return int(self.lib.guard_check())

    def stats(self) -> dict:
        return {"violations": self.check(),
                "allocations": int(self.lib.guard_allocations()),
                "first": self.lib.guard_first().decode()}


def run(dev, guard: Guard | None = None, echo=print) -> dict:
    """Every entry (under each poison with a guard); returns the result
    object the harness prints."""
    ws = wrappers()
    results, ok = [], True
    for w in ws.values():
        w.launches = 0
    for name, kernels, fn in ENTRIES:
        before = {k: ws[k].launches for k in kernels}
        t0 = time.perf_counter()
        err = None
        for byte in (POISONS if guard else (None,)):
            try:
                if guard:
                    guard.poison(byte)
                fn(dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                if guard and guard.check():
                    raise Mismatch(f"guard band written: {guard.stats()}")
            except Exception as e:          # noqa: BLE001 - reported below
                err = (f"{type(e).__name__}: {e}" +
                       (f" (poison 0x{byte:02x})" if guard else ""))
                break
        launched = {k: ws[k].launches - before[k] for k in kernels}
        if err is None and dev.type == "cuda":
            idle = [k for k, v in launched.items() if v <= 0]
            if idle:
                err = f"launched no {', '.join(idle)} kernel"
        ok &= err is None
        results.append({"entry": name, "kernels": launched,
                        "seconds": round(time.perf_counter() - t0, 3),
                        "ok": err is None, **({"error": err} if err else {})})
        echo(f"[sanitize_drive] {'ok  ' if err is None else 'FAIL'} {name}: "
             f"launches {launched}, {results[-1]['seconds']:.2f} s"
             + (f": {err}" if err else ""), flush=True)
    return {"ok": ok, "device": str(dev), "entries": results,
            "launches": {k: w.launches for k, w in ws.items()},
            "guard": guard.stats() if guard else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--guard", metavar="LIB",
                    help="the built guard allocator (testing/guard_alloc.cu)")
    ap.add_argument("--pytest", nargs=argparse.REMAINDER,
                    help="run pytest with these arguments instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[sanitize_drive] CUDA required", file=sys.stderr)
        return 1
    guard = Guard(args.guard) if args.guard else None
    if args.pytest is not None:
        import pytest
        if guard:
            guard.poison(POISONS[-1])
        rc = int(pytest.main(args.pytest))
        stats = guard.stats() if guard else None
        ok = rc == 0 and not (stats and stats["violations"])
        print(json.dumps({"ok": ok, "device": "cuda", "entries": [],
                          "launches": {k: w.launches
                                       for k, w in wrappers().items()},
                          "guard": stats}), flush=True)
        return 0 if ok else 1
    res = run(torch.device("cuda", 0), guard)
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
