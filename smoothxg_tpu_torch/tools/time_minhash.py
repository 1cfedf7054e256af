"""Time the split stage's MinHash kernels (csrc/minhash.cu through
ops/minhash_cuda.py) at two shapes:

* a deep block, 512 seeded reads of a ~1.4 kb base (5% substitutions and
  1-3 bp indels), the smoke's timing block: the hash step (hash, sort and
  dedup) by both routes, `minhash_hash` (shared memory) and
  `minhash_hash_long` (device memory), and the intersections of its
  130,816 pairs by both routes, `minhash_inter` (tiles) and
  `minhash_inter_long` (a block a pair);
* the pipeline's shape, a seeded batch of 7 reads of ~650 bp (a split
  block cut at -l 700): each step by CUDA events, and the host-to-host
  wall of one `DeviceMinHash.distance_matrix` call (one copy in, the two
  launches, one copy back, the distances).

Each step's time is the mean by CUDA events over `reps` calls after a
warm one (at small shapes that is the host's cost of a call, which the
card waits for), and its device time the kernels' busy time a call by
torch.profiler over as many calls; each is printed beside its bound (the
function's bytes at 3.35 TB/s or its int32 operations at 132 SMs x 128
lanes x the max SM clock, whichever is larger) and a sha256 of its
outputs, then a JSON line.
Needs CUDA.  The same script from two checkouts, in turns, compares two
versions of the kernels on one card: the digests must agree (`steps`
names the calls a tree makes).

Usage: python -m smoothxg_tpu_torch.tools.time_minhash [--reps=R]
[--calls=N]
"""
from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 15
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
INT32_LANES = 132 * 128       # SMs x int32 lanes an SM (tools/_probe)
# int32 operations a position of a rolling canonical k-mer and its hash:
# the forward pack (shift, or, mask: 3), the reverse complement (xor, two
# shifts, or: 4), the run of valid bases and the row's end (3), the
# canonical minimum and the valid test (2), fmix32 (three shift-xors, two
# multiplies: 8), the sentinel's select (1)
OPS_HASH_POS = 21
# int32 operations a hash of both rows in a pair's merge (two compares,
# the count's add, the index's advance)
OPS_MERGE_HASH = 4


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


def reads(n: int, length: int, rate: float = 0.05, seed: int = SEED):
    """n seeded reads of one base of `length` bp, each mutated at `rate`."""
    rng = np.random.default_rng(seed)
    base = _seq(rng, length)
    return [_mutate(rng, base, rate) for _ in range(n)]


def long_block(rng) -> list[str]:
    """Rows of 50 kb (past the hash kernel's shared memory at k 16), a 1%
    mutated copy, a 20 kb prefix, 17 bp and a 2% mutated 20 kb stretch:
    each past a tile of the intersection kernel."""
    big = _seq(rng, 50_000)
    return [big, _mutate(rng, big, 0.01), big[:20_000], "ACGTACGTACGTACGTA",
            _mutate(rng, big[5_000:25_000], 0.02)]


def _bound(nbytes: float, ops: float, clock_mhz: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (INT32_LANES * clock_mhz * 1e6) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bounds(B: int, L: int, counts: np.ndarray, clock_mhz: float) -> tuple:
    """((ms, "bytes" or "operations") of the hash step, the same of the
    intersections) of a (B, L) batch whose rows hold `counts` uniques.
    Hash: the codes read (1 B a position) and the lengths, the key rows
    written (4 B a position) and the counts; 21 operations a position.
    Intersections: the key rows and counts read once, 4 B a pair written;
    4 operations a hash of both rows of each pair."""
    c = np.asarray(counts, dtype=np.int64)
    pairs = B * (B - 1) // 2
    merged = int(c.sum()) * (B - 1)     # each row's hashes in its B-1 pairs
    return (_bound(B * L * 5 + B * 8, B * L * OPS_HASH_POS, clock_mhz),
            _bound(B * L * 4 + B * 4 + pairs * 4, merged * OPS_MERGE_HASH,
                   clock_mhz))


def steps(mc):
    """This tree's calls: (hash step, its long route, intersections, their
    long route), each taking the device tensors and returning the outputs
    whose digest is compared."""
    return (mc.minhash_hash, mc.minhash_hash_long,
            lambda hs, counts: mc.minhash_inter(hs, counts),
            lambda hs, counts: mc.minhash_inter_long(hs, counts))


def registers(log: str) -> dict:
    """{minhash kernel entry: ptxas 'Used N registers, ...'} of a build's
    ptxas -v log."""
    out, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln and "minhash" in ln else None
        elif entry and "registers" in ln:
            out[entry] = ln.split(":", 1)[-1].strip()
            entry = None
    return out


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    for _ in range(reps):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps


def device_ms(torch, fn, reps: int):
    """The device's busy time a call of fn() (its kernels and copies, by
    torch.profiler over `reps` calls after a warm one); None where the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
             for e in prof.key_averages())
    return us / reps / 1e3 if us else None


def time_shape(torch, mc, dev, seqs, clock_mhz: float, reps: int,
               k: int = 16) -> dict:
    """Each step's ms by CUDA events, its bound and its outputs' sha256 on
    the batch of `seqs`."""
    hash_step, hash_long, inter, inter_long = steps(mc)
    codes, lens = (torch.from_numpy(a).to(dev) for a in
                   mc.encode_batch(seqs))
    B, L = codes.shape
    hs, counts = hash_step(codes, lens, k)
    (hb, hby), (ib, iby) = bounds(B, L, counts.cpu().numpy(), clock_mhz)
    out = {"rows": B, "width": L, "pairs": B * (B - 1) // 2}
    for name, fn, got, bound, by in (
            ("hash", lambda: hash_step(codes, lens, k),
             hash_step(codes, lens, k), hb, hby),
            ("hash_long", lambda: hash_long(codes, lens, k),
             hash_long(codes, lens, k), hb, hby),
            ("inter", lambda: inter(hs, counts), (inter(hs, counts),), ib,
             iby),
            ("inter_long", lambda: inter_long(hs, counts),
             (inter_long(hs, counts),), ib, iby)):
        r = reps if name != "inter_long" or B < 64 else 1
        out[name] = {"ms": cuda_ms(torch, fn, r),
                     "device_ms": device_ms(torch, fn, r), "bound_ms": bound,
                     "bound_by": by, "sha256": digest(*got)}
    return out


def time_calls(torch, mc, dev, seqs, calls: int, k: int = 16) -> dict:
    """Host-to-host wall of `calls` DeviceMinHash.distance_matrix calls on
    `seqs` (after a warm one): mean, median and spread, and the matrix's
    sha256."""
    dm = mc.DeviceMinHash(k, device=dev)
    d = dm.distance_matrix(seqs)
    walls = []
    for _ in range(calls):
        t0 = time.perf_counter()
        dm.distance_matrix(seqs)
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"calls": calls, "mean_ms": statistics.fmean(walls),
            "median_ms": statistics.median(walls), "min_ms": min(walls),
            "max_ms": max(walls),
            "sha256": hashlib.sha256(d.tobytes()).hexdigest()}


def main(argv: list[str]) -> int:
    import torch

    from ..device import resolve
    from ..ops import _build
    from ..ops import minhash_cuda as mc
    opts = dict(a[2:].split("=", 1) for a in argv if a.startswith("--"))
    reps, calls = int(opts.get("reps", 5)), int(opts.get("calls", 200))
    dev = resolve("cuda", what="time_minhash times the MinHash kernels",
                  instead="it has no CPU mode")
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    clock_mhz = float(clk.stdout.split()[0])
    _build.load()
    out = {"device": torch.cuda.get_device_name(0), "clock_mhz": clock_mhz,
           "registers": registers(_build.build_log["ptxas"])}
    for entry, used in out["registers"].items():
        print(f"{entry}: {used}", flush=True)
    for tag, seqs in (("deep", reads(512, 1400)),
                      ("pipeline", reads(7, 650, seed=SEED + 1))):
        res = time_shape(torch, mc, dev, seqs, clock_mhz, reps)
        out[tag] = res
        for name in ("hash", "hash_long", "inter", "inter_long"):
            r = res[name]
            dms = ("not measured" if r["device_ms"] is None
                   else f"{r['device_ms']:.4f} ms")
            print(f"{tag} ({res['rows']} x {res['width']}, {res['pairs']} "
                  f"pairs) {name}: {r['ms']:.4f} ms a call, device busy "
                  f"{dms}, bound "
                  f"{r['bound_ms']:.4f} ms by {r['bound_by']}, outputs "
                  f"sha256 {r['sha256'][:16]}", flush=True)
    out["calls"] = time_calls(torch, mc, dev, reads(7, 650, seed=SEED + 1),
                              calls)
    c = out["calls"]
    print(f"distance_matrix at 7 x ~650 bp: {c['mean_ms']:.4f} ms a call "
          f"(median {c['median_ms']:.4f}, {c['min_ms']:.4f}-"
          f"{c['max_ms']:.4f}, {calls} calls, host to host), matrix "
          f"sha256 {c['sha256'][:16]}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
