"""Time the batched autocorrelation screen's kernels (csrc/autocorr.cu
through ops/autocorr.autocorr_counts) at the CLI's lag grid (-c 1000 -C
20000, every 50) on seeded batches:

* `phase21_rows`: chip_smoke.py phase 21's 128 rows of 2-40 kb, by fours
  two tandem repeats of a 1-8 kb period with 1% point mutations, a random
  row and a random row with runs of N;
* `escape_rows`: 32 rows of 2-40 kb heavy in escapes (bytes other than
  A/C/G/T), by fours all lower case, all N, random bytes, and upper case
  with lower-case runs over a third of the row;
* `route_rows`: random A/C/G/T rows of phase 21's lengths, as they are
  (route 0), with an N for the last base (route 1), with IUPAC codes or
  lower-case runs on 1 in d positions for each d of --shares (route 2
  where at most 3 in 10 of a row's 32-position words hold an escape,
  else route 3), and all lower case (route 3).  A batch's work is the
  same on every route and only route 2's depends on the bytes, so the
  times compare the routes.

Each batch's call time is the mean by CUDA events over `reps` calls after
a warm one, its host time the mean a call of as many calls issued without
waiting for the card, and its device time the kernels' busy time a call by
torch.profiler over as many calls; each is printed beside three bounds at
the card's max SM clock: the operations of one 4-byte word compare for
every 4 positions of each (row, lag) window (the first design's), of one
lane operation for every 16 positions (this design's density: two planes
of 32 positions, two operations a word), and the rows read once and the
counts written once at 3.35 TB/s.  Then the counts' sha256, the plan the
kernels made where the tree's wrapper reports it (its rows a route), and
a JSON line.  The first call of each batch is held to the plain version
(`autocorr_counts_reference`, tolerance 0).

Needs CUDA.  The same script from two checkouts, in turns (old, new, new,
old), compares two versions of the kernel on one card: the digests must
agree.

Usage: python -m smoothxg_tpu_torch.tools.time_autocorr [--reps=R]
       [--shares=D,D,...]
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

import numpy as np

SEED = 20261016 + 21            # chip_smoke.py's SEED, phase 21
LAGS = (1000, 20000, 50)        # the CLI's -c, -C and the lag stride
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (data sheet)
INT32_LANES = 132 * 128         # SMs x int32 lanes an SM
SHARES = (50, 20)               # route_rows' escapes: 1 in d positions
IUPAC = b"RYKMSWBDHV"


def phase21_rows(n: int = 128, seed: int = SEED) -> list:
    """Phase 21's rows of 2-40 kb, by fours: two tandem repeats of a 1-8 kb
    period with 1% point mutations, a random row and a random row with
    runs of N."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    rows = []
    for i in range(n):
        L = int(rng.integers(2000, 40001))
        if i % 4 < 2:
            period = int(rng.choice([1000, 1500, 2050, 3000, 5000, 8000]))
            s = np.resize(acgt[rng.integers(0, 4, period)], L)
            pos = rng.integers(0, L, L // 100)
            s[pos] = acgt[rng.integers(0, 4, len(pos))]
        else:
            s = acgt[rng.integers(0, 4, L)]
            if i % 4 == 3:
                for _ in range(3):
                    a = int(rng.integers(0, L))
                    s[a:a + int(rng.integers(100, 2000))] = ord("N")
        rows.append(s)
    return rows


def escape_rows(n: int = 32, seed: int = SEED + 1) -> list:
    """Rows of 2-40 kb heavy in escapes, by fours: lower-case acgt, all N,
    random bytes, and upper case with lower-case runs of 200-2,000 over a
    third of the row (soft-masked repeats)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    rows = []
    for i in range(n):
        L = int(rng.integers(2000, 40001))
        if i % 4 == 0:
            s = acgt[rng.integers(0, 4, L)] | 0x20
        elif i % 4 == 1:
            s = np.full(L, ord("N"), np.uint8)
        elif i % 4 == 2:
            s = rng.integers(0, 256, L).astype(np.uint8)
        else:
            s = acgt[rng.integers(0, 4, L)]
            while int((s > ord("Z")).sum()) * 3 < L:
                a = int(rng.integers(0, L))
                s[a:a + int(rng.integers(200, 2001))] |= 0x20
        rows.append(s)
    return rows


def route_rows(shares=SHARES, seed: int = SEED + 2) -> dict:
    """{name: rows}: random A/C/G/T rows of phase 21's lengths as they are,
    with an N for the last base, with IUPAC codes on 1 in d positions and
    with lower-case runs of 100-1,000 on 1 in d (soft masking) for each d
    of `shares`, and all lower case."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    iupac = np.frombuffer(IUPAC, np.uint8)
    base = [acgt[rng.integers(0, 4, len(s))] for s in phase21_rows()]
    out = {"acgt": base, "acgt, last N": []}
    for s in base:
        s = s.copy()
        s[-1] = ord("N")
        out["acgt, last N"].append(s)
    for d in shares:
        out[f"iupac 1/{d}"], out[f"soft 1/{d}"] = [], []
        for s in base:
            L = len(s)
            t = s.copy()
            pos = rng.choice(L, L // d, replace=False)
            t[pos] = iupac[rng.integers(0, len(iupac), len(pos))]
            out[f"iupac 1/{d}"].append(t)
            t, need = s.copy(), L // d
            while (low := int((t > ord("Z")).sum())) < need:
                a = int(rng.integers(0, L))
                t[a:a + min(int(rng.integers(100, 1001)), need - low)] |= 0x20
            out[f"soft 1/{d}"].append(t)
    out["lower"] = [s | 0x20 for s in base]
    return out


def batch(seqs: list):
    """(rows (B, Lpad) uint8, lens (B,) int32, lags (G,) int32) as
    repeat_batch builds them: the CLI's grid up to half the longest row,
    rows padded with zeros to a multiple of 4."""
    lens = np.array([len(s) for s in seqs], np.int32)
    lo, hi, stride = LAGS
    lags = np.arange(lo, min(hi, int(lens.max()) // 2) + 1,
                     stride).astype(np.int32)
    buf = np.zeros((len(seqs), -(-int(lens.max()) // 4) * 4), np.uint8)
    for b, s in enumerate(seqs):
        buf[b, :len(s)] = s
    return buf, lens, lags


def bounds(lens, lags, clock_mhz: float) -> dict:
    """The least times of the counts at the card's peak: 4-byte word
    compares (one lane operation a 4 positions of every window, the first
    design's bound), position compares at 16 a lane operation (this
    design's density), and the bytes (rows read once, lens, lags and
    counts once)."""
    win = np.maximum(np.asarray(lens, np.int64)[:, None]
                     - np.asarray(lags, np.int64)[None, :], 0)
    words, positions = int(((win + 3) // 4).sum()), int(win.sum())
    lanes_per_ms = INT32_LANES * clock_mhz * 1e3
    B, G = len(lens), len(lags)
    nbytes = int(np.sum(lens)) + 4 * (B * G + B + G)
    return {"word_compares": words, "positions": positions,
            "word_ms": words / lanes_per_ms,
            "density_ms": positions / 16 / lanes_per_ms,
            "bytes": nbytes, "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def registers(log: str) -> dict:
    """{autocorr kernel entry: ptxas 'Used N registers, ...; N bytes stack
    frame, N bytes spill stores, N bytes spill loads'} of a build's ptxas
    -v log."""
    out, entry, stack = {}, None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln and "autocorr" in ln \
                else None
            stack = ""
        elif entry and "stack frame" in ln:
            stack = ln.strip()
        elif entry and "registers" in ln:
            out[entry] = ln.split(":", 1)[-1].strip() + (
                f"; {stack}" if stack else "")
            entry = None
    return out


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
    """The device's busy time a call of fn() (its kernels, memsets and
    copies, by torch.profiler over `reps` calls after a warm one), and the
    kernels' names; (None, []) where the profiler records no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [(e.key, getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0)))
          for e in prof.key_averages()]
    us = sum(t for _, t in ev)
    return ((us / reps / 1e3 if us else None),
            [f"{k[:48]} {t / reps:.2f} us" for k, t in ev if t])


def host_ms(torch, fn, reps: int) -> float:
    """The host's time a call of fn(), `reps` calls issued without waiting
    for the card (after a warm one), the mean."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def time_batch(torch, dev, seqs, clock_mhz: float, reps: int) -> dict:
    from ..ops.autocorr import autocorr_counts, autocorr_counts_reference
    buf, lens, lags = batch(seqs)
    ins = [torch.from_numpy(x).to(dev) for x in (buf, lens, lags)]
    stats: dict = {}
    try:
        got = autocorr_counts(*ins, stats=stats)
    except TypeError:               # a tree whose wrapper reports no plan
        got = autocorr_counts(*ins)
    want = autocorr_counts_reference(*ins)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    dms, names = device_ms(torch, lambda: autocorr_counts(*ins), reps)
    out = {"rows": len(seqs), "bases": int(lens.sum()),
           "min_len": int(lens.min()), "max_len": int(lens.max()),
           "lags": len(lags), "max_abs_err": err,
           "ms": cuda_ms(torch, lambda: autocorr_counts(*ins), reps),
           "host_ms": host_ms(torch, lambda: autocorr_counts(*ins), reps),
           "device_ms": dms, "device_parts": names,
           **bounds(lens, lags, clock_mhz),
           "sha256": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()}
    if stats:
        from ..ops.autocorr import unit_positions
        pos = unit_positions(stats, lens, lags)
        out["plan"] = {"units": stats["units"], "routes": stats["routes"],
                       "device_units": stats["device_units"],
                       "unit_positions_max": int(pos.max()),
                       "unit_positions_mean": float(pos.mean()),
                       "unit_positions_min": int(pos.min())}
    return out


def main(argv: list[str]) -> int:
    import torch

    from ..device import resolve
    from ..ops import _build
    opts = dict(a[2:].split("=", 1) for a in argv
                if a.startswith("--") and "=" in a)
    reps = int(opts.get("reps", 20))
    shares = [int(d) for d in opts["shares"].split(",")] \
        if "shares" in opts else SHARES
    dev = resolve("cuda", what="time_autocorr times the autocorrelation "
                  "kernels", instead="it has no CPU mode")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    clock_mhz = float(card.rsplit(",", 1)[1].split()[0])
    lib = _build.load()
    out = {"device": torch.cuda.get_device_name(0), "card": card,
           "clock_mhz": clock_mhz,
           "registers": registers(_build.build_log["ptxas"])}
    print(card, flush=True)
    for entry, used in out["registers"].items():
        print(f"{entry}: {used}", flush=True)
    batches = {"phase21": phase21_rows(), "escapes": escape_rows(),
               **route_rows(shares)}
    for tag, seqs in batches.items():
        r = time_batch(torch, dev, seqs, clock_mhz, reps)
        out[tag] = r
        dms = ("not measured" if r["device_ms"] is None
               else f"{r['device_ms']:.4f} ms")
        plan = r.get("plan", {}).get("routes", "not reported")
        print(f"{tag}: {r['rows']} rows of {r['min_len']}-{r['max_len']} "
              f"bases ({r['bases']}), {r['lags']} lags: max abs err "
              f"{r['max_abs_err']} against the plain version; "
              f"{r['ms']:.4f} ms a call, host {r['host_ms']:.4f} ms a call, "
              f"device busy {dms} ({'; '.join(r['device_parts'])}); "
              f"bounds: {r['word_ms']:.4f} ms by {r['word_compares']} word "
              f"compares, {r['density_ms']:.4f} ms by {r['positions']} "
              f"position compares at 16 a lane operation, "
              f"{r['bytes_ms']:.4f} ms by {r['bytes']} B; counts sha256 "
              f"{r['sha256'][:16]}; rows a route {plan}", flush=True)
    # the host's share of a call that is the scratch's allocation (a tree
    # whose wrapper allocates none has no autocorr_scratch_bytes)
    if hasattr(lib, "autocorr_scratch_bytes"):
        buf, lens, lags = batch(batches["phase21"])
        nbytes = lib.autocorr_scratch_bytes(*buf.shape, len(lags))
        out["scratch_alloc_host_ms"] = host_ms(
            torch, lambda: torch.empty(nbytes, dtype=torch.uint8,
                                       device=dev), reps)
        print(f"scratch allocation ({nbytes} B): host "
              f"{out['scratch_alloc_host_ms']:.4f} ms a call", flush=True)
    print(json.dumps(out), flush=True)
    return 0 if all(out[t]["max_abs_err"] == 0 for t in batches) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
