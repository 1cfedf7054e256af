"""The Hopper micro-probes (csrc/probes.cu): wrappers with launch counts,
plain PyTorch versions, bounds, and the timing shared by the probe tools.

Each probe is the counterpart of one Pallas micro-probe of the JAX
package's tools/ (the file and builder are named in each tool) and returns
that probe's (1, 128) int32 output as a (128,) tensor.  Four kernel
families, one C entry each:

  probe_scalar(case, mem, n, sz, device)   one thread; `mem` "shared"
      (dynamic shared memory, the counterpart of TPU SMEM) or "global"
      (device memory read with __ldcg: each dependent load an L2 round
      trip, as the POA kernels' graph tables are);
  probe_row(case, mem, lanes, n, plane)    the (32, 128) plane, by one
      thread (`lanes` 1) or one warp that reads the row and max-reduces it
      with shuffles (`lanes` 32, the TPU's masked row read);
  probe_tile(case, n, x)                   256 threads, one column each;
  probe_step(layout, K, n, plane)          the shift-max step on (8K, 256)
      rows, `layout` "block" (a __syncthreads a step) or "warp" (shuffles
      only).

A CUDA device (or tensor) launches the kernel and raises on any launch
error; the CPU runs the plain version, step by step, which computes the
same output.  Each wrapper counts its launches in `.launches`.

Bounds count the int32 operations of the probe's function (a load or a
store counts as one), not of the kernel's instructions, and divide them by
one lane's clock for the one-thread and one-warp families (probe_row's warp
variant computes the one-thread function, so it shares that bound) and by
SM_LANES lanes of one SM for the many-thread ones.  The SM clock is the
card's maximum (nvidia-smi clocks.max.sm).

`measure`, `slope` and `bench` are the counterparts of the TPU tools'
helpers (probe_loop2.py:13-33, probe_loop.py:27-42), timed by CUDA events
around each launch instead of the host's clock.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch

SCALAR = ("empty", "empty_u8", "chase", "chase_u8", "indep", "rmw", "rmw7",
          "cap")
ROW = ("chase", "indep", "indep4", "mread", "mread_u8", "mwrite")
TILE = ("slab", "slab_u8", "vecrow", "fillrow")
MEMS = ("shared", "global")
LAYOUTS = ("block", "warp")
STEP_KS = (1, 2, 4, 8)
PLANE = 4096                  # the (32, 128) plane
CAP_VW = 4096
CAP_WORDS = 5 * CAP_VW + 8 * CAP_VW + 2 * 2048      # 57,344 words, 224 KiB
LANE_FLOOR = -(1 << 30)
STEP_FLOOR = -16000
CHECK_N = 5000                # the N at which kernels meet plain versions


def _wrap(v: int) -> int:
    """int32 two's-complement wrap of a Python int."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >> 31 else v


def _full(v: int) -> torch.Tensor:
    return torch.full((128,), _wrap(v), dtype=torch.int32)


# ---------------------------------------------------------------------------
# inputs (the TPU probes' arrays)
# ---------------------------------------------------------------------------

def plane7(device="cpu") -> torch.Tensor:
    """The (32, 128) plane arange(4096) % 7, flat."""
    return (torch.arange(PLANE, dtype=torch.int32) % 7).to(device)


def plane11(device="cpu") -> torch.Tensor:
    """The (4096, 256) plane arange % 11."""
    return (torch.arange(4096 * 256, dtype=torch.int32) % 11).reshape(
        4096, 256).to(device)


def stack_plane(K: int, device="cpu") -> torch.Tensor:
    """probe_stack's initial (8K, 256) rows: each element its lane."""
    return torch.arange(256, dtype=torch.int32).repeat(8 * K, 1).to(device)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _table(case: str, sz: int) -> list:
    return [i % 7 for i in range(sz)] if case == "rmw7" else \
        [(i * 97 + 13) & (sz - 1) for i in range(sz)]


def scalar_reference(case: str, n: int, sz: int = 4096) -> torch.Tensor:
    """probe_scalar's function, one step at a time."""
    if case in ("empty", "empty_u8"):
        v = 1
        for _ in range(n):
            v = (v * 5 + 1) & 0xFFFF
        return _full(v)
    if case == "cap":
        bpp = list(range(CAP_VW))
        ring = list(range(CAP_VW))
        nxt = [i + 1 for i in range(CAP_VW)]
        npred = [1] * CAP_VW
        nsucc = [1] * CAP_VW
        preds = list(range(CAP_VW)) + [0] * (7 * CAP_VW)
        v = 1
        for _ in range(n):
            j = v & (CAP_VW - 1)
            w = bpp[j] + ring[j] + nxt[j] + npred[j] + preds[j]
            nsucc[j] = w & 0xFF
            v = (v * 5 + w) & 0xFFFF
        return _full(v + nsucc[0])
    t = _table(case, sz)
    acc = 0
    if case in ("chase", "chase_u8"):
        for _ in range(n):
            acc = t[acc]
    elif case == "indep":
        for i in range(n):
            acc += t[i & (sz - 1)]
    else:                                       # rmw, rmw7
        for i in range(n):
            j = i & (sz - 1)
            v = t[j]
            t[j] = v + 1
            acc += v
    return _full(acc)


def row_reference(case: str, n: int, plane: torch.Tensor) -> torch.Tensor:
    """probe_row's function on the flat (32, 128) plane."""
    x = plane.cpu().tolist()
    acc = 0
    if case == "chase":
        for _ in range(n):
            acc = x[acc]
    elif case == "indep":
        for i in range(n):
            acc += x[i % PLANE]
    elif case == "indep4":
        for i in range(n // 4):
            j = 4 * i
            acc += x[j % PLANE] + x[(j + 1) % PLANE] + x[(j + 2) % PLANE] \
                + x[(j + 3) % PLANE]
    elif case in ("mread", "mread_u8"):
        for i in range(n):
            acc += x[(i * 13) % PLANE]
    elif case == "mwrite":
        pln = [0] * PLANE
        for i in range(n):
            pln[(i * 13) % PLANE] = acc
            acc += 1
        return torch.tensor([_wrap(pln[c] + acc) for c in range(128)],
                            dtype=torch.int32)
    else:
        raise ValueError(f"unknown row case {case!r}")
    return _full(acc)


def tile_reference(case: str, n: int, x: torch.Tensor) -> torch.Tensor:
    """probe_tile's function: (8, 256) accumulator rows, one step at a
    time."""
    x = x.cpu()
    acc = torch.zeros((8, 256), dtype=torch.int32)
    if case in ("slab", "slab_u8"):
        for i in range(n):
            s = 8 * (i % 512)
            acc += x[s:s + 8]
    elif case == "vecrow":
        for i in range(n):
            s = 8 * (i % 512)
            v = x[s:s + 8]
            for _ in range(5):
                v = torch.maximum(v, acc) + 1
                acc = torch.where(v > acc, v - 3, acc)
    elif case == "fillrow":
        sm = [(i * 97 + 13) & 4095 for i in range(4096)]
        hh = torch.zeros((2048, 256), dtype=torch.int32)
        v = 0
        for _ in range(n):
            v &= 4095          # (the TPU body's index stays below 4096)
            a, b, c = sm[v], sm[(v + 1) & 4095], sm[(v + 2) & 4095]
            sm[(v + 3) & 4095] = a + 1
            s = 8 * (a % 512)
            xv = x[s:s + 8]
            y = hh[8 * (b & 255):8 * (b & 255) + 8]
            for _ in range(6):
                xv = torch.maximum(xv, acc) + 1
                acc = torch.where(xv > acc, xv - 3, acc + y)
            hh[8 * (c & 255):8 * (c & 255) + 8] = acc
            v = sm[v]
    else:
        raise ValueError(f"unknown tile case {case!r}")
    return acc[0, :128].clone()


def step_reference(K: int, n: int, plane: torch.Tensor) -> torch.Tensor:
    """probe_step's function: n steps of x = max(x, where(lane >= 1 +
    (i & 7), roll(x, 1), -16000)) on the (8K, 256) rows."""
    x = plane.cpu().reshape(8 * K, 256).clone()
    lane = torch.arange(256, dtype=torch.int32)
    floor = torch.tensor(STEP_FLOOR, dtype=torch.int32)
    for i in range(n):
        r = torch.roll(x, 1, dims=1)
        x = torch.maximum(x, torch.where(lane >= 1 + (i & 7), r, floor))
    return (x[0, :128] + n).to(torch.int32)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _lib_call(entry: str, *args) -> None:
    from ..ops import _build
    lib = _build.load()
    rc = getattr(lib, entry)(*args)
    if rc != 0:
        msg = lib.poa_win_error_string(rc).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {rc} ({msg})")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_n(n: int) -> None:
    if not 0 <= n < (1 << 31):
        raise ValueError(f"step count {n} out of range")


def probe_scalar(case: str, mem: str, n: int, sz: int = 4096,
                 device="cuda") -> torch.Tensor:
    """One thread: `case` of SCALAR on a table of `sz` words (a power of
    two; the cap case has its own 224 KiB) in `mem`."""
    dev = torch.device(device)
    _check_n(n)
    if case not in SCALAR or mem not in MEMS or sz < 1 or sz & (sz - 1):
        raise ValueError(f"probe_scalar: bad case {case!r}, mem {mem!r} or "
                         f"table size {sz}")
    if dev.type == "cpu":
        return scalar_reference(case, n, sz)
    words = CAP_WORDS if case == "cap" else sz
    table = torch.empty(words if mem == "global" else 1, dtype=torch.int32,
                        device=dev)
    out = torch.empty(128, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _lib_call("probe_scalar_launch", SCALAR.index(case),
                  MEMS.index(mem), n, sz, table.data_ptr(), out.data_ptr(),
                  _stream(dev))
    probe_scalar.launches += 1
    return out


def probe_row(case: str, mem: str, lanes: int, n: int,
              plane: torch.Tensor) -> torch.Tensor:
    """`case` of ROW on the flat (32, 128) int32 `plane` in `mem`, by one
    thread or one warp (`lanes` 1 or 32)."""
    _check_n(n)
    if case not in ROW or mem not in MEMS or lanes not in (1, 32):
        raise ValueError(f"probe_row: bad case {case!r}, mem {mem!r} or "
                         f"lanes {lanes}")
    if plane.dtype != torch.int32 or plane.numel() != PLANE or \
            not plane.is_contiguous():
        raise ValueError("probe_row: plane must be 4096 contiguous int32")
    if plane.device.type == "cpu":
        return row_reference(case, n, plane)
    dev = plane.device
    scratch = torch.empty(PLANE, dtype=torch.int32, device=dev)
    out = torch.empty(128, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _lib_call("probe_row_launch", ROW.index(case), MEMS.index(mem),
                  lanes, n, plane.data_ptr(), scratch.data_ptr(),
                  out.data_ptr(), _stream(dev))
    probe_row.launches += 1
    return out


def probe_tile(case: str, n: int, x: torch.Tensor) -> torch.Tensor:
    """`case` of TILE over the (4096, 256) int32 plane `x`, 256 threads."""
    _check_n(n)
    if case not in TILE:
        raise ValueError(f"probe_tile: bad case {case!r}")
    if x.dtype != torch.int32 or tuple(x.shape) != (4096, 256) or \
            not x.is_contiguous():
        raise ValueError("probe_tile: x must be a contiguous (4096, 256) "
                         "int32 plane")
    if x.device.type == "cpu":
        return tile_reference(case, n, x)
    dev = x.device
    hh = torch.empty(2048 * 256, dtype=torch.int32, device=dev)
    out = torch.empty(128, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _lib_call("probe_tile_launch", TILE.index(case), n, x.data_ptr(),
                  hh.data_ptr(), out.data_ptr(), _stream(dev))
    probe_tile.launches += 1
    return out


def probe_step(layout: str, K: int, n: int,
               plane: torch.Tensor) -> torch.Tensor:
    """n shift-max steps on the (8K, 256) int32 rows `plane` in `layout`
    ("block" or "warp")."""
    _check_n(n)
    if layout not in LAYOUTS or K not in STEP_KS:
        raise ValueError(f"probe_step: bad layout {layout!r} or K {K}")
    if plane.dtype != torch.int32 or tuple(plane.shape) != (8 * K, 256) or \
            not plane.is_contiguous():
        raise ValueError("probe_step: plane must be contiguous (8K, 256) "
                         "int32")
    if plane.device.type == "cpu":
        return step_reference(K, n, plane)
    dev = plane.device
    sink = torch.empty_like(plane)
    out = torch.empty(128, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _lib_call("probe_step_launch", LAYOUTS.index(layout), K, n,
                  plane.data_ptr(), sink.data_ptr(), out.data_ptr(),
                  _stream(dev))
    probe_step.launches += 1
    return out


for _w in (probe_scalar, probe_row, probe_tile, probe_step):
    _w.launches = 0       # kernel launches made by the wrapper
WRAPPERS = {"probe_scalar": probe_scalar, "probe_row": probe_row,
            "probe_tile": probe_tile, "probe_step": probe_step}


# ---------------------------------------------------------------------------
# cases: a TPU probe's case with its port variants
# ---------------------------------------------------------------------------

# int32 operations of one step of each function (loads and stores count
# one each), and of its set-up: index arithmetic of a constant-size
# modulus counts one op
STEP_OPS = {
    ("scalar", "empty"): 3, ("scalar", "empty_u8"): 3,       # mul add and
    ("scalar", "chase"): 1, ("scalar", "chase_u8"): 1,       # load
    ("scalar", "indep"): 3,                                  # and load add
    ("scalar", "rmw"): 5, ("scalar", "rmw7"): 5,  # and load add store add
    # and, 5 loads, 4 adds, and, store, mul, add, and
    ("scalar", "cap"): 15,
    ("row", "chase"): 1, ("row", "indep"): 3,
    ("row", "indep4"): 3,               # per read: index, load, add
    ("row", "mread"): 4, ("row", "mread_u8"): 4,    # mul and load add
    ("row", "mwrite"): 4,                           # mul and store add
    # index (and, mul) + 2048 x (load, add)
    ("tile", "slab"): 2 + 2048 * 2, ("tile", "slab_u8"): 2 + 2048 * 2,
    # index + 2048 x (load + 5 x (max, add, compare, sub, select))
    ("tile", "vecrow"): 2 + 2048 * 26,
    # 4 table loads, 1 store, 6 index ops, a + 1, 3 row offsets; then
    # 2048 x (2 loads, 6 x (max, add, compare, sub, add, select), store)
    ("tile", "fillrow"): 15 + 2048 * 39,
}
SETUP_OPS = {
    ("scalar", "cap"): 6 * CAP_VW + CAP_VW,
    ("tile", "fillrow"): 4 * 4096 + 2048 * 256,
}


def step_ops(family: str, case: str, K: int = 1) -> int:
    """int32 operations of one step; probe_step: a select and a max per
    element of the (8K, 256) rows, the lane mask once per column (it
    depends on the lane alone), the step's index (the roll moves data and
    computes nothing)."""
    if family == "step":
        return 2 * 8 * K * 256 + 256 + 3
    return STEP_OPS[(family, case)]


def setup_ops(family: str, case: str, sz: int = 4096) -> int:
    if family == "scalar" and case not in ("empty", "empty_u8", "cap"):
        return (2 if case == "rmw7" else 4) * sz
    return SETUP_OPS.get((family, case), 0)


# int32 lanes one H100 SM can issue a clock: 4 schedulers x 32 lanes, one
# warp instruction each.  The 64 INT32 units are not the limit: integer
# adds and multiply-adds also run on the FP32 pipe, and Hopper fuses an
# add with a max in one instruction — `vecrow` (25 such ops an element)
# runs below ops / 64 lanes on the card.
SM_LANES = 128


def lanes_of(family: str) -> int:
    """int32 lanes per clock the bound grants the family."""
    return SM_LANES if family in ("tile", "step") else 1


def bound_ms(family: str, case: str, n: int, clock_mhz: float, K: int = 1,
             sz: int = 4096) -> float:
    """Least time of the function at n steps on one SM."""
    ops = n * step_ops(family, case, K) + setup_ops(family, case, sz)
    return ops / (lanes_of(family) * clock_mhz * 1e6) * 1e3


@dataclass
class Case:
    """One TPU probe case: `name` as the TPU tool prints it, the port's
    `family` and case (`kind`; the stack's K), the table size and the
    variants it runs in (memory tier, lanes, layout)."""
    name: str
    family: str
    kind: str | int
    sz: int = 4096
    variants: list = field(default_factory=list)

    def __post_init__(self):
        if not self.variants:
            if self.family == "scalar":
                self.variants = [None] if self.kind.startswith("empty") \
                    else list(MEMS)
            elif self.family == "row":
                self.variants = [(m, ln) for m in MEMS for ln in (1, 32)]
            elif self.family == "step":
                self.variants = list(LAYOUTS)
            else:
                self.variants = [None]

    def label(self, var) -> str:
        if var is None:
            return self.name
        if isinstance(var, tuple):
            return f"{self.name}[{var[0]},lanes={var[1]}]"
        return f"{self.name}[{var}]"

    def inputs(self, device) -> torch.Tensor | None:
        if self.family == "row":
            return plane7(device)
        if self.family == "tile":
            return plane11(device)
        if self.family == "step":
            return stack_plane(self.kind, device)
        return None

    def call(self, var, n: int, inp, device) -> torch.Tensor:
        if self.family == "scalar":
            return probe_scalar(self.kind, var or "shared", n, self.sz,
                                device)
        if self.family == "row":
            return probe_row(self.kind, var[0], var[1], n, inp)
        if self.family == "tile":
            return probe_tile(self.kind, n, inp)
        return probe_step(var, self.kind, n, inp)

    def reference(self, n: int) -> torch.Tensor:
        return self.call(self.variants[0], n, self.inputs("cpu"), "cpu")

    def bound(self, n: int, clock_mhz: float) -> float:
        if self.family == "step":
            return bound_ms("step", "", n, clock_mhz, K=self.kind)
        return bound_ms(self.family, self.kind, n, clock_mhz, sz=self.sz)

    def step_bound_ns(self, clock_mhz: float) -> float:
        K = self.kind if self.family == "step" else 1
        return step_ops(self.family, self.kind, K) / (
            lanes_of(self.family) * clock_mhz) * 1e3


# ---------------------------------------------------------------------------
# timing (CUDA events; the card only)
# ---------------------------------------------------------------------------

def measure(fn, reps: int = 5) -> float:
    """ms of the fastest of `reps` launches after a warm one."""
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    best = float("inf")
    for _ in range(reps):
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        best = min(best, ev[0].elapsed_time(ev[1]))
    return best


def slope(fn_of_n, n1: int, n2: int, reps: int = 5) -> tuple:
    """(ns per step, floor ms, t1 ms, t2 ms) from the fastest launches at
    n1 and n2 steps."""
    t1 = measure(lambda: fn_of_n(n1), reps)
    t2 = measure(lambda: fn_of_n(n2), reps)
    per = (t2 - t1) / (n2 - n1) * 1e6
    return per, t1 - per * n1 * 1e-6, t1, t2


def bench(fn, n: int, reps: int = 5) -> tuple:
    """(ms, ns per step) of the fastest launch of n steps."""
    ms = measure(fn, reps)
    return ms, ms / n * 1e6


def card() -> tuple:
    """(name, 'name, power limit' as nvidia-smi gives it, max SM clock
    MHz) of card 0."""
    def smi(q, extra=()):
        try:
            return subprocess.run(
                ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader",
                 *extra], capture_output=True, text=True,
                timeout=60).stdout.strip().splitlines()[0]
        except (OSError, IndexError, subprocess.SubprocessError):
            return ""
    clk = smi("clocks.max.sm", ("--format=csv,noheader,nounits",))
    try:
        mhz = float(clk)
    except ValueError:
        raise RuntimeError(f"nvidia-smi gave no max SM clock: {clk!r}")
    return torch.cuda.get_device_name(0), smi("name,power.limit"), mhz


def check(case: Case, device, n: int = CHECK_N) -> tuple:
    """Every variant's kernel output against the plain version at n
    steps; returns (the largest absolute difference, 0 when they agree;
    the plain version's ms on the host)."""
    t0 = time.perf_counter()
    want = case.reference(n)
    plain_ms = (time.perf_counter() - t0) * 1e3
    inp = case.inputs(device)
    worst = 0
    for var in case.variants:
        got = case.call(var, n, inp, device).cpu()
        worst = max(worst, int((got.long() - want.long()).abs().max()))
    return worst, plain_ms


def run_cases(tool: str, cases: list, *, n: int | None = None,
              n1: int | None = None, n2: int | None = None, reps: int = 5,
              device="cuda", clock_mhz: float | None = None,
              echo=print) -> dict:
    """Check every case and variant against its plain version at CHECK_N
    steps, then time it: `n` steps (ns per step),
    or the slope between n1 and n2 steps.  Prints one line per variant;
    returns {"tool", "cases": [...], "ok"}.  A case that does not build,
    launch or match, or whose slope is not positive, fails the run; the
    rest still run."""
    from ..device import resolve
    dev = resolve(device)
    if clock_mhz is None:
        clock_mhz = card()[2]
    rows, ok = [], True
    for case in cases:
        try:
            err, plain_ms = check(case, dev)
        except Exception as e:                  # noqa: BLE001 — reported
            echo(f"{case.name:22s}: FAILED {type(e).__name__}: "
                 f"{str(e)[:200]}")
            ok = False
            continue
        inp = case.inputs(dev)
        for var in case.variants:
            label = case.label(var)
            row = {"name": case.name, "variant": label, "max_abs_err": err,
                   "bound_ns_per_step": case.step_bound_ns(clock_mhz),
                   "plain_ns_per_step": plain_ms / CHECK_N * 1e6}
            try:
                if n is not None:
                    ms, per = bench(lambda: case.call(var, n, inp, dev), n,
                                    reps)
                    row.update(n=n, ms=ms, ns_per_step=per,
                               bound_ms=case.bound(n, clock_mhz))
                    line = (f"warm={ms:8.3f}ms per-op={per:9.3f}ns "
                            f"(bound {row['bound_ns_per_step']:.4f}ns, "
                            f"{row['bound_ms']:.4f}ms; plain version "
                            f"{row['plain_ns_per_step']:.0f}ns)")
                else:
                    per, floor, t1, t2 = slope(
                        lambda k: case.call(var, k, inp, dev), n1, n2, reps)
                    row.update(n1=n1, n2=n2, slope_ns=per, floor_ms=floor,
                               t1_ms=t1, t2_ms=t2,
                               bound_ms=case.bound(n2, clock_mhz))
                    line = (f"slope={per:9.3f}ns/op floor={floor:7.3f}ms "
                            f"(t1={t1:.3f}ms t2={t2:.3f}ms; bound "
                            f"{row['bound_ns_per_step']:.4f}ns/op; plain "
                            f"version {row['plain_ns_per_step']:.0f}ns/op)")
                    if not per > 0:
                        row["failed"] = "slope not positive"
                        ok = False
            except Exception as e:              # noqa: BLE001 — reported
                row["failed"] = f"{type(e).__name__}: {str(e)[:200]}"
                ok = False
                line = f"FAILED {row['failed']}"
            if err:
                row["failed"] = f"kernel != plain version (max abs err {err})"
                ok = False
                line += f"  FAILED: {row['failed']}"
            echo(f"{label:30s}: {line}")
            rows.append(row)
    return {"tool": tool, "cases": rows, "ok": ok}


def split_reps(argv) -> tuple:
    """(the TPU tool's own arguments, --reps R or 5)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    reps = 5
    if "--reps" in argv:
        i = argv.index("--reps")
        reps = int(argv[i + 1])
        del argv[i:i + 2]
    return argv, reps


def tool_main(tool: str, cases: list, reps: int, *, n: int | None = None,
              n1: int | None = None, n2: int | None = None) -> int:
    """A probe tool's run: prints the card, each case and one JSON line;
    returns 1 on any failure, else 0."""
    try:
        name, smi, mhz = card()
        print(f"{tool}: {smi} (max SM clock {mhz:.0f} MHz)", flush=True)
        res = run_cases(tool, cases, n=n, n1=n1, n2=n2, reps=reps,
                        clock_mhz=mhz, echo=lambda s: print(s, flush=True))
    except Exception as e:                      # noqa: BLE001 — reported
        print(f"{tool}: FAILED {type(e).__name__}: {e}", flush=True)
        return 1
    res["device"] = {"kind": name, "smi": smi, "max_sm_mhz": mhz}
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1
