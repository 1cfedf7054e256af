"""Where a task's time goes in csrc/poa_batch.cu (`--engine jax`): timing
variants of the kernel, each poa_batch.cu compiled alone with nvcc into
its own library under its compile-time switch BATCH_CUTS, its launch timed
by CUDA events on the chip smoke's round timing task (a ~1 kb query
against a graph of seven ~1 kb sequences, V 1,220, L 1,004, local;
tools/time_chase.round_timing_task), alone, as 132 copies (one an SM) and
as 264 (two an SM, the engine's MAX_BATCH).

Cuts (bits of BATCH_CUTS):
  traceback     no traceback (warp 0 stops after the fill)
  F scan        no block-wide scan of the F keys (each thread's own
                columns; the row's barrier kept)
  ring off      the tiled route for every row: every predecessor from
                device memory, a barrier a row besides the scan's
  device lists  the row tables in device memory
  one an SM     shared memory padded so that an SM holds one block
The first two remove work, so their outputs are invalid by design and only
their time is read; the difference to the kernel as built is what that
part costs.  The others are routes: their outputs must equal the library's
(KEEP).  Variants: the kernel as built, each cut alone, the first two
together.  Needs CUDA and nvcc.  Prints one line per variant and a JSON
line.

Usage: python -m smoothxg_tpu_torch.tools.batch_cuts [--reps=R]
       [--work DIR] [--source FILE]
(--source: another version of poa_batch.cu, say an older tree's, built
as it stands beside this tree's variants; it and the kernel as built are
timed in turns, source / as built / as built / source, and must give the
same digest.)
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CUTS = {"traceback": 1, "F scan": 2, "ring off": 4, "device lists": 8,
        "one an SM": 16}
KEEP = ("ring off", "device lists", "one an SM")   # outputs kept
VARIANTS = (("as built", ()), ("traceback", ("traceback",)),
            ("F scan", ("F scan",)), ("both", ("traceback", "F scan")),
            ("ring off", ("ring off",)), ("device lists", ("device lists",)),
            ("one an SM", ("one an SM",)))
COPIES = (1, 132, 264)


def mask(cuts) -> int:
    """BATCH_CUTS of a set of cut names."""
    return sum(CUTS[c] for c in cuts)


def build(work: str, source: str | None = None) -> list:
    """One library a variant of csrc/poa_batch.cu under `work`, and one of
    `source` as it stands (labelled "source"), the nvcc processes started
    together; returns [(label, path)]."""
    from ..ops import _build
    cu = os.path.join(_PKG, "csrc", "poa_batch.cu")
    jobs = [(label, cu, mask(cuts)) for label, cuts in VARIANTS]
    if source:
        jobs.append(("source", source, 0))
    procs = []
    for i, (label, src, bits) in enumerate(jobs):
        lib = os.path.join(work, f"libpoa_batch_v{i}.so")
        procs.append((label, lib, subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, f"-DBATCH_CUTS={bits}",
             "-I", os.path.join(_PKG, "csrc"), "-shared", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    out = []
    for label, lib, p in procs:
        _, err = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"batch_cuts: {label} did not build:\n"
                               f"{err[-800:]}")
        out.append((label, lib))
    return out


def main(argv=None) -> int:
    import torch

    from ..device import resolve
    from ..ops import poa_batch as pb
    from .time_chase import digest, round_timing_task
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {}
    for opt in ("--work", "--source"):
        if opt in argv:
            i = argv.index(opt)
            opts[opt] = argv[i + 1]
            del argv[i:i + 2]
    work, source = opts.get("--work"), opts.get("--source")
    reps = [int(a.split("=", 1)[1]) for a in argv
            if a.startswith("--reps=")] or [5]
    dev = resolve("cuda", what="batch_cuts times the batch POA kernel",
                  instead="it has no CPU mode")
    work = work or tempfile.mkdtemp(prefix="batch_cuts_")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    libs = dict(build(work, source))
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    task = round_timing_task()
    cpu, _ = pb.pack_tasks([task])
    want = digest(pb.poa_batch(*(x.to(dev) for x in cpu), True))
    stream = torch.cuda.current_stream(dev).cuda_stream
    keeps = {label: all(c in KEEP for c in cuts) for label, cuts in VARIANTS}
    keeps["source"] = True
    loaded = {}

    def time_variant(label: str, n: int):
        """(ms a launch of n copies, the geometry the variant reports)."""
        if label not in loaded:
            lib = ctypes.CDLL(libs[label])
            lib.poa_batch_launch.argtypes = [ctypes.c_void_p] * 11 + [
                ctypes.c_int] * 5 + [ctypes.c_void_p]
            lib.poa_batch_launch.restype = ctypes.c_int
            loaded[label] = lib
        lib = loaded[label]
        ins = [x.repeat_interleave(n, dim=1 if k < 2 else 0)
               .contiguous().to(dev) for k, x in enumerate(cpu)]
        Vp, Lp, P = ins[0].shape[0], ins[2].shape[1], ins[1].shape[2]
        out = torch.empty((n, Vp + Lp + 5, 2), dtype=torch.int32,
                          device=dev)
        outpos = torch.empty(n, dtype=torch.int32, device=dev)
        bv = torch.empty(n, dtype=torch.int32, device=dev)
        scratch = torch.empty(n * pb.task_words(Vp, Lp), dtype=torch.int32,
                              device=dev)

        def launch():
            rc = lib.poa_batch_launch(
                *(x.data_ptr() for x in ins), out.data_ptr(),
                outpos.data_ptr(), bv.data_ptr(), scratch.data_ptr(), n,
                Vp, Lp, P, 1, stream)
            if rc != 0:
                raise RuntimeError(f"batch_cuts: {label}: CUDA error {rc}")

        launch()
        torch.cuda.synchronize()
        if keeps[label] and n == 1 and digest((out, outpos, bv)) != want:
            raise RuntimeError(f"batch_cuts: the variant {label} differs "
                               f"from the library's kernel")
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        for _ in range(reps[0]):
            launch()
        ev1.record()
        torch.cuda.synchronize()
        geo = None
        if hasattr(lib, "poa_batch_geometry"):
            g = (ctypes.c_int * 5)()
            if lib.poa_batch_geometry(n, Vp, Lp, P, g) == 0:
                geo = dict(zip(("threads", "ring", "tables", "smem",
                                "per_sm"), list(g)))
        return ev0.elapsed_time(ev1) / reps[0], geo

    res: dict = {}
    geos: dict = {}
    order = (["source", "as built", "as built", "source"] if source
             else ["as built"]) + [v for v, _ in VARIANTS[1:]]
    for label in order:
        times = res.setdefault(label, {})
        for n in COPIES:
            ms, geo = time_variant(label, n)
            times.setdefault(n, []).append(ms)
            geos.setdefault(label, {})[n] = geo
        print(f"{label}: " + ", ".join(
            f"{times[n][-1]:.3f} ms ({n} task{'s' if n > 1 else ''})"
            for n in COPIES) + (f"; geometry {geos[label]}"
                                if geos[label][1] else ""), flush=True)
    print(json.dumps({"tool": "batch_cuts", "source": source or "csrc",
                      "device": torch.cuda.get_device_name(0),
                      "task": [task[0].n_nodes(), len(task[1])],
                      "digest": want, "reps": reps[0], "ms": res,
                      "geometry": geos}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
