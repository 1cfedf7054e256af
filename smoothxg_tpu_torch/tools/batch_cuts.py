"""Where a task's time goes in csrc/poa_batch.cu (`--engine jax`): timing-
only cuts of the kernel, each poa_batch.cu compiled alone with nvcc into
its own library under its compile-time switch BATCH_CUTS, its launch timed
by CUDA events on the chip smoke's round timing task (a ~1 kb query
against a graph of seven ~1 kb sequences, V ~1,200, local;
tools/time_chase.round_timing_task), alone and as 132 copies (one an SM).
A cut removes one part of the work, so its outputs are invalid by design
and only its time is read; the difference to the kernel as built is what
that part costs.  The variant as built must give the library's digest.

Cuts (bits of BATCH_CUTS):
  traceback  no traceback (thread 0 stops after the fill)
  F scan     no block-wide scan of the F keys (each thread's own columns)
Variants: the kernel as built, each cut alone, both.  Needs CUDA and
nvcc.  Prints one line per variant and a JSON line.

Usage: python -m smoothxg_tpu_torch.tools.batch_cuts [--reps=R]
       [--work DIR] [--source FILE]
(--source: another version of poa_batch.cu, say an older tree's, built
against this tree's headers, so two versions can be timed in one call.)
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

CUTS = {"traceback": 1, "F scan": 2}
VARIANTS = (("as built", ()), ("traceback", ("traceback",)),
            ("F scan", ("F scan",)), ("both", ("traceback", "F scan")))
COPIES = (1, 132)


def build(work: str, cu: str | None = None) -> list:
    """One library a variant of `cu` (csrc/poa_batch.cu by default) under
    `work`, the nvcc processes started together; returns [(label,
    path)]."""
    from ..ops import _build
    cu = cu or os.path.join(_PKG, "csrc", "poa_batch.cu")
    procs = []
    for i, (label, cuts) in enumerate(VARIANTS):
        lib = os.path.join(work, f"libpoa_batch_v{i}.so")
        mask = sum(CUTS[c] for c in cuts)
        procs.append((label, lib, subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, f"-DBATCH_CUTS={mask}",
             "-I", os.path.join(_PKG, "csrc"), "-shared", "-o", lib, cu],
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
    libs = build(work, source)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    task = round_timing_task()
    cpu, _ = pb.pack_tasks([task])
    want = digest(pb.poa_batch(*(x.to(dev) for x in cpu), True))
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = {}
    for label, path in libs:
        lib = ctypes.CDLL(path)
        lib.poa_batch_launch.argtypes = [ctypes.c_void_p] * 11 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.poa_batch_launch.restype = ctypes.c_int
        res[label] = {}
        for n in COPIES:
            ins = [x.repeat_interleave(n, dim=1 if k < 2 else 0)
                   .contiguous().to(dev) for k, x in enumerate(cpu)]
            Vp, Lp, P = ins[0].shape[0], ins[2].shape[1], ins[1].shape[2]
            out = torch.empty((n, Vp + Lp + 5, 2), dtype=torch.int32,
                              device=dev)
            outpos = torch.empty(n, dtype=torch.int32, device=dev)
            bv = torch.empty(n, dtype=torch.int32, device=dev)
            scratch = torch.empty(n * pb.task_words(Vp, Lp),
                                  dtype=torch.int32, device=dev)

            def launch():
                rc = lib.poa_batch_launch(
                    *(x.data_ptr() for x in ins), out.data_ptr(),
                    outpos.data_ptr(), bv.data_ptr(), scratch.data_ptr(), n,
                    Vp, Lp, P, 1, stream)
                if rc != 0:
                    raise RuntimeError(f"batch_cuts: {label}: CUDA error "
                                       f"{rc}")

            launch()
            torch.cuda.synchronize()
            if label == "as built" and n == 1 and \
                    digest((out, outpos, bv)) != want:
                raise RuntimeError("batch_cuts: the variant as built "
                                   "differs from the library's kernel")
            ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
            ev0.record()
            for _ in range(reps[0]):
                launch()
            ev1.record()
            torch.cuda.synchronize()
            res[label][n] = ev0.elapsed_time(ev1) / reps[0]
            del scratch
        print(f"{label}: " + ", ".join(f"{ms:.3f} ms ({n} task"
                                       f"{'s' if n > 1 else ''})"
                                       for n, ms in res[label].items()),
              flush=True)
    print(json.dumps({"tool": "batch_cuts", "source": source or "csrc",
                      "device": torch.cuda.get_device_name(0),
                      "task": [task[0].n_nodes(), len(task[1])],
                      "digest": want, "reps": reps[0], "ms": res}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
