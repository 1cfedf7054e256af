"""Where a minibatch's time goes in csrc/sgd.cu's chain kernel: timing-only
cuts of the kernel, each sgd.cu compiled alone with nvcc into its own
library under its compile-time switches (SGD_CUTS, SGD_CLUSTER), its chain
launch timed on the plan of one iteration of the seeded 64 x 5 Mb graph
(`sgd_plan` of the kernels as built).  A cut removes one part of the work,
so its x is invalid by design and only its time is read; the difference to
the kernel as built is what that part costs.

Cuts (bits of SGD_CUTS):
  stores    no write of x (a lone pair's, or a run head's fold)
  loads     no read of x: each pair takes its node index as its x
  fold      no fold of the runs of two or more pairs (their pairs still
            store their parts in their heads' blocks)
  barriers  neither of the minibatch's two cluster barriers (one after
            the last minibatch, so no block leaves while another reads
            its shared memory)
and, not a cut, the chain's cluster of 1, 2 or 4 thread blocks instead of
8 (SGD_CLUSTER; a valid kernel, timed as the others).  Variants: the
kernel as built, each cluster size, each cut alone, loads + stores, and
loads + stores + fold + barriers (the update alone).  Needs CUDA and nvcc.
Prints one line per variant and a JSON line.

Usage: python -m smoothxg_tpu_torch.tools.sgd_cuts [haplotypes length]
       [--reps=R] [--work DIR]
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

CUTS = {"stores": "SGD_CUTS=1", "loads": "SGD_CUTS=2", "fold": "SGD_CUTS=4",
        "barriers": "SGD_CUTS=8", "cluster 1": "SGD_CLUSTER=1",
        "cluster 2": "SGD_CLUSTER=2", "cluster 4": "SGD_CLUSTER=4"}
VARIANTS = (("as built", ()), ("cluster 1", ("cluster 1",)),
            ("cluster 2", ("cluster 2",)), ("cluster 4", ("cluster 4",)),
            ("stores", ("stores",)),
            ("loads", ("loads",)), ("fold", ("fold",)),
            ("loads + stores", ("loads", "stores")),
            ("barriers", ("barriers",)),
            ("loads + stores + fold + barriers",
             ("loads", "stores", "fold", "barriers")))


def defines(cuts) -> list[str]:
    """The compile-time switches of a variant: SGD_CUTS as the OR of its
    cuts' bits, SGD_CLUSTER where it names a cluster size."""
    mask, out = 0, []
    for name in cuts:
        key, val = CUTS[name].split("=")
        if key == "SGD_CUTS":
            mask |= int(val)
        else:
            out.append(CUTS[name])
    return out + ([f"SGD_CUTS={mask}"] if mask else [])


def build(work: str) -> list:
    """One library a variant under `work`, the nvcc processes started
    together; returns [(label, path)]."""
    from ..ops import _build
    cu = os.path.join(_PKG, "csrc", "sgd.cu")
    procs = []
    for i, (label, cuts) in enumerate(VARIANTS):
        lib = os.path.join(work, f"libsgd_v{i}.so")
        procs.append((label, lib, subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, *(f"-D{d}" for d in defines(cuts)),
             "-shared", "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    out = []
    for label, lib, p in procs:
        _, err = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"sgd_cuts: {label} did not build:\n"
                               f"{err[-800:]}")
        out.append((label, lib))
    return out


def main(argv=None) -> int:
    import numpy as np
    import torch

    from ..device import resolve
    from ..io.gfa import read_gfa
    from ..ops import sgd
    from ..testing.synth import write_pangenome
    argv = list(sys.argv[1:] if argv is None else argv)
    work = None
    if "--work" in argv:
        i = argv.index("--work")
        work = argv[i + 1]
        del argv[i:i + 2]
    reps = [int(a.split("=", 1)[1]) for a in argv
            if a.startswith("--reps=")] or [5]
    args = [a for a in argv if not a.startswith("--")]
    H = int(args[0]) if args else 64
    L = int(args[1]) if len(args) > 1 else 5_000_000
    dev = resolve("cuda", what="sgd_cuts times the SGD chain kernel",
                  instead="it has no CPU mode")
    work = work or tempfile.mkdtemp(prefix="sgd_cuts_")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    libs = build(work)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    gfa = write_pangenome(os.path.join(work, "g.gfa"), haplotypes=H,
                          length=L, seed=1)
    prob = sgd.sgd_problem(read_gfa(gfa))
    os.remove(gfa)
    arr = prob.tensors(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    ins = (*sgd.sgd_draws(gen, prob.T, prob.B_pad, arr["cdf"],
                          prob.zipf_space),
           arr["node"], arr["pos"], arr["start"], arr["count"],
           float(prob.etas(100)[0]))
    plan = sgd.sgd_plan(*ins)
    x0 = torch.from_numpy(prob.x0.astype(np.float32)).to(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    M = prob.B_pad // sgd.MINIBATCH
    res = {}
    for label, path in libs:
        lib = ctypes.CDLL(path)
        lib.sgd_chain_launch.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_int, ctypes.c_void_p]
        lib.sgd_chain_launch.restype = ctypes.c_int
        x = x0.clone()

        def launch():
            rc = lib.sgd_chain_launch(x.data_ptr(), plan.data_ptr(),
                                      prob.B_pad, stream)
            if rc != 0:
                raise RuntimeError(f"sgd_cuts: {label}: CUDA error {rc}")

        launch()
        torch.cuda.synchronize()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        for _ in range(reps[0]):
            launch()
        ev1.record()
        torch.cuda.synchronize()
        ms = ev0.elapsed_time(ev1) / reps[0]
        res[label] = ms
        print(f"{label}: {ms:.3f} ms an iteration, {ms / M * 1e3:.3f} us a "
              f"minibatch", flush=True)
    print(json.dumps({"tool": "sgd_cuts", "device":
                      torch.cuda.get_device_name(0), "graph": [H, L],
                      "minibatches": M, "reps": reps[0], "ms": res}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
