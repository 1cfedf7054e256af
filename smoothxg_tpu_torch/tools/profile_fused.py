"""Where the time of the code-chase POA kernels goes on the GPU: each
profiling `stage` of csrc/poa_code.cu and csrc/poa_stacked.cu timed on the
same launch.  Counterpart of tools/profile_fused.py (whose DRB1 input is
absent): the iteration-1 blocks of the seeded 16 x 80 kb pangenome
(testing/synth.py, the chip smoke's seed), built through the port's own
modules as that tool builds them (prep without SGD, smoothable_blocks,
break_blocks, _extract_block, POAParams(local=True)), the first 32 packed
as TorchPOAEngine(shape=...) packs a launch.

Stages (ops/poa_code.py): 0 full, 1 fill + end cell, 2 + code chase, 3
threading without the ring scan, 4 threading without node creation or
edge bookkeeping, 5 / 6 / 7 fill without the F scan / the code word / the
predecessor-slot loop; poa_stacked has 0, 1, 2.  The split: fill = t1,
traceback = t2 - t1, threading = t0 - t2; F scan = t1 - t5, code word =
t1 - t6, predecessor loop = t1 - t7; ring scan = t0 - t3, node creation
and edges = t0 - t4.  stage != 0 graphs are invalid by design: timings
only.  Needs CUDA.

Usage: python -m smoothxg_tpu_torch.tools.profile_fused [reps] [stages]
       [stacked stages]   (defaults: 3, 1,2,0 and 1,2,0; e.g. 3 0-7 0-2)
"""
from __future__ import annotations

import json
import os
import sys

BLOCKS = 32
SHAPE = (8704, 4096)
SEED = 20261016


def parse_stages(arg: str) -> list:
    """'1,2,0' or '0-7' -> stage numbers."""
    out = []
    for part in arg.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return out


def iteration1_blocks(workdir: str, n: int = BLOCKS, seed: int = SEED,
                      haplotypes: int = 16, length: int = 80_000) -> list:
    """The first `n` iteration-1 POA blocks (sequences as bytes, weights,
    POAParams(local=True)) of the seeded pangenome, as the JAX package's
    tools/profile_fused.py:32-48 builds DRB1's."""
    from ..graph.index import FlatIndex
    from ..io.gfa import read_gfa
    from ..ops.poa_host import POAParams
    from ..pipeline.blocks import smoothable_blocks
    from ..pipeline.breaks import break_blocks
    from ..pipeline.prep import prep
    from ..pipeline.smooth import _block_padding, _extract_block
    from ..testing.synth import write_pangenome
    from ..utils.dna import encode_seq
    os.makedirs(workdir, exist_ok=True)
    gfa = write_pangenome(os.path.join(workdir, "pangenome.gfa"),
                          haplotypes=haplotypes, length=length,
                          snv_rate=0.01, indel_rate=0.001, sv_count=4,
                          seed=seed)
    g = prep(read_gfa(gfa), 100, use_sgd=False)
    idx = FlatIndex(g)
    target = 700
    bs = smoothable_blocks(idx, target * 12, target, 5000, 5000)
    bs = break_blocks(idx, bs, max_poa_length=2 * target)
    params = POAParams(local=True)
    path_seqs = [idx.path_seq(p) for p in range(idx.path_count())]
    blocks = []
    for bid, block in enumerate(bs):
        pad = _block_padding(idx, block.path_ranges, 0.001, 1000)
        st = _extract_block(idx, path_seqs, block, bid, pad, params)
        blocks.append(([encode_seq(s) for s in st.useqs], st.weights,
                       params))
        if len(blocks) == n:
            break
    return blocks


def time_stages(kern, ins, caps, stages, reps: int = 3) -> dict:
    """{stage: ms of the fastest of `reps` launches after a warm one}."""
    from ._probe import measure
    return {s: measure(lambda s=s: kern(*ins, caps, stage=s), reps)
            for s in stages}


def stage_split(t: dict) -> dict:
    """The split of a kernel's time from its stage times (ms), for the
    stages measured."""
    parts = {"fill": (1,), "traceback": (2, 1), "threading": (0, 2),
             "F scan": (1, 5), "code word": (1, 6),
             "predecessor loop": (1, 7), "ring scan": (0, 3),
             "node creation and edges": (0, 4)}
    out = {}
    for name, ks in parts.items():
        if all(k in t for k in ks):
            out[name] = t[ks[0]] - (t[ks[1]] if len(ks) > 1 else 0.0)
    return out


def format_split(label: str, t: dict) -> str:
    sp = stage_split(t)
    total = t.get(0)
    return (f"{label}: " + ", ".join(f"stage {s} {ms:.3f} ms"
                                     for s, ms in sorted(t.items()))
            + "; split " + ", ".join(
                f"{k} {v:.3f} ms" + (f" ({v / total:.0%})" if total else "")
                for k, v in sp.items()))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    reps = int(argv[0]) if argv else 3
    code_stages = parse_stages(argv[1]) if len(argv) > 1 else [1, 2, 0]
    stk_stages = parse_stages(argv[2]) if len(argv) > 2 else [1, 2, 0]
    import torch
    from ..device import resolve
    from ..ops.poa_code import STAGES, CodeCaps, poa_code
    from ..ops.poa_stacked import STAGES as STK_STAGES
    from ..ops.poa_stacked import poa_stacked, stacked_caps
    from ..ops.poa_win import pack_blocks
    from ._probe import card
    try:
        dev = resolve("cuda")
    except RuntimeError as e:
        print(f"profile_fused: {e}", file=sys.stderr)
        return 1
    for s in code_stages:
        if s not in STAGES:
            raise SystemExit(f"poa_code has stages 0-7, not {s}")
    for s in stk_stages:
        if s not in STK_STAGES:
            raise SystemExit(f"poa_stacked has stages 0-2, not {s}")
    name, smi, mhz = card()
    blocks = iteration1_blocks(os.path.join("smoke_out", "profile_fused"))
    print(f"profile_fused: {smi}; {len(blocks)} iteration-1 blocks, "
          f"alignments={sum(len(b[0]) - 1 for b in blocks)}, caps "
          f"V{SHAPE[0]}xL{SHAPE[1]}", flush=True)
    ins = [x.to(dev) for x in pack_blocks([(b[0], b[2]) for b in blocks],
                                          SHAPE[1])]
    res = {}
    for label, kern, caps, stages in (
            ("poa_code", poa_code, CodeCaps(*SHAPE, True, False),
             code_stages),
            ("poa_stacked", poa_stacked, stacked_caps(*SHAPE, True, False),
             stk_stages)):
        meta = kern(*ins, caps)[0]
        if int(meta[:, 1].sum()):
            print(f"{label}: {int(meta[:, 1].sum())} blocks overflow the "
                  f"caps", flush=True)
        t = time_stages(kern, ins, caps, stages, reps)
        print(format_split(label, t), flush=True)
        res[label] = {"stages_ms": t, "split_ms": stage_split(t)}
        torch.cuda.empty_cache()
    print(json.dumps({"tool": "profile_fused", "device": {
        "kind": name, "smi": smi, "max_sm_mhz": mhz}, "blocks": len(blocks),
        **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
