"""Command line interface of the port: the flags of smoothxg_tpu.cli (a
copy of its parser), mapped to Config the same way, with the GPU engine as
the default.  `python -m smoothxg_tpu_torch.cli -g in.gfa -o out.gfa ...`

Mirrors the reference's flag surface (reference: src/main.cpp:52-190,
args.hxx declarations) including magnitude suffixes (5k/1M/2G) and the
consensus mini-DSL  BASENAME,min_len[:refs[:(y|n)[:min_cov[:max_len]]]]*
(reference: src/consensus_graph.cpp:36-78).
"""
from __future__ import annotations

import argparse
import os
import sys

from .pipeline.run import Config, run_smoothing
from .utils.params import handy_parameter, split_csv


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="smoothxg-tpu-torch",
        description="Pangenome graph smoother on an NVIDIA GPU (the PyTorch "
                    "+ CUDA port of smoothxg-tpu): collinear block finder "
                    "and graph consensus generator")
    g = p.add_argument_group("mandatory")
    g.add_argument("-g", "--gfa-in", required=True, help="input GFA")
    g.add_argument("-o", "--smoothed-out", required=True, help="output GFA")

    io = p.add_argument_group("files IO")
    io.add_argument("-n", "--no-prep", action="store_true")
    io.add_argument("-i", "--in", dest="xg_in", default="",
                    help="read the flat index from this file (skips graph "
                         "load + prep on the first iteration)")
    io.add_argument("-b", "--base", default="", help="temp file base dir")
    io.add_argument("-K", "--keep-temp", action="store_true")

    pr = p.add_argument_group("graph preparation")
    pr.add_argument("-X", "--chop-to", type=int, default=100)
    pr.add_argument("-U", "--path-sgd-term-updates", type=float, default=1.0)
    pr.add_argument("--no-sgd", action="store_true",
                    help="skip the path-SGD sort during prep (groom+toposort only)")

    bc = p.add_argument_group("block computation")
    bc.add_argument("-r", "--n-haps", type=int, default=0)
    bc.add_argument("-w", "--block-weight-max", default=None)
    bc.add_argument("-j", "--path-jump-max", default="100")
    bc.add_argument("-e", "--edge-jump-max", default="0")

    cl = p.add_argument_group("copy length")
    cl.add_argument("-c", "--copy-length-min", default="1000")
    cl.add_argument("-W", "--copy-length-max", default="20k")

    bs = p.add_argument_group("block splitting")
    bs.add_argument("-I", "--block-id-min", type=float, default=0.0)
    bs.add_argument("-R", "--block-ratio-min", type=float, default=0.0)
    bs.add_argument("-d", "--min-block-depth-split", default="0")
    bs.add_argument("-D", "--min-block-depth-mash", default="12k")
    bs.add_argument("-L", "--min-seq-len-mash", default="200")
    bs.add_argument("-E", "--block-est-id-max", type=float, default=None)
    bs.add_argument("-k", "--kmer-size-mash-distance", type=int, default=17)
    bs.add_argument("--device-split-minhash", action="store_true",
                    help="compute split-stage mash distances as one "
                         "batched all-pairs pass on the GPU (uint32 hash "
                         "space, k clamped to 16; csrc/minhash.cu)")
    bs.add_argument("--device-split-wfa", action="store_true",
                    help="compute split-stage alignment identities as "
                         "one batched banded counts-carrying DP pass on "
                         "the GPU (csrc/ident.cu)")

    poa = p.add_argument_group("POA")
    poa.add_argument("-p", "--poa-params", default="1,4,6,2,26,1")
    poa.add_argument("-a", "--adaptive-poa-params", action="store_true")
    poa.add_argument("-l", "--poa-length-targets", default="4000")
    poa.add_argument("-q", "--poa-length-max", default=None)
    poa.add_argument("-O", "--poa-padding-ratio", type=float, default=0.001)
    poa.add_argument("-Y", "--max-block-depth-adaptive-poa-padding", default="1000")
    poa.add_argument("-A", "--abpoa", action="store_true")
    poa.add_argument("-Z", "--change-alignment-mode", action="store_true",
                     help="global alignment instead of local")
    poa.add_argument("--long-poa-band", default="4k",
                     help="blocks whose longest padded sequence exceeds "
                          "this align with abPOA band semantics (global + "
                          "adaptive band) instead of full-width spoa; "
                          "0 disables (full width at any length)")

    cons = p.add_argument_group("consensus graph(s)")
    cons.add_argument("-P", "--ref-paths", default="",
                      help="accepted for reference-CLI compatibility and "
                           "ignored: the reference parses this flag but its "
                           "only use is commented out "
                           "(src/main.cpp:138-141,1068-1084); per-spec ref "
                           "path files in -C specs are the working mechanism")
    cons.add_argument("-f", "--write-consensus-path-names", default="")
    cons.add_argument("-H", "--consensus-from", default="")
    cons.add_argument("-F", "--smoothed-in", default="")
    cons.add_argument("-C", "--consensus-spec", default="")
    cons.add_argument("-Q", "--consensus-prefix", default="Consensus_")
    cons.add_argument("-V", "--vanish-consensus", action="store_true")

    maf = p.add_argument_group("MAF")
    maf.add_argument("-m", "--write-msa-in-maf-format", default="")

    mrg = p.add_argument_group("block union")
    mrg.add_argument("-M", "--merge-blocks", action="store_true")
    mrg.add_argument("-N", "--preserve-unmerged-consensus", action="store_true")
    mrg.add_argument("-J", "--contiguous-path-jaccard", type=float, default=1.0)
    mrg.add_argument("-G", "--max-block-groups-in-memory", type=int, default=50)

    dbg = p.add_argument_group("debugging")
    dbg.add_argument("-B", "--write-block-stats", default="",
                     help="write per-block POA statistics to this TSV")
    dbg.add_argument("-S", "--write-split-block-fastas", action="store_true",
                     help="write FASTA sequences for split blocks to the "
                          "temp dir")
    dbg.add_argument("--write-poa-block-fastas", type=int, default=None,
                     metavar="N",
                     help="write FASTA sequences of blocks whose POA took "
                          "at least N ms")

    th = p.add_argument_group("threading / engine")
    th.add_argument("-t", "--threads", type=int, default=1)
    th.add_argument("-T", "--poa-threads", type=int, default=0)
    th.add_argument("--engine",
                    choices=["host", "jax", "pallas", "fused", "native"],
                    default="fused",
                    help="POA engine: fused whole-block CUDA kernel "
                         "(default, one launch per block batch), per-round "
                         "CUDA kernel (pallas), batched per-round CUDA "
                         "kernel with backpointer tables (jax), native "
                         "C++, or the numpy host oracle")
    th.add_argument("--dist-rank", type=int, default=0,
                    help="this process's rank in a multi-process "
                         "data-parallel run (parallel/multiproc); rank r "
                         "runs on card r mod the visible cards")
    th.add_argument("--dist-size", type=int, default=1,
                    help="number of cooperating processes; blocks shard "
                         "by contiguous global id, results all-gather, "
                         "rank 0 writes outputs")
    th.add_argument("--dist-coordinator", default="localhost:29777",
                    help="host:port of the torch.distributed (gloo) "
                         "process group")

    p.add_argument("-v", "--version", action="store_true")
    return p


def _parse_poa_params(s: str, use_abpoa: bool) -> tuple:
    vals = [int(x) for x in s.split(",")]
    if len(vals) == 6:
        return tuple(vals)
    if len(vals) == 4:
        m, n, g, e = vals
        # reference: src/main.cpp:348-360
        if not use_abpoa:
            return (m, n, g, e, g, e)
        return (m, n, g, e, 0, 0)
    raise SystemExit("poa-params must have 4 or 6 values")


def config_from_args(args, add_consensus: bool) -> Config:
    """argparse namespace -> Config (as smoothxg_tpu/cli.py:main does)."""
    return Config(
        gfa_in=args.gfa_in,
        smoothed_out=args.smoothed_out,
        n_haps=args.n_haps,
        max_block_weight=(int(handy_parameter(args.block_weight_max))
                          if args.block_weight_max else None),
        threads=max(1, args.threads),
        poa_threads=max(0, args.poa_threads),
        max_path_jump=int(handy_parameter(args.path_jump_max, 100)),
        max_edge_jump=int(handy_parameter(args.edge_jump_max, 0)),
        min_copy_length=int(handy_parameter(args.copy_length_min, 1000)),
        max_copy_length=int(handy_parameter(args.copy_length_max, 20000)),
        block_group_identity=args.block_id_min,
        block_group_est_identity=args.block_est_id_max,
        block_length_ratio_min=args.block_ratio_min,
        min_dedup_depth_for_block_splitting=int(
            handy_parameter(args.min_block_depth_split, 0)),
        min_dedup_depth_for_mash_clustering=int(
            handy_parameter(args.min_block_depth_mash, 12000)),
        min_length_mash_based_clustering=int(
            handy_parameter(args.min_seq_len_mash, 200)),
        kmer_size=args.kmer_size_mash_distance,
        device_split_minhash=args.device_split_minhash,
        device_split_wfa=args.device_split_wfa,
        poa_params=_parse_poa_params(args.poa_params, args.abpoa),
        adaptive_poa_params=args.adaptive_poa_params,
        poa_length_targets=[int(handy_parameter(x, 4000))
                            for x in split_csv(args.poa_length_targets)],
        max_poa_length=(int(handy_parameter(args.poa_length_max))
                        if args.poa_length_max else None),
        poa_padding_fraction=args.poa_padding_ratio,
        max_block_depth_for_padding_more=int(
            handy_parameter(args.max_block_depth_adaptive_poa_padding, 1000)),
        use_abpoa=args.abpoa,
        local_alignment=not args.change_alignment_mode,
        long_poa_band=int(handy_parameter(args.long_poa_band, 4096)),
        consensus_path_prefix=args.consensus_prefix,
        add_consensus=add_consensus,
        write_msa_in_maf_format=args.write_msa_in_maf_format,
        merge_blocks=args.merge_blocks,
        preserve_unmerged_consensus=args.preserve_unmerged_consensus,
        contiguous_path_jaccard=min(args.contiguous_path_jaccard, 1.0),
        max_merged_groups_in_memory=args.max_block_groups_in_memory,
        no_prep=args.no_prep,
        node_chop=args.chop_to,
        sgd_term_updates=args.path_sgd_term_updates,
        use_sgd=not args.no_sgd,
        tmp_base=args.base,
        keep_temp=args.keep_temp,
        block_stats=args.write_block_stats,
        xg_in=args.xg_in,
        write_split_blocks=args.write_split_block_fastas,
        write_poa_blocks_ms=args.write_poa_block_fastas,
        dist_rank=args.dist_rank,
        dist_size=args.dist_size,
        dist_coordinator=args.dist_coordinator,
        engine=args.engine,
    )


def run(argv=None):
    """Parse argv and run.  Returns (exit code, engine or None)."""
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if "-v" in argv or "--version" in argv:
        from . import __version__
        print(__version__)
        return 0, None
    args = build_parser().parse_args(argv)
    if not os.path.exists(args.gfa_in):
        print(f"[smoothxg_tpu_torch] error: input GFA not found: "
              f"{args.gfa_in}", file=sys.stderr)
        return 1, None
    if not args.block_weight_max and not args.n_haps:
        print("[smoothxg_tpu_torch] error: specify -r/--n-haps or "
              "-w/--block-weight-max", file=sys.stderr)
        return 1, None
    from .pipeline.consensus_graph import parse_consensus_spec
    specs = []
    requires_consensus = not args.vanish_consensus
    if args.consensus_spec:
        specs, requires_consensus = parse_consensus_spec(
            args.consensus_spec, requires_consensus)
    add_consensus = bool(args.write_consensus_path_names) or \
        requires_consensus

    engine = None
    consensus_path_names: list[str] = []
    if not args.consensus_from:
        cfg = config_from_args(args, add_consensus)
        try:
            _, consensus_path_names, engine = run_smoothing(cfg)
        except RuntimeError as e:
            if not str(e).startswith("CUDA required"):
                raise
            print(f"[smoothxg_tpu_torch] error: {e}", file=sys.stderr)
            return 1, None
        if args.write_consensus_path_names and args.dist_rank == 0:
            with open(args.write_consensus_path_names, "w") as f:
                for nm in consensus_path_names:
                    f.write(nm + "\n")
        smoothed_gfa = args.smoothed_out
    else:
        if not args.smoothed_in:
            print("[smoothxg_tpu_torch] error: -H requires -F/--smoothed-in",
                  file=sys.stderr)
            return 1, None
        smoothed_gfa = args.smoothed_in
        with open(args.consensus_from) as f:
            consensus_path_names = [ln.strip() for ln in f if ln.strip()]

    if specs and args.dist_rank == 0:
        from .pipeline.consensus_graph import build_consensus_specs
        build_consensus_specs(smoothed_gfa, specs, consensus_path_names,
                              threads=max(1, args.threads))
    if engine is not None and hasattr(engine, "stats"):
        print(f"[smoothxg_tpu_torch::engine] {engine.stats()}",
              file=sys.stderr)
    return 0, engine


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
