"""Command line interface of the port: the flags of smoothxg_tpu.cli (its
parser is reused), mapped to Config the same way, with the GPU engine as
the default.  `python -m smoothxg_tpu_torch.cli -g in.gfa -o out.gfa ...`
"""
from __future__ import annotations

import os
import sys

from smoothxg_tpu.cli import _parse_poa_params, build_parser
from smoothxg_tpu.utils.params import handy_parameter, split_csv

from .pipeline.run import Config, run_smoothing


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
    if args.dist_size > 1:
        print("[smoothxg_tpu_torch] error: multi-process runs are not yet "
              "ported (--dist-size)", file=sys.stderr)
        return 1, None
    if args.device_split_minhash or args.device_split_wfa:
        print("[smoothxg_tpu_torch] error: the split-stage device routes are "
              "not yet ported (--device-split-minhash, --device-split-wfa)",
              file=sys.stderr)
        return 1, None

    from smoothxg_tpu.pipeline.consensus_graph import parse_consensus_spec
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
        except (RuntimeError, NotImplementedError) as e:
            if not str(e).startswith(("CUDA required", "--engine")):
                raise
            print(f"[smoothxg_tpu_torch] error: {e}", file=sys.stderr)
            return 1, None
        if args.write_consensus_path_names:
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

    if specs:
        from smoothxg_tpu.pipeline.consensus_graph import \
            build_consensus_specs
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
