"""Top-level smoothing entry point of the port: the multi-iteration loop.

Reimplements the reference main program's per-iteration flow (reference:
src/main.cpp:374-1045): for each POA length target, prep -> index -> find
blocks -> break/split -> smooth -> lace/validate -> (last iteration: MAF +
consensus) -> unchop -> GFA; then optional consensus graph derivation
(reference: src/main.cpp:1067-1131).  A copy of
smoothxg_tpu/pipeline/run.py whose engines are the port's: the GPU engines,
the SGD layout at 5M term updates an iteration or more and the split
stage's device routes run on `device` (their plain versions on a CPU run);
a multi-process run (dist_size > 1, parallel/multiproc.py) puts rank r on
card r mod the visible cards.  torch is imported where it is used: each
`-t N` pool worker is spawned and imports the CLI, and so this module,
again as its main module, and must not pay for torch there.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..graph.index import FlatIndex
from ..io.gfa import read_gfa, write_gfa
from ..ops.poa_host import POAParams
from ..utils import spans
from ..utils.progress import Log, phase
from .blocks import smoothable_blocks
from .breaks import break_blocks
from .lace import lace
from .maf import maf_header, write_maf
from .prep import prep
from .smooth import smooth_blocks


@dataclass
class Config:
    gfa_in: str = ""
    smoothed_out: str = ""
    # block computation
    n_haps: int = 0
    max_block_weight: int | None = None
    max_path_jump: int = 100
    max_edge_jump: int = 0
    # copy length
    min_copy_length: int = 1000
    max_copy_length: int = 20000
    min_autocorr_z: float = 5.0
    autocorr_stride: int = 50
    # host-stage parallelism: -t for breaks/finalize, -T overrides for the
    # per-block finalize loop (reference: omp threads / poa_threads)
    threads: int = 1
    poa_threads: int = 0
    # block splitting
    block_group_identity: float = 0.0
    block_group_est_identity: float | None = None
    block_length_ratio_min: float = 0.0
    min_dedup_depth_for_block_splitting: int = 0
    min_dedup_depth_for_mash_clustering: int = 12000
    min_length_mash_based_clustering: int = 200
    kmer_size: int = 17
    # device routes of the split stage (mash distances, alignment
    # identities): csrc/minhash.cu and csrc/ident.cu on the run's device
    # (their plain versions on a CPU run)
    device_split_minhash: bool = False
    device_split_wfa: bool = False
    # POA
    poa_params: tuple = (1, 4, 6, 2, 26, 1)
    adaptive_poa_params: bool = False
    poa_length_targets: list[int] = field(default_factory=lambda: [4000])
    max_poa_length: int | None = None
    poa_padding_fraction: float = 0.001
    max_block_depth_for_padding_more: int = 1000
    use_abpoa: bool = False
    local_alignment: bool = True
    # long-block policy: blocks whose longest padded sequence exceeds this
    # align with abPOA semantics (global + adaptive band wb=311/wf=0.03)
    # instead of full-width spoa — deterministic per block, identical
    # across engines; 0 disables (reference-default full width)
    long_poa_band: int = 4096
    # consensus / maf
    consensus_path_prefix: str = "Consensus_"
    add_consensus: bool = False
    write_msa_in_maf_format: str = ""
    merge_blocks: bool = False
    preserve_unmerged_consensus: bool = False
    contiguous_path_jaccard: float = 1.0
    max_merged_groups_in_memory: int = 50
    # prep
    no_prep: bool = False
    node_chop: int = 100
    sgd_term_updates: float = 1.0
    use_sgd: bool = True
    # memory policy: hold block graphs compressed (sampled hot subset) when
    # a blockset reaches this many blocks (reference: zstd block graphs +
    # sample-rate reload, src/utils.cpp:89-99, src/main.cpp:616-651);
    # 0 disables the cache entirely
    block_graph_cache_min: int = 200_000
    # temp / debug
    tmp_base: str = ""
    # serve path sequences from an on-disk mmap store instead of resident
    # strings (reference always builds one: src/main.cpp:387-389)
    mmap_seqindex: bool = True
    keep_temp: bool = False
    block_stats: str = ""     # TSV path (reference: POA_DEBUG block2stats)
    xg_in: str = ""           # load a saved FlatIndex for iteration 1 (-i)
    write_split_blocks: bool = False      # -S split-block FASTA dumps
    write_poa_blocks_ms: int | None = None  # dump blocks slower than N ms
    # multi-process data parallelism over blocks (parallel/multiproc):
    # every rank replicates the deterministic host stages, smoothing
    # shards by contiguous global block id, results all-gather over
    # torch.distributed (gloo), rank 0 writes the outputs
    dist_rank: int = 0
    dist_size: int = 1
    dist_coordinator: str = "localhost:29777"
    # engine: "fused" (whole-block GPU kernel) | "pallas" (per-round GPU
    # kernel) | "jax" (batched per-round GPU kernel) | "native" (C++) |
    # "host" (numpy oracle) | an instance; the default runs on the GPU, as
    # the CLI's does, so a CPU run is asked for
    engine: str = "fused"


def make_engine(cfg: Config, device: str | torch.device = "cuda"):
    """The engine `cfg.engine` names: "fused" is the whole-block GPU engine,
    "pallas" and "jax" the per-round GPU engines (all on `device`), "native"
    and "host" run on the CPU.  An engine instance passes through."""
    if not isinstance(cfg.engine, str):
        return cfg.engine            # pre-built engine instance
    threads = cfg.poa_threads or cfg.threads or 1
    if cfg.engine == "fused":
        from ..ops.poa_engine import TorchPOAEngine
        eng = TorchPOAEngine(device=device, threads=threads)
        # build the kernels and launch exactly the (local, banded) variant
        # this run uses in the background, while load, prep, indexing and
        # block finding run on the host; the first POA batch waits for it
        eng.warmup_async(
            locals_=(cfg.local_alignment and not cfg.use_abpoa,),
            banded=(cfg.use_abpoa,))
        return eng
    if cfg.engine == "pallas":
        from ..ops.poa_round import TorchRoundPOAEngine
        return TorchRoundPOAEngine(device=device)
    if cfg.engine == "native":
        from ..ops.poa_native import NativePOAEngine
        return NativePOAEngine(threads=threads)
    if cfg.engine == "host":
        from .smooth import HostPOAEngine
        return HostPOAEngine()
    if cfg.engine == "jax":
        from ..ops.poa_batch import TorchBatchPOAEngine
        return TorchBatchPOAEngine(device=device)
    raise ValueError(f"unknown engine {cfg.engine!r}")


def run_smoothing(cfg: Config, device: str | torch.device = "cuda",
                  engine=None):
    """Run the full multi-iteration smoothing pipeline with the port's
    engine (`engine`, else the one cfg.engine names, on `device`).
    Returns (final gfa path, consensus path names, engine).  The call is
    one job of the port's spans (utils/spans.py): its root span, `job`."""
    with spans.job():
        return _run_smoothing(cfg, device, engine)


def _run_smoothing(cfg: Config, device, engine):
    targets = list(cfg.poa_length_targets)
    n_iters = len(targets)
    path_input = cfg.gfa_in
    consensus_path_names: list[str] = []
    if cfg.dist_size > 1:
        # the process group first, then the engine on this rank's card
        from ..parallel.multiproc import init_process_group
        init_process_group(cfg.dist_coordinator, cfg.dist_size,
                           cfg.dist_rank)
        import torch
        device = torch.device(device)
        if device.type == "cuda" and device.index is None \
                and torch.cuda.is_available():
            device = torch.device(
                "cuda", cfg.dist_rank % torch.cuda.device_count())
    engine = engine if engine is not None else make_engine(cfg, device)
    if (cfg.threads or 0) > 1 or (cfg.poa_threads or 0) > 1:
        # boot the -t worker pool now so spawn+import overlaps graph
        # load/prep instead of the first parallel stage
        from ..utils.procpool import warm
        warm(max(cfg.threads or 0, cfg.poa_threads or 0))
    tmpdir = cfg.tmp_base or os.path.dirname(os.path.abspath(cfg.smoothed_out))
    # exit-time wipe of intermediates (reference: src/tempfile.cpp static
    # destructor) — crashes and early exits never leak temps; -K keeps them
    from ..utils import tempfiles
    tempfiles.set_dir(tmpdir)
    temps: list[str] = []

    if not cfg.max_block_weight and not cfg.n_haps:
        # mirror the CLI's mandatory -r|-w check (reference:
        # src/main.cpp:274-278) for API callers: without either, the derived
        # max_block_weight degenerates to 0 (one block per node)
        raise ValueError(
            "Config requires n_haps (-r) or max_block_weight (-w)")

    for it, target in enumerate(targets):
        tag = f"({it + 1}-{n_iters})"
        last = it == n_iters - 1
        max_poa_length = cfg.max_poa_length or 2 * target
        max_block_weight = cfg.max_block_weight or target * cfg.n_haps

        if it == 0 and cfg.xg_in and os.path.exists(cfg.xg_in):
            # -i: load a pre-built index instead of graph load + prep
            # (reference: src/main.cpp:418-420)
            with phase(tag, f"loading index {cfg.xg_in}"):
                idx = FlatIndex.load(cfg.xg_in)
        else:
            with phase(tag, f"loading graph {path_input}"):
                g = read_gfa(path_input)
            if not cfg.no_prep:
                # Multi-process runs replicate prep on EVERY rank and the
                # threaded native SGD is racy (Hogwild, the reference's
                # odgi path_linear_sgd semantics): ranks would derive
                # different node orders, hence different blocksets.  Force
                # the sequential SGD whenever dist_size > 1 (the card's
                # route is deterministic).
                prep_threads = cfg.threads or 1
                if cfg.dist_size > 1 and prep_threads > 1:
                    Log.info("prep", "dist_size > 1: forcing deterministic "
                             "sequential SGD prep (threads=1) so all ranks "
                             "derive the same node order")
                    prep_threads = 1
                with phase(tag, "prepping graph"):
                    g = prep(g, cfg.node_chop, use_sgd=cfg.use_sgd,
                             sgd_term_updates=cfg.sgd_term_updates,
                             threads=prep_threads, device=device)
            else:
                g = g.compact()
            with phase(tag, "building flat index"):
                idx = FlatIndex(g)
        seqidx = None
        rsuf = f".r{cfg.dist_rank}" if cfg.dist_size > 1 else ""
        if cfg.mmap_seqindex:
            # on-disk mmap sequence store (reference: src/seqindex.cpp,
            # built once per run in src/main.cpp:387-389) — path sequences
            # are served as lazy views instead of resident strings.  Its
            # name is unique to this run, so runs whose outputs share a
            # directory never map each other's store; -K keeps it
            from ..graph.seqindex import SeqIndex
            with phase(tag, "building sequence index"):
                sqx = tempfiles.unique(f".seqindex_{it}{rsuf}.", ".sqx")
                if not cfg.keep_temp:
                    tempfiles.register(sqx)
                seqidx = SeqIndex.build(idx, sqx)
            path_seqs = seqidx.views()
        else:
            path_seqs = [idx.path_seq(p) for p in range(idx.path_count())]

        with phase(tag, "finding blocks"):
            blockset = smoothable_blocks(
                idx, max_block_weight, target,
                cfg.max_path_jump, cfg.max_edge_jump)
        with phase(tag, "breaking blocks"):
            blockset = break_blocks(
                idx, blockset,
                max_poa_length=max_poa_length,
                min_copy_length=cfg.min_copy_length,
                max_copy_length=cfg.max_copy_length,
                min_autocorr_z=cfg.min_autocorr_z,
                autocorr_stride=cfg.autocorr_stride,
                length_ratio_min=cfg.block_length_ratio_min,
                min_length_mash_based_clustering=cfg.min_length_mash_based_clustering,
                block_group_identity=cfg.block_group_identity,
                block_group_est_identity=(
                    cfg.block_group_est_identity
                    if cfg.block_group_est_identity is not None
                    else cfg.block_group_identity),
                kmer_size=cfg.kmer_size,
                min_dedup_depth_for_block_splitting=cfg.min_dedup_depth_for_block_splitting,
                min_dedup_depth_for_mash_clustering=cfg.min_dedup_depth_for_mash_clustering,
                write_split_blocks_dir=(tmpdir if cfg.write_split_blocks else ""),
                threads=cfg.threads,
                device_minhash=cfg.device_split_minhash,
                device_wfa=cfg.device_split_wfa,
                device=device)

        m, n, gp, e, q, c = cfg.poa_params
        # abPOA mode always aligns adaptively banded (reference:
        # src/smooth.cpp:2063 passes banded_alignment=true, wb=311 wf=0.03
        # at :258-264); SPOA mode is unbanded
        params = POAParams(m, n, gp, e, q, c,
                           local=cfg.local_alignment and not cfg.use_abpoa,
                           wb=311 if cfg.use_abpoa else -1)
        consensus_base = cfg.consensus_path_prefix if (last and cfg.add_consensus) else ""
        produce_maf = last and bool(cfg.write_msa_in_maf_format)
        graph_cache = None
        if cfg.block_graph_cache_min and len(blockset) >= cfg.block_graph_cache_min:
            from ..utils.blockcache import BlockGraphCache
            graph_cache = BlockGraphCache(len(blockset))
        smooth_fn = smooth_blocks
        dist_kw = {}
        if cfg.dist_size > 1:
            from ..parallel.multiproc import distributed_smooth_blocks
            smooth_fn = distributed_smooth_blocks
            dist_kw = dict(rank=cfg.dist_rank, size=cfg.dist_size)
        with phase(tag, f"smoothing {len(blockset)} blocks"):
            results = smooth_fn(
                idx, blockset,
                params=params, **dist_kw,
                adaptive_poa_params=cfg.adaptive_poa_params,
                kmer_size=cfg.kmer_size,
                padding_fraction=cfg.poa_padding_fraction,
                max_block_depth_for_padding_more=cfg.max_block_depth_for_padding_more,
                consensus_base_name=consensus_base,
                produce_maf=produce_maf,
                engine=engine,
                abpoa_mode=cfg.use_abpoa,
                collect_stats=bool(cfg.block_stats) and last,
                long_poa_band=cfg.long_poa_band,
                write_poa_blocks_ms=cfg.write_poa_blocks_ms,
                fasta_dir=tmpdir,
                graph_cache=graph_cache,
                threads=cfg.poa_threads or cfg.threads,
                seqindex=seqidx)
        if cfg.block_stats and last and cfg.dist_rank == 0:
            from .smooth import write_block_stats
            write_block_stats(cfg.block_stats, results)
        merge_outcome = None
        if produce_maf or (consensus_base and cfg.merge_blocks):
            from .merge import merge_blocks_pass
            with phase(tag, "merging / grooming blocks"):
                merge_outcome = merge_blocks_pass(
                    results,
                    merge_blocks=cfg.merge_blocks,
                    consensus_base_name=consensus_base,
                    add_consensus=bool(consensus_base),
                    contiguous_path_jaccard=cfg.contiguous_path_jaccard,
                    preserve_unmerged_consensus=cfg.preserve_unmerged_consensus,
                    max_groups=cfg.max_merged_groups_in_memory)

        with phase(tag, "lacing and validating"):
            smoothed, cons_names = lace(
                idx, results, path_seqs, merge_outcome=merge_outcome,
                preserve_unmerged_consensus=cfg.preserve_unmerged_consensus,
                consensus_base_name=consensus_base)
        if last:
            consensus_path_names = cons_names

        if produce_maf:
            # full effective-parameter dump, grouped per stage like the
            # reference (src/main.cpp:500-537)
            est_id = (cfg.block_group_est_identity
                      if cfg.block_group_est_identity is not None
                      else cfg.block_group_identity)
            hdr = maf_header(os.path.basename(cfg.gfa_in), idx.path_count(), {
                "merge_blocks":
                    f"{str(cfg.merge_blocks).lower()}"
                    f" contiguous_path_jaccard={cfg.contiguous_path_jaccard}",
                "POA":
                    ("abPOA" if cfg.use_abpoa else "SPOA")
                    + " alignment_mode="
                    + ("local" if params.local else "global")
                    + " order_paths=from_longest",
                "max_block_weight":
                    f"{max_block_weight} max_block_jump={cfg.max_path_jump}"
                    f" max_edge_jump={cfg.max_edge_jump}",
                "max_poa_length":
                    f"{max_poa_length} min_copy_length={cfg.min_copy_length}"
                    f" max_copy_length={cfg.max_copy_length}"
                    f" min_autocorr_z={cfg.min_autocorr_z}"
                    f" autocorr_stride={cfg.autocorr_stride}",
                "block_group_identity":
                    f"{cfg.block_group_identity}"
                    f" block_group_estimated_identity={est_id}"
                    f" min_length_mash_based_clustering="
                    f"{cfg.min_length_mash_based_clustering}"
                    f" min_dedup_depth_for_mash_clustering="
                    f"{cfg.min_dedup_depth_for_mash_clustering}"
                    f" kmer_size={cfg.kmer_size}",
            })
            if cfg.dist_rank == 0:
                with phase(tag, f"writing MAF {cfg.write_msa_in_maf_format}"):
                    write_maf(cfg.write_msa_in_maf_format, hdr,
                              merge_outcome.maf_records)

        # rank 0 writes the output; every other rank's graphs, the last
        # one too, are rank-suffixed intermediates
        if last and (cfg.dist_rank == 0 or cfg.dist_size == 1):
            out_path = cfg.smoothed_out
        else:
            out_path = os.path.join(
                tmpdir,
                f"{os.path.basename(cfg.gfa_in)}.smooth.{it}{rsuf}.gfa")
        with phase(tag, f"writing smoothed graph {out_path}"):
            write_gfa(smoothed, out_path)
        if not last or (cfg.dist_size > 1 and cfg.dist_rank != 0):
            temps.append(out_path)
            if not cfg.keep_temp:
                tempfiles.register(out_path)
        if seqidx is not None and not cfg.keep_temp:
            seqidx.remove()      # per-iteration temp (src/main.cpp:611)
            tempfiles.unregister(seqidx.path)
        path_input = out_path

    if not cfg.keep_temp:
        for t in temps:
            try:
                os.remove(t)
            except OSError:
                pass
    return cfg.smoothed_out, consensus_path_names, engine
