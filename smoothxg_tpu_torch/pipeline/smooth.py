"""Per-block POA smoothing: sequence extraction, dedup, POA, consensus, MSA,
and block-graph construction.

Reimplements the reference's smooth_spoa/smooth_abpoa + smooth_and_lace POA
loop (reference: src/smooth.cpp:622-1073, 135-620, 1904-2284) with a
round-synchronized engine interface so that round r of every block can be
batched into one device call: the reference's `#pragma omp parallel for` over
blocks (src/smooth.cpp:1904) becomes data-parallel block batches on TPU.

Per block (reference semantics):
  * each path range is extracted with `padding` flanking bases from its path
    (N-filled at path ends; reference: append_to_sequence, src/smooth.cpp:70-128),
  * strand-normalized to the majority orientation (src/smooth.cpp:690-692),
  * exactly deduplicated with weights (XXH64 dedup, src/smooth.cpp:698-724),
  * POA-aligned (local by default) with per-sequence weights,
  * consensus = heaviest bundle (only on the last iteration),
  * the POA graph is converted to a block graph with 1bp nodes, only
    path-supported nodes/edges, unchopped, topo-sorted, paths in original
    block order with consensus last (src/smooth.cpp:914-994, 2548-2626).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..graph.index import FlatIndex
from ..graph.mutable import MutableGraph, flip
from ..ops import poa_host
from ..ops.minhash import kmer_hashes, mash_distance
from ..ops.poa_graph import POAGraph
from ..ops.poa_host import POAParams
from ..utils.dna import encode_seq, revcomp
from ..utils.progress import Log

GAP = ord("-")


@dataclass
class MafRow:
    src: str
    start: int
    size: int
    is_rev: bool
    src_len: int
    text: str


@dataclass
class BlockResult:
    block_id: int
    graph: MutableGraph | None
    # per original range: (pid, start_pos, end_pos, target_path_rank_1based)
    path_mappings: list[tuple[int, int, int, int]]
    consensus_name: str | None
    maf: dict[str, list[MafRow]] | None
    # True when the block graph's lowest-original-path first step is reverse;
    # drives the groom flip when the MAF/merge machinery is active
    # (reference: src/smooth.cpp:1800-1829)
    groom_flip: bool = False
    stats: dict | None = None
    # when set, the block graph lives compressed in this BlockGraphCache
    # (reference memory policy: zstd block graphs + sampled hot subset,
    # src/utils.cpp:89-99, src/main.cpp:616-651) and `graph` is None
    cache: object | None = None

    def get_graph(self) -> MutableGraph | None:
        if self.cache is not None:
            return self.cache.get(self.block_id)
        return self.graph

    def set_graph(self, g: MutableGraph | None) -> None:
        if self.cache is not None:
            self.cache.put(self.block_id, g)
        else:
            self.graph = g


@dataclass
class _BlockState:
    block_id: int
    ranges: list                     # PathRange list (original block order)
    useqs: list[str] = field(default_factory=list)       # unique, normalized
    weights: list[int] = field(default_factory=list)
    dup_is_rev: list[list[bool]] = field(default_factory=list)
    dup_names: list[list[str]] = field(default_factory=list)
    dup_range_idx: list[list[int]] = field(default_factory=list)
    names_in_order: list[str] = field(default_factory=list)
    range_is_rev: list[bool] = field(default_factory=list)
    graph: POAGraph | None = None
    params: POAParams | None = None
    padding: int = 0
    # abPOA mode (-A): global alignment + adaptive band (wb/wf) + consensus
    # restricted to read-supported handles.  The reference's "per-base
    # weight matrix" is uniform per sequence (weights_abpoa[i][j] =
    # weights[i], src/smooth.cpp:326-329), so the per-sequence dedup
    # weights used by every engine here are exactly equivalent.
    abpoa_mode: bool = False
    poa_ms: float = 0.0              # attributed POA wall time


class HostPOAEngine:
    """Scalar engine: one align() per task (numpy DP)."""

    def align_batch(self, tasks):
        # tasks: list of (graph, seq_codes, params)
        return [poa_host.align(g, s, p) for (g, s, p) in tasks]


def _block_padding(idx: FlatIndex, ranges, padding_fraction: float,
                   max_block_depth_for_padding_more: int) -> int:
    """reference: src/smooth.cpp:1919-1943."""
    if padding_fraction <= 0:
        return 0
    pad = 0
    if len(ranges) <= max_block_depth_for_padding_more:
        pad = 311
    total = sum(pr.length for pr in ranges)
    avg = total / max(len(ranges), 1)
    return max(int(avg * padding_fraction), pad)


def _adaptive_params(idx: FlatIndex, ranges, base: POAParams, kmer_size: int,
                     max_depth: int) -> POAParams:
    """Estimate 30th-percentile pairwise identity via MinHash and pick a
    penalty tier (reference: src/smooth.cpp:1955-2042)."""
    if len(ranges) < 2 or len(ranges) > max_depth:
        return base
    seqs = []
    for pr in ranges:
        s = idx.range_seq(pr.pid, pr.begin, pr.end)
        if len(s) >= 8 * kmer_size:
            seqs.append(s)
    if len(seqs) < 2:
        return base
    hashes = [kmer_hashes(s, kmer_size) for s in seqs]
    dists = []
    for i in range(len(seqs)):
        for j in range(i + 1, len(seqs)):
            dists.append(1.0 - mash_distance(hashes[i], hashes[j], kmer_size))
    dists.sort()
    est = max(0.7, dists[int((len(dists) - 1) * 0.30)])
    tiers = [
        (0.99, (1, 19, 39, 3, 81, 1)),
        (0.98, (1, 13, 31, 3, 51, 1)),
        (0.97, (1, 9, 16, 2, 41, 1)),
        (0.95, (1, 7, 11, 2, 33, 1)),
        (0.90, (1, 4, 6, 2, 26, 1)),
    ]
    for thr, (m, n, g, e, q, c) in tiers:
        if est >= thr:
            return POAParams(m, n, g, e, q, c, local=base.local,
                             wb=base.wb, wf_milli=base.wf_milli)
    return base


def _extract_block(idx: FlatIndex, path_seqs: list[str], block, block_id: int,
                   padding: int, params: POAParams) -> _BlockState:
    st = _BlockState(block_id, block.path_ranges, params=params, padding=padding)
    seq_to_rank: dict[str, int] = {}
    for i, pr in enumerate(block.path_ranges):
        p0 = int(idx.path_pos[pr.pid][pr.begin])
        p1 = int(idx.path_pos[pr.pid][pr.end])
        plen = int(idx.path_len[pr.pid])
        core = path_seqs[pr.pid][max(0, p0 - padding):min(plen, p1 + padding)]
        left_fill = "N" * max(0, padding - p0)
        right_fill = "N" * max(0, (p1 + padding) - plen)
        seq = left_fill + core + right_fill
        fwd, rev = idx.rev_bp_in_window(pr.pid, p0 - padding, p1 + padding)
        is_rev = rev > fwd
        if is_rev:
            seq = revcomp(seq)
        name = f"{idx.get_path_name(pr.pid)}_{p0}"
        st.names_in_order.append(name)
        st.range_is_rev.append(is_rev)
        r = seq_to_rank.get(seq)
        if r is None:
            seq_to_rank[seq] = len(st.useqs)
            st.useqs.append(seq)
            st.weights.append(1)
            st.dup_is_rev.append([is_rev])
            st.dup_names.append([name])
            st.dup_range_idx.append([i])
        else:
            st.weights[r] += 1
            st.dup_is_rev[r].append(is_rev)
            st.dup_names[r].append(name)
            st.dup_range_idx[r].append(i)
    return st


def smooth_blocks(
    idx: FlatIndex,
    blockset,
    *,
    params: POAParams,
    adaptive_poa_params: bool = False,
    kmer_size: int = 17,
    padding_fraction: float = 0.001,
    max_block_depth_for_padding_more: int = 1000,
    consensus_base_name: str = "",
    produce_maf: bool = False,
    engine=None,
    abpoa_mode: bool = False,
    collect_stats: bool = False,
    write_poa_blocks_ms: int | None = None,
    fasta_dir: str = ".",
    graph_cache=None,
    threads: int = 1,
    seqindex=None,
    block_id_offset: int = 0,
    long_poa_band: int = 4096,
) -> list[BlockResult]:
    """Smooth every block; returns BlockResults in block-id order.

    block_id_offset shifts block ids to GLOBAL ids when a distributed
    rank smooths a contiguous shard of the blockset (parallel/multiproc)
    so consensus names / MAF records / caches match the single-process
    run byte-for-byte."""
    engine = engine or HostPOAEngine()
    add_consensus = bool(consensus_base_name)

    # path sequences: lazy mmap views when a SeqIndex is provided
    # (reference: src/seqindex.cpp), else materialized once — and only on
    # the serial path; pooled extraction derives them in-worker (poolidx)
    def _path_seqs():
        if seqindex is not None:
            return seqindex.views()
        return [idx.path_seq(pid) for pid in range(idx.path_count())]

    prepped = []
    for bid, block in enumerate(blockset, start=block_id_offset):
        pad = _block_padding(idx, block.path_ranges, padding_fraction,
                             max_block_depth_for_padding_more)
        p = params
        if adaptive_poa_params:
            p = _adaptive_params(idx, block.path_ranges, params, kmer_size,
                                 max_block_depth_for_padding_more)
        if long_poa_band and p.wb < 0 and block.path_ranges and \
                max(pr.length for pr in block.path_ranges) + 2 * pad \
                > long_poa_band:
            # long-block policy: blocks past the full-width sweet spot
            # align with abPOA semantics — global + adaptive band (the
            # reference's own recommended configuration for long POA
            # problems, -A; src/smooth.cpp:258-290) — instead of
            # full-width spoa.  Deterministic per block shape, applied
            # identically by every engine, so native and device runs stay
            # byte-identical; disable with --long-poa-band 0 for
            # reference-default full-width semantics at any length.
            p = POAParams(p.m, p.n, p.g, p.e, p.q, p.c, local=False,
                          wb=311, wf_milli=30)
        prepped.append((bid, block, pad, p))

    n_band_converted = sum(1 for _, _, _, p in prepped
                           if params.wb < 0 and p.wb >= 0)
    if n_band_converted:
        # loud: this is the one default-on semantic divergence from the
        # reference a user running reference flags would hit unknowingly
        # (reference default: full-width spoa at any length up to
        # max_poa_length, src/main.cpp:376, src/smooth.cpp:736-753).
        # PARITY.md quantifies the output delta on the DRB1 -l 4000 run.
        Log.notice(
            "smooth",
            f"{n_band_converted}/{len(prepped)} blocks exceed "
            f"--long-poa-band {long_poa_band} and will be aligned with "
            f"abPOA band semantics (global + adaptive band wb=311 "
            f"wf=0.03) instead of the reference-default full-width "
            f"local spoa; pass --long-poa-band 0 for reference-default "
            f"semantics (the fused engine then aligns those blocks at full "
            f"width on the card, to 8,703 bp a sequence)")

    if (threads > 1 and len(prepped) >= 2 * threads
            and getattr(engine, "supports_full_block_pool", False)):
        # native engine: the whole per-block body (extract -> POA ->
        # finalize) runs in the worker, one IPC round trip per chunk
        from ..utils.procpool import chunked, get_pool
        ver, idx_path = _idx_payload(idx)
        pool = get_pool(threads)
        futs = [pool.submit(_native_full_chunk, ver, idx_path, seqindex,
                            ch, add_consensus, consensus_base_name,
                            produce_maf, engine.ring_cap, abpoa_mode,
                            collect_stats, write_poa_blocks_ms, fasta_dir)
                for ch in chunked(prepped, 4 * threads)]
        results, max_rounds = [], 0
        for f in futs:
            chunk_res, max_u = f.result()
            results.extend(chunk_res)
            max_rounds = max(max_rounds, max_u)
        if graph_cache is not None:
            for res in results:
                graph_cache.put(res.block_id, res.graph)
                res.graph = None
                res.cache = graph_cache
        Log.info("smooth", f"smoothed {len(results)} blocks "
                           f"(max rounds {max_rounds})")
        return results

    if threads > 1 and len(prepped) >= 2 * threads:
        # pooled extraction (reference: the block loop body up to seq
        # collection runs inside the OMP task, src/smooth.cpp:1904)
        from ..utils.procpool import chunked, get_pool
        ver, idx_path = _idx_payload(idx)
        pool = get_pool(threads)
        futs = [pool.submit(_extract_chunk, ver, idx_path, seqindex, ch)
                for ch in chunked(prepped, 4 * threads)]
        states = [st for f in futs for st in f.result()]
    else:
        path_seqs = _path_seqs()
        states = [_extract_block(idx, path_seqs, block, bid, pad, p)
                  for bid, block, pad, p in prepped]
    for st in states:
        st.abpoa_mode = abpoa_mode

    max_rounds = max((len(st.useqs) for st in states), default=0)
    enc: list[list[np.ndarray]] = [
        [encode_seq(s) for s in st.useqs] for st in states]

    import time as _time

    if hasattr(engine, "poa_block_batch"):
        # block-fused engine: the whole multi-round POA loop of every block
        # runs in the engine (ONE device dispatch per block batch for the
        # fused Pallas kernel) and comes back as final POA graphs
        if (threads > 1 and len(states) >= 2 * threads
                and hasattr(engine, "poa_block_batch_iter")):
            # pipelined: rehydrate+finalize each device chunk on the host
            # pool while later chunks still execute on the device — total
            # approaches max(device time, host time) instead of their sum
            results = _smooth_fused_pipelined(
                idx, engine, states, enc, consensus_base_name, produce_maf,
                threads)
            return _finish_tail(states, results, collect_stats, graph_cache,
                                write_poa_blocks_ms, fasta_dir, max_rounds)
        t0 = _time.perf_counter()
        inp = [(es, st.weights, st.params) for st, es in zip(states, enc)]
        t_rehydrate = 0.0
        if hasattr(engine, "poa_block_batch_iter"):
            from ..ops.poa_rehydrate import rehydrate_device_raw
            validate = getattr(engine, "validate", True)
            graphs = [None] * len(states)
            for i, kind, payload in engine.poa_block_batch_iter(inp):
                if kind == "raw":
                    t = _time.perf_counter()
                    payload = rehydrate_device_raw(inp[i][0], inp[i][1],
                                                   payload, validate)
                    t_rehydrate += _time.perf_counter() - t
                graphs[i] = payload
        else:
            graphs = engine.poa_block_batch(inp)
        t1 = _time.perf_counter()
        ms_each = (t1 - t0) * 1e3 / max(len(states), 1)
        for st, g in zip(states, graphs):
            st.graph = g
            st.poa_ms = ms_each
        res = _finish_blocks(idx, states, consensus_base_name, produce_maf,
                             collect_stats, write_poa_blocks_ms, fasta_dir,
                             graph_cache, max_rounds, threads)
        Log.info("smooth", f"{len(states)} blocks: engine "
                 f"{t1 - t0 - t_rehydrate:.2f}s, rehydrate "
                 f"{t_rehydrate:.2f}s, finalize "
                 f"{_time.perf_counter() - t1:.2f}s")
        return res

    # round-synchronized POA: round 0 seeds the graph, round r aligns the
    # r-th unique sequence of every still-active block (device-batchable)
    for st, es in zip(states, enc):
        if es:
            st.graph = POAGraph()
            st.graph.add_sequence(es[0], st.weights[0])

    def _tasks_for(pairs, r):
        tasks, owners = [], []
        for st, es in pairs:
            if r < len(es):
                tasks.append((st.graph, es[r], st.params))
                owners.append((st, es[r], st.weights[r]))
        return tasks, owners

    def _apply(owners, alns, ms_each):
        for (st, e, w), aln in zip(owners, alns):
            st.graph.add_alignment(aln, e, w)
            st.poa_ms += ms_each

    pairs = list(zip(states, enc))
    # two waves only pay off when each wave still fills a device batch;
    # for small workloads the extra dispatches cost more than the overlap
    wave_min = 2 * getattr(engine, "max_batch", 1 << 30)
    if hasattr(engine, "align_batch_async") and len(pairs) >= wave_min:
        # two-wave pipeline: while wave w's round executes on the device,
        # the host decodes/updates/launches the other wave — the TPU-native
        # replacement for the reference's OMP dynamic scheduling overlap
        waves = [pairs[0::2], pairs[1::2]]
        wstate = []
        for wave in waves:
            tasks, owners = _tasks_for(wave, 1)
            h = engine.align_batch_async(tasks) if tasks else None
            wstate.append([1, h, owners, _time.perf_counter()])
        while any(s[1] is not None for s in wstate):
            for w, wave in enumerate(waves):
                r, h, owners, t0 = wstate[w]
                if h is None:
                    continue
                alns = engine.finish(h)
                ms_each = (_time.perf_counter() - t0) * 1e3 / max(len(owners), 1)
                _apply(owners, alns, ms_each)
                r += 1
                tasks, owners = _tasks_for(wave, r)
                h = engine.align_batch_async(tasks) if tasks else None
                wstate[w] = [r, h, owners, _time.perf_counter()]
    else:
        for r in range(1, max_rounds):
            tasks, owners = _tasks_for(pairs, r)
            if not tasks:
                break
            t0 = _time.perf_counter()
            alns = engine.align_batch(tasks)
            _apply(owners, alns,
                   (_time.perf_counter() - t0) * 1e3 / len(tasks))

    return _finish_blocks(idx, states, consensus_base_name, produce_maf,
                          collect_stats, write_poa_blocks_ms, fasta_dir,
                          graph_cache, max_rounds, threads)


# worker-side FlatIndex cache for the pool stages: the index is pickled
# once per FlatIndex object and re-sent with every chunk (bytes re-use
# makes that a memcpy); workers deserialize only when the version changes
from .poolidx import payload as _idx_payload  # noqa: E402
from .poolidx import worker_idx as _worker_idx  # noqa: E402
from .poolidx import worker_pseqs as _worker_pseqs  # noqa: E402


def _extract_chunk(idx_ver: int, idx_path: str, seqindex, items: list):
    """Pool worker: extract a chunk of blocks (sequences, strands, dedup).
    The index travels as a temp-file path (see poolidx); path sequences
    come from a SeqIndex's mmap views or are derived in-worker."""
    idx = _worker_idx(idx_ver, idx_path)
    pseqs = _worker_pseqs(idx_ver, idx_path, seqindex)
    return [_extract_block(idx, pseqs, block, bid, pad, p)
            for bid, block, pad, p in items]


def _maybe_dump_block_fasta(st, write_poa_blocks_ms, fasta_dir) -> None:
    """Dump a block FASTA when its POA took >= threshold ms
    (reference: POA_DEBUG write_block_fastas, src/smooth.cpp:2095-2110)."""
    if write_poa_blocks_ms is None or not st.useqs \
            or st.poa_ms < write_poa_blocks_ms:
        return
    import os
    os.makedirs(fasta_dir, exist_ok=True)
    p = os.path.join(fasta_dir, f"poa_block_{st.block_id}_"
                                f"{int(st.poa_ms)}ms.fa")
    with open(p, "w") as f:
        for urank, seq in enumerate(st.useqs):
            f.write(f">{st.dup_names[urank][0]}"
                    f" weight={st.weights[urank]}\n{seq}\n")


def _native_full_chunk(idx_ver: int, idx_path: str, seqindex, items: list,
                       add_consensus: bool, consensus_base_name: str,
                       produce_maf: bool, ring_cap: int, abpoa_mode: bool,
                       collect_stats: bool, write_poa_blocks_ms,
                       fasta_dir: str):
    """Pool worker running the reference's whole OMP task body
    (src/smooth.cpp:1904) for a chunk of blocks: extract -> native POA ->
    finalize, entirely in the worker — each block crosses the process
    boundary once per direction (tiny task in, BlockResult out) instead
    of three round-trips (extract out, sequences in, finalize both ways)."""
    _W_IDX = _worker_idx(idx_ver, idx_path)
    pseqs = _worker_pseqs(idx_ver, idx_path, seqindex)
    import time as _time

    from ..ops.poa_native import poa_block, rehydrate
    out = []
    max_u = 0
    for bid, block, pad, p in items:
        st = _extract_block(_W_IDX, pseqs, block, bid, pad, p)
        st.abpoa_mode = abpoa_mode
        max_u = max(max_u, len(st.useqs))
        t0 = _time.perf_counter()
        es = [encode_seq(s) for s in st.useqs]
        so: dict = {}
        base, ring, order, flat, off = poa_block(es, st.params, ring_cap,
                                                 stats_out=so)
        paths = [flat[off[i]:off[i + 1]].tolist() for i in range(len(es))]
        st.graph = rehydrate(base, ring, [int(v) for v in order], paths,
                             list(st.weights))
        st.graph.guard_splits = so.get("guard_splits", 0)
        st.poa_ms = (_time.perf_counter() - t0) * 1e3
        res = _finalize_block(_W_IDX, st, add_consensus,
                              consensus_base_name, produce_maf)
        if collect_stats:
            res.stats = _block_stats(st, res)
        _maybe_dump_block_fasta(st, write_poa_blocks_ms, fasta_dir)
        out.append(res)
    return out, max_u


def _finalize_chunk(idx_ver: int, idx_path: str, sts: list,
                    add_consensus: bool, consensus_base_name: str,
                    produce_maf: bool) -> list:
    _W_IDX = _worker_idx(idx_ver, idx_path)
    return [_finalize_block(_W_IDX, st, add_consensus, consensus_base_name,
                            produce_maf) for st in sts]


def _finalize_chunk_raw(idx_ver: int, idx_path: str, items: list,
                        add_consensus: bool, consensus_base_name: str,
                        produce_maf: bool) -> list:
    """Pool worker for the pipelined fused path: rehydrate the engine's
    raw device payload (or accept a finished fallback graph), then
    finalize — all off the main process.  Returns (results, rehydrate
    seconds, finalize seconds)."""
    import time as _time
    _W_IDX = _worker_idx(idx_ver, idx_path)
    from ..ops.poa_rehydrate import rehydrate_device_raw
    out = []
    t_rehydrate = t_finalize = 0.0
    for st, kind, payload, enc_seqs, validate in items:
        t0 = _time.perf_counter()
        if kind == "graph":
            st.graph = payload
        else:
            st.graph = rehydrate_device_raw(enc_seqs, st.weights, payload,
                                            validate)
        t1 = _time.perf_counter()
        out.append(_finalize_block(_W_IDX, st, add_consensus,
                                   consensus_base_name, produce_maf))
        t_rehydrate += t1 - t0
        t_finalize += _time.perf_counter() - t1
    return out, t_rehydrate, t_finalize


def _smooth_fused_pipelined(idx, engine, states, enc, consensus_base_name,
                            produce_maf, threads) -> list:
    """Consume the fused engine's chunk iterator, shipping each result to
    the finalize pool as it lands; later device chunks keep executing
    while earlier ones rehydrate+finalize on the pool."""
    import time as _time
    from ..utils.procpool import get_pool
    ver, idx_path = _idx_payload(idx)
    pool = get_pool(threads)
    add_consensus = bool(consensus_base_name)
    validate = getattr(engine, "validate", True)
    inp = [(es, st.weights, st.params) for st, es in zip(states, enc)]
    t0 = _time.perf_counter()
    futs: list = []
    buf: list = []
    bidx: list = []

    def flush():
        nonlocal buf, bidx
        if buf:
            futs.append((bidx, pool.submit(
                _finalize_chunk_raw, ver, idx_path, buf,
                add_consensus, consensus_base_name, produce_maf)))
            buf, bidx = [], []

    from ..utils.progress import ProgressMeter
    with ProgressMeter(len(states), "smooth", "POA blocks") as pm:
        for i, kind, payload in engine.poa_block_batch_iter(inp):
            buf.append((states[i], kind, payload, enc[i], validate))
            bidx.append(i)
            pm.increment()
            if len(buf) >= 8:
                flush()
        flush()
        t_iter = _time.perf_counter() - t0
        results: list = [None] * len(states)
        t_rehydrate = t_finalize = 0.0
        for idxs, f in futs:
            res, t_r, t_f = f.result()
            t_rehydrate += t_r
            t_finalize += t_f
            for i, r in zip(idxs, res):
                results[i] = r
    ms_each = (_time.perf_counter() - t0) * 1e3 / max(len(states), 1)
    for st in states:
        st.poa_ms = ms_each
    Log.info("smooth", f"{len(states)} blocks: engine {t_iter:.2f}s, "
             f"rehydrate {t_rehydrate:.2f}s, finalize {t_finalize:.2f}s "
             f"(rehydrate and finalize summed over {threads} workers)")
    return results


def _finish_blocks(idx, states, consensus_base_name, produce_maf,
                   collect_stats, write_poa_blocks_ms, fasta_dir,
                   graph_cache, max_rounds, threads=1) -> list[BlockResult]:
    add_consensus = bool(consensus_base_name)
    if threads > 1 and len(states) >= 2 * threads:
        # reference: OMP dynamic loop over blocks (src/smooth.cpp:1904)
        from ..utils.procpool import chunked, get_pool
        ver, idx_path = _idx_payload(idx)
        pool = get_pool(threads)
        futs = [pool.submit(_finalize_chunk, ver, idx_path, chunk,
                            add_consensus, consensus_base_name, produce_maf)
                for chunk in chunked(states, 4 * threads)]
        results = [res for f in futs for res in f.result()]
    else:
        results = [
            _finalize_block(idx, st, add_consensus, consensus_base_name,
                            produce_maf)
            for st in states
        ]
    return _finish_tail(states, results, collect_stats, graph_cache,
                        write_poa_blocks_ms, fasta_dir, max_rounds)


def _finish_tail(states, results, collect_stats, graph_cache,
                 write_poa_blocks_ms, fasta_dir, max_rounds):
    if collect_stats:
        for st, res in zip(states, results):
            res.stats = _block_stats(st, res)
    if graph_cache is not None:
        # memory-bound mode: park every block graph compressed in the cache
        # (sampled subset stays hot); downstream stages use get_graph()
        for res in results:
            graph_cache.put(res.block_id, res.graph)
            res.graph = None
            res.cache = graph_cache
    if write_poa_blocks_ms is not None:
        for st in states:
            _maybe_dump_block_fasta(st, write_poa_blocks_ms, fasta_dir)
    Log.info("smooth", f"smoothed {len(results)} blocks "
                       f"(max rounds {max_rounds})")
    return results


# per-block metrics (reference: POA_DEBUG smoothxg_block2stats.tsv,
# src/smooth.cpp:2291-2322)
STATS_COLUMNS = [
    "num.sequences", "num.dedup.sequences", "poa.padding",
    "min.seq.len.no_pad", "avg.seq.len.no_pad", "max.seq.len.no_pad",
    "min.seq.len", "avg.seq.len", "max.seq.len",
    "xpoa.graph.nodes", "xpoa.graph.edges",
    "smoothed.graph.len", "smoothed.graph.nodes", "smoothed.graph.edges",
    "smoothed.graph.paths", "smoothed.graph.steps",
    "poa.guard.splits",
]


def _block_stats(st: _BlockState, res: BlockResult) -> dict:
    pad = st.padding
    plens = [len(s) for s in st.useqs] or [0]
    lens = [max(p - 2 * pad, 0) for p in plens]
    bg_res = res.get_graph()
    s: dict = {
        "num.sequences": len(st.ranges),
        "num.dedup.sequences": len(st.useqs),
        "poa.padding": pad,
        "min.seq.len.no_pad": min(lens), "max.seq.len.no_pad": max(lens),
        "avg.seq.len.no_pad": round(sum(lens) / len(lens), 1),
        "min.seq.len": min(plens), "max.seq.len": max(plens),
        "avg.seq.len": round(sum(plens) / len(plens), 1),
        "xpoa.graph.nodes": st.graph.n_nodes() if st.graph else 0,
        "xpoa.graph.edges": len(st.graph.edge_w) if st.graph else 0,
        # fused-threading divergence counter (ops/poa_fused docstring;
        # 0 under the spoa-faithful add_alignment engines)
        "poa.guard.splits": getattr(st.graph, "guard_splits", 0),
    }
    bg = bg_res
    if bg is not None:
        s["smoothed.graph.len"] = bg.total_seq_len()
        s["smoothed.graph.nodes"] = bg.node_count()
        s["smoothed.graph.edges"] = bg.edge_count()
        s["smoothed.graph.paths"] = bg.path_count()
        s["smoothed.graph.steps"] = sum(len(x) for x in bg.path_steps)
    else:
        for k in ("smoothed.graph.len", "smoothed.graph.nodes",
                  "smoothed.graph.edges", "smoothed.graph.paths",
                  "smoothed.graph.steps"):
            s[k] = 0
    return s


def write_block_stats(path: str, results: list[BlockResult]) -> None:
    with open(path, "w") as f:
        f.write("block.id\t" + "\t".join(STATS_COLUMNS) + "\n")
        for res in results:
            if res.stats is None:
                continue
            f.write(str(res.block_id) + "\t"
                    + "\t".join(str(res.stats.get(c, "")) for c in STATS_COLUMNS)
                    + "\n")


def _finalize_block(idx: FlatIndex, st: _BlockState, add_consensus: bool,
                    consensus_base_name: str, produce_maf: bool) -> BlockResult:
    bid = st.block_id
    consensus_name = f"{consensus_base_name}{bid}" if add_consensus else None
    if st.graph is None or st.graph.n_nodes() == 0:
        return BlockResult(bid, None, [], None, None)
    g = st.graph
    pad = st.padding

    cons_path = g.consensus_path() if add_consensus else []

    maf = None
    if produce_maf:
        maf = _maf_rows(idx, st, g, cons_path, consensus_name)

    # ---- block graph construction ----
    # trimmed per-sequence node paths (padding removed;
    # reference: src/smooth.cpp:2583, steps[padding:-padding])
    trimmed = [path[pad:len(path) - pad] if pad else list(path)
               for path in g.seq_paths]

    kept: set[int] = set()
    for tp in trimmed:
        kept.update(tp)
    if st.abpoa_mode:
        # abPOA mode keeps only consensus steps on read-supported handles
        # (reference: build_odgi_abPOA, src/smooth.cpp:2507-2523)
        cons_steps = [v for v in cons_path if v in kept]
    else:
        # spoa-mode consensus keeps its full node set (incl. pad overlap),
        # reference: build_odgi_SPOA include_consensus, src/smooth.cpp:2596-2609
        cons_steps = list(cons_path)
        kept.update(cons_steps)

    bg = MutableGraph()
    remap: dict[int, int] = {}
    for v in sorted(kept):
        remap[v] = bg.create_handle(chr(g.base[v])) >> 1

    # paths in original block order (reference: src/smooth.cpp:980-994)
    # each original range becomes one path; duplicates reuse their unique
    # sequence's node path, reversed+flipped when strand-normalized
    range_paths: list[list[int]] = [None] * len(st.ranges)
    for urank, idxs in enumerate(st.dup_range_idx):
        for occ, ri in enumerate(idxs):
            is_rev = st.dup_is_rev[urank][occ]
            steps = [remap[v] << 1 for v in trimmed[urank]]
            if is_rev:
                steps = [h ^ 1 for h in reversed(steps)]
            range_paths[ri] = steps
    for ri, name in enumerate(st.names_in_order):
        pid = bg.create_path(name)
        bg.path_steps[pid] = range_paths[ri]
    if add_consensus:
        pid = bg.create_path(consensus_name)
        bg.path_steps[pid] = [remap[v] << 1 for v in cons_steps]

    bg.create_edges_from_paths()
    bg = bg.unchop_toposort()

    groom_flip = False
    if st.ranges:
        target_ri = min(range(len(st.ranges)), key=lambda i: st.ranges[i].pid)
        tsteps = bg.path_steps[target_ri]
        groom_flip = bool(tsteps and (tsteps[0] & 1))

    # per-range path mapping (reference: src/smooth.cpp:2256-2269)
    mappings = []
    for ri, pr in enumerate(st.ranges):
        p0 = int(idx.path_pos[pr.pid][pr.begin])
        p1 = int(idx.path_pos[pr.pid][pr.end])
        mappings.append((pr.pid, p0, p1, ri + 1))
    return BlockResult(bid, bg, mappings, consensus_name, maf, groom_flip)


def _flip_block_graph(bg: MutableGraph, consensus_name: str | None) -> MutableGraph:
    """Reverse-complement the block graph's node encoding while preserving
    every read path's sequence; the consensus path becomes the reverse
    complement walk (reference: src/smooth.cpp:2331-2403)."""
    out = MutableGraph()
    for n in bg.node_ids():
        out.create_handle(revcomp(bg.seqs[n]), n)
    for a, b in bg.edges():
        out.create_edge(a ^ 1, b ^ 1)
    for name, steps in zip(bg.path_names, bg.path_steps):
        pid = out.create_path(name)
        if name == consensus_name:
            out.path_steps[pid] = list(reversed(steps))
        else:
            out.path_steps[pid] = [h ^ 1 for h in steps]
    return out


def _flip_maf(maf: dict[str, list[MafRow]], consensus_name: str | None) -> None:
    """reference: _put_block_in_group with flip_block_before_merging
    (src/smooth.cpp:1099-1112, 1221-1226)."""
    for name, rows in maf.items():
        for r in rows:
            if name == consensus_name:
                r.text = revcomp(r.text)
            else:
                r.start = r.src_len - (r.start + r.size)
                r.is_rev = not r.is_rev
                r.text = revcomp(r.text)


def _maf_rows(idx, st, g, cons_path, consensus_name) -> dict[str, list[MafRow]]:
    """MSA -> MAF partial rows keyed by path name
    (reference: src/smooth.cpp:766-893)."""
    pad = st.padding
    rows = g.msa_rows(include_consensus=bool(cons_path))
    nseq = len(g.seq_paths)
    read_rows = rows[:nseq]

    # blank `pad` non-gap chars from each end of EVERY row — the consensus
    # row included — and trim over all rows (reference blanks/trims the whole
    # msa vector, consensus row included: src/smooth.cpp:774-831)
    for row in rows:
        if pad == 0:
            break
        nz = np.flatnonzero(row != GAP)
        row[nz[:pad]] = GAP
        row[nz[len(nz) - pad:]] = GAP
    # trim all-gap columns at both ends (computed over all rows)
    if rows:
        occupied = np.zeros(len(rows[0]), dtype=bool)
        for row in rows:
            occupied |= row != GAP
        nz = np.flatnonzero(occupied)
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if len(nz) else (0, 0)
    else:
        lo = hi = 0

    maf: dict[str, list[MafRow]] = {}
    for urank in range(nseq):
        for occ, ri in enumerate(st.dup_range_idx[urank]):
            pr = st.ranges[ri]
            is_rev = st.dup_is_rev[urank][occ]
            path_name = idx.get_path_name(pr.pid)
            plen = int(idx.path_len[pr.pid])
            p0 = int(idx.path_pos[pr.pid][pr.begin])
            p1 = int(idx.path_pos[pr.pid][pr.end])
            start = plen - p1 if is_rev else p0
            maf.setdefault(path_name, []).append(MafRow(
                path_name, start, p1 - p0, is_rev, plen,
                read_rows[urank][lo:hi].tobytes().decode()))
    if cons_path:
        crow = rows[-1]
        maf[consensus_name] = [MafRow(
            consensus_name, 0, max(len(cons_path) - 2 * pad, 0), False,
            max(len(cons_path) - 2 * pad, 0),
            crow[lo:hi].tobytes().decode())]
    return maf
