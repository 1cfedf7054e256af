"""Multi-process data parallelism over blocks: the port of
smoothxg_tpu/parallel/multiproc.py on torch.distributed.

Every rank replicates the cheap deterministic host stages (graph load,
prep, indexing, block finding, breaking and, after the gather, merge, lace
and validation), and only the POA smoothing shards: each rank smooths a
CONTIGUOUS slice of the blockset with GLOBAL block ids, serializes its
compact per-block results, and one all-gather gives every rank the full
result list.  Because block ids are global and every later stage is
deterministic, each rank builds the same laced graph with no broadcast;
rank 0 alone writes the output files.

The process group is torch.distributed's gloo backend on
tcp://<coordinator>: the payload is host bytes, which the reference too
gathers on the host (`process_allgather`).  NCCL would copy it to a card
and back, and refuses two ranks on one card.  The gather is two
collectives, the lengths first, then the payloads padded to the longest.
"""
from __future__ import annotations

import pickle
import zlib

import numpy as np
import torch

def init_process_group(coordinator: str, num_processes: int,
                       process_id: int, timeout_s: float = 1800.0) -> None:
    """torch.distributed bootstrap (gloo, tcp://coordinator); a no-op for
    one process or once the group is up."""
    import datetime

    import torch.distributed as dist
    if num_processes <= 1 or dist.is_initialized():
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def allgather_bytes(payload: bytes) -> list[bytes]:
    """All-gather one variable-length byte string per process: int64
    lengths first, then the max-padded uint8 payloads."""
    import torch.distributed as dist
    size = dist.get_world_size()
    n = torch.tensor([len(payload)], dtype=torch.int64)
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(size)]
    dist.all_gather(lens, n)
    lens = [int(x) for x in lens]
    m = max(max(lens), 1)
    buf = torch.zeros(m, dtype=torch.uint8)
    if payload:
        buf[:len(payload)] = torch.frombuffer(bytearray(payload),
                                              dtype=torch.uint8)
    parts = [torch.empty(m, dtype=torch.uint8) for _ in range(size)]
    dist.all_gather(parts, buf)
    return [p[:k].numpy().tobytes() for p, k in zip(parts, lens)]


def shard_bounds(n_blocks: int, rank: int, size: int) -> tuple[int, int]:
    """Contiguous [lo, hi) slice for this rank (remainder spread over the
    leading ranks)."""
    base, rem = divmod(n_blocks, size)
    lo = rank * base + min(rank, rem)
    hi = lo + base + (1 if rank < rem else 0)
    return lo, hi


def pack_results(results) -> bytes:
    """Serialize BlockResults as compact, compressed arrays: each
    finalized block graph's flat arrays (graph/mutable.to_arrays) downsized
    to int32, MAF rows as plain tuples, the whole payload deflated.  Graphs
    with non-dense ids degrade to object pickling per block."""
    metas = []
    bufs: list = []
    for r in results:
        g = r.get_graph()
        names = None
        mode = 0                       # 0 = no graph
        if g is not None:
            try:
                arrs = g.to_arrays()
                bufs.append(tuple(
                    a if a.dtype == np.uint8 else a.astype(np.int32)
                    for a in arrs))
                names = g.path_names
                mode = 1               # 1 = flat arrays
            except AssertionError:     # pragma: no cover - non-dense ids
                bufs.append(g)
                mode = 2               # 2 = pickled object
        maf = None
        if r.maf is not None:
            maf = {k: [(x.src, x.start, x.size, x.is_rev, x.src_len,
                        x.text) for x in rows]
                   for k, rows in r.maf.items()}
        metas.append((r.block_id, r.consensus_name, r.path_mappings,
                      maf, r.groom_flip, r.stats, names, mode))
    return zlib.compress(
        pickle.dumps({"v": 1, "meta": metas, "bufs": bufs}, protocol=4), 1)


def unpack_results(raw: bytes) -> list:
    from ..graph.mutable import MutableGraph
    from ..pipeline.smooth import BlockResult, MafRow

    p = pickle.loads(zlib.decompress(raw))
    out: list = []
    bi = 0
    for (bid, cname, pmaps, maf, gflip, stats, names, mode) in p["meta"]:
        g = None
        if mode == 1:
            g = MutableGraph.from_arrays(*p["bufs"][bi], names)
            bi += 1
        elif mode == 2:                 # pragma: no cover - non-dense ids
            g = p["bufs"][bi]
            bi += 1
        if maf is not None:
            maf = {k: [MafRow(*t) for t in rows]
                   for k, rows in maf.items()}
        out.append(BlockResult(bid, g, pmaps, cname, maf,
                               groom_flip=gflip, stats=stats))
    return out


def distributed_smooth_blocks(idx, blockset, *, rank: int, size: int,
                              **smooth_kwargs):
    """Shard the blockset, smooth locally, all-gather BlockResults.

    Returns the FULL result list in global block-id order on every rank
    (so lace and merge replicate instead of broadcasting a graph)."""
    from ..pipeline.blocks import Blockset
    from ..pipeline.smooth import smooth_blocks
    from ..utils.progress import Log

    blocks = list(blockset)
    lo, hi = shard_bounds(len(blocks), rank, size)
    shard = Blockset()
    for b in blocks[lo:hi]:
        shard.add_block(b)
    local = smooth_blocks(idx, shard, block_id_offset=lo, **smooth_kwargs)
    payload = pack_results(local)
    if local:
        Log.info("multiproc",
                 f"rank {rank}: all-gather payload "
                 f"{len(payload)} B for {len(local)} blocks "
                 f"({len(payload) // max(len(local), 1)} B/block)")
    parts = allgather_bytes(payload)
    results: list = []
    for part in parts:
        results.extend(unpack_results(part))
    results.sort(key=lambda r: r.block_id)
    assert len(results) == len(blocks), (len(results), len(blocks))
    return results
