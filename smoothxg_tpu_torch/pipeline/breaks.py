"""Block cutting (repeat-aware) and identity splitting.

Reimplements the reference's break_blocks stage (reference:
src/breaks.cpp:106-606):

  * CUT: a block containing any range longer than max_poa_length is cut —
    at half the detected VNTR repeat period when autocorrelation finds one
    over sequences >= 2*min_copy_length, else blindly at max_poa_length
    (reference: src/breaks.cpp:203-323).
  * SPLIT: when identity thresholds are configured, sequences are exactly
    deduplicated (fwd+revcomp), sorted by (length, lex), and greedily
    clustered newest-group/newest-member-first with a length-ratio prune;
    long sequences in deep blocks use mash MinHash distance, others a
    bounded WFA gap-compressed identity (reference: src/breaks.cpp:325-575).

The reference runs this as an OpenMP loop with an ordered writer thread;
here the per-block work is independent and block order is preserved by
construction, so the stage is a deterministic map over blocks.  The
autocorrelation / minhash / WFA inner ops are numpy-vectorized (ops/) and
batchable on device later.
"""
from __future__ import annotations

import numpy as np

from ..graph.index import FlatIndex
from ..ops.autocorr import repeat as autocorr_repeat
from ..ops.minhash import kmer_hashes, mash_distance
from ..ops.wfa import wfa_align, gap_compressed_identity
from ..utils.dna import revcomp
from ..utils.progress import Log
from .blocks import Block, Blockset, PathRange


def break_blocks(
    idx: FlatIndex,
    blockset: Blockset,
    *,
    max_poa_length: int,
    min_copy_length: int = 1000,
    max_copy_length: int = 20000,
    min_autocorr_z: float = 5.0,
    autocorr_stride: int = 50,
    length_ratio_min: float = 0.0,
    min_length_mash_based_clustering: int = 200,
    block_group_identity: float = 0.0,
    block_group_est_identity: float = 0.0,
    kmer_size: int = 17,
    min_dedup_depth_for_block_splitting: int = 0,
    min_dedup_depth_for_mash_clustering: int = 12000,
    order_paths_from_longest: bool = True,
    break_repeats: bool = True,
    write_split_blocks_dir: str = "",
    threads: int = 1,
    device_minhash: bool = False,
    device_wfa: bool = False,
    device: str = "cuda",
) -> Blockset:
    kw = dict(
        max_poa_length=max_poa_length, min_copy_length=min_copy_length,
        max_copy_length=max_copy_length, min_autocorr_z=min_autocorr_z,
        autocorr_stride=autocorr_stride,
        order_paths_from_longest=order_paths_from_longest,
        break_repeats=break_repeats,
        length_ratio_min=length_ratio_min,
        min_length_mash=min_length_mash_based_clustering,
        block_group_identity=block_group_identity,
        block_group_est_identity=block_group_est_identity,
        kmer_size=kmer_size,
        min_dedup_depth_split=min_dedup_depth_for_block_splitting,
        min_dedup_depth_mash=min_dedup_depth_for_mash_clustering,
        device_minhash=device_minhash,
        device_wfa=device_wfa,
        device=device,
    )
    blocks = list(blockset)
    if (device_minhash or device_wfa) and threads > 1:
        # the device split routes launch on the parent's CUDA context,
        # which spawned pool workers do not share: the block loop runs
        # serially on the main process (the device batches the O(n^2)
        # work instead), as in the JAX package
        threads = 1
    if threads > 1 and len(blocks) >= 2 * threads:
        # reference: OMP parallel block loop + ordered writer thread
        # (src/breaks.cpp:198); chunk order preserves block order here
        from ..utils.procpool import chunked, get_pool
        from .poolidx import payload
        ver, idx_path = payload(idx)
        pool = get_pool(threads)
        futs = [pool.submit(_break_chunk, ver, idx_path, chunk, kw)
                for chunk in chunked(blocks, 4 * threads)]
        from ..utils.progress import ProgressMeter
        with ProgressMeter(len(futs), "break_blocks", "block chunks") as pm:
            per_block = []
            for f in futs:
                per_block.extend(f.result())
                pm.increment()
    else:
        from ..utils.progress import ProgressMeter
        with ProgressMeter(len(blocks), "break_blocks", "blocks") as pm:
            per_block = []
            for b in blocks:
                per_block.append(_break_one(idx, b, kw))
                pm.increment()

    out = Blockset()
    n_cut = n_repeat = n_split = 0
    for in_bid, (splits, cut, rep) in enumerate(per_block):
        n_cut += cut
        n_repeat += rep
        if len(splits) > 1:
            n_split += 1
            if write_split_blocks_dir:
                # debug FASTA dump of split blocks
                # (reference: -S, src/breaks.cpp POA_DEBUG fasta output)
                _write_split_fastas(idx, write_split_blocks_dir, in_bid, splits)
        for b in splits:
            out.add_block(b)

    Log.info("break_blocks",
             f"cut {n_cut} blocks of which {n_repeat} had repeats; "
             f"split {n_split} blocks -> {len(out)} blocks")
    # machine-readable counters (reference logs these at
    # src/breaks.cpp:588-590); tests/bench assert the split stage fired
    out.break_stats = {"cut": n_cut, "repeat": n_repeat, "split": n_split}
    return out


def _break_one(idx, block, kw) -> tuple[list[Block], int, int]:
    counters = [0, 0]
    block = _cut_block(idx, block, kw["max_poa_length"],
                       kw["min_copy_length"], kw["max_copy_length"],
                       kw["min_autocorr_z"], kw["autocorr_stride"],
                       kw["order_paths_from_longest"], kw["break_repeats"],
                       counters)
    splits = _split_block(
        idx, block,
        length_ratio_min=kw["length_ratio_min"],
        min_length_mash=kw["min_length_mash"],
        block_group_identity=kw["block_group_identity"],
        block_group_est_identity=kw["block_group_est_identity"],
        kmer_size=kw["kmer_size"],
        min_dedup_depth_split=kw["min_dedup_depth_split"],
        min_dedup_depth_mash=kw["min_dedup_depth_mash"],
        device_minhash=kw.get("device_minhash", False),
        device_wfa=kw.get("device_wfa", False),
        device=kw.get("device", "cuda"),
    )
    return splits, counters[0], counters[1]


def _break_chunk(idx_ver, idx_path, blocks, kw):
    from .poolidx import worker_idx
    return [_break_one(worker_idx(idx_ver, idx_path), b, kw)
            for b in blocks]


def _write_split_fastas(idx, outdir, in_bid, splits) -> None:
    import os
    os.makedirs(outdir, exist_ok=True)
    for gi, b in enumerate(splits):
        path = os.path.join(outdir, f"split_block_{in_bid}_{gi}.fa")
        with open(path, "w") as f:
            for pr in b.path_ranges:
                name = f"{idx.get_path_name(pr.pid)}_{pr.begin}_{pr.end}"
                f.write(f">{name}\n{idx.range_seq(pr.pid, pr.begin, pr.end)}\n")


def _cut_block(idx, block, max_poa_length, min_copy_length, max_copy_length,
               min_autocorr_z, autocorr_stride, order_paths_from_longest,
               break_repeats, counters) -> Block:
    to_break = any(pr.length > max_poa_length for pr in block.path_ranges)
    if len(block.path_ranges) <= 1 or not to_break:
        return block
    counters[0] = 1
    cut_length = max_poa_length
    found_repeat = False
    if break_repeats:
        lengths = []
        for pr in block.path_ranges:
            if pr.length >= 2 * min_copy_length:
                seq = idx.range_seq(pr.pid, pr.begin, pr.end)
                r = autocorr_repeat(seq, min_copy_length, max_copy_length,
                                    min_autocorr_z, autocorr_stride)
                if r.length > 0:
                    lengths.append(r.length)
        found_repeat = bool(lengths)
        if found_repeat:
            cut_length = int(np.mean(lengths) / 2.0 + 0.5)
            counters[1] = 1

    chopped: list[PathRange] = []
    for pr in block.path_ranges:
        if not found_repeat and pr.length < cut_length:
            chopped.append(pr)
            continue
        steps = idx.path_steps[pr.pid]
        node_len = idx.node_len
        pos = 0
        last_cut = 0
        last_end = pr.begin
        for r in range(pr.begin, pr.end):
            pos += int(node_len[(int(steps[r]) >> 1) - 1])
            if pos - last_cut > cut_length:
                chopped.append(PathRange(pr.pid, last_end, r + 1, pos - last_cut))
                last_end = r + 1
                last_cut = pos
        if pr.end != last_end:
            chopped.append(PathRange(pr.pid, last_end, pr.end, pos - last_cut))
    nb = Block()
    nb.path_ranges = sorted(
        chopped, key=lambda p: -p.length if order_paths_from_longest else p.length)
    return nb


def _split_block(idx, block, *, length_ratio_min, min_length_mash,
                 block_group_identity, block_group_est_identity, kmer_size,
                 min_dedup_depth_split, min_dedup_depth_mash,
                 device_minhash=False, device_wfa=False,
                 device="cuda") -> list[Block]:
    if not ((block_group_identity > 0 or block_group_est_identity > 0)
            and len(block.path_ranges) > 1):
        return [block]

    # exact dedup fwd + revcomp (reference: src/breaks.cpp:332-364)
    dedup_seqs: list[str] = []
    dedup_orig_ranks: list[list[int]] = []
    seen_map: dict[str, int] = {}
    for rank, pr in enumerate(block.path_ranges):
        seq = idx.range_seq(pr.pid, pr.begin, pr.end)
        j = seen_map.get(seq)
        if j is None:
            j = seen_map.get(revcomp(seq))
        if j is not None:
            dedup_orig_ranks[j].append(rank)
        else:
            seen_map[seq] = len(dedup_seqs)
            dedup_seqs.append(seq)
            dedup_orig_ranks.append([rank])

    if min_dedup_depth_split == 0 or len(dedup_seqs) < min_dedup_depth_split:
        return [block]

    # sort by (length, lex) so similar sequences are adjacent
    order = sorted(range(len(dedup_seqs)), key=lambda i: (len(dedup_seqs[i]), dedup_seqs[i]))
    seqs = [dedup_seqs[i] for i in order]
    orig_of = [dedup_orig_ranks[i] for i in order]

    mash_enabled = (min_length_mash > 0
                    and (min_dedup_depth_mash == 0 or len(seqs) >= min_dedup_depth_mash))
    dmat = None
    if device_minhash and mash_enabled:
        # device route: ALL pairwise mash distances in one batched pass
        # on the run's device (uint32 hash space, k clamped to 16 — see
        # ops/minhash_cuda); the greedy clusterer below then reads the
        # matrix, so its decisions are deterministic regardless of
        # iteration order
        el = np.array([len(s) >= min_length_mash for s in seqs])
        if int(el.sum()) >= 2:
            from ..ops.minhash_cuda import DeviceMinHash
            dmat = DeviceMinHash(k=min(16, kmer_size),
                                 device=device).distance_matrix(seqs, el)
    hashes = [kmer_hashes(s, kmer_size)
              if (dmat is None and mash_enabled
                  and len(s) >= min_length_mash)
              else None for s in seqs]

    def _wfa_branch(i, o):
        """True when comparing seqs[i] vs seqs[o] uses the alignment
        identity rather than mash (same predicate as the loop below)."""
        return not (mash_enabled and len(seqs[i]) >= min_length_mash
                    and len(seqs[o]) >= min_length_mash)

    ident_fwd: dict = {}
    ident_rev: dict = {}
    if device_wfa and block_group_identity > 0:
        # device route: every alignment-identity the greedy loop below
        # could consult, batched as one banded counts-carrying DP pass on
        # the run's device (ops/ident_cuda) — fwd and revcomp
        # orientations; per-pair score bound = len(curr), the host
        # route's max_score
        from ..ops.ident_cuda import DeviceBandedIdentity
        need = [(i, o) for i in range(1, len(seqs)) for o in range(i)
                if _wfa_branch(i, o)
                and len(seqs[o]) / len(seqs[i]) >= length_ratio_min]
        if need:
            dev = DeviceBandedIdentity(device=device)
            pf = [(seqs[i], seqs[o]) for i, o in need]
            prv = [(revcomp(seqs[i]), seqs[o]) for i, o in need]
            mscores = [len(seqs[i]) for i, _ in need] * 2
            vals = dev.identities(pf + prv, max_score=mscores)
            for t, (i, o) in enumerate(need):
                ident_fwd[(i, o)] = vals[t]
                ident_rev[(i, o)] = vals[len(need) + t]

    groups: list[list[int]] = [[0]]
    one_minus_id = 1.0 - block_group_identity
    for i in range(1, len(seqs)):
        curr_fwd = seqs[i]
        curr_len = len(curr_fwd)
        found = False
        best_group = 0
        for curr in (curr_fwd, revcomp(curr_fwd)):
            fwd_pass = curr is curr_fwd
            for j in range(len(groups) - 1, -1, -1):
                for k in range(len(groups[j]) - 1, -1, -1):
                    o = groups[j][k]
                    other = seqs[o]
                    ratio = len(other) / curr_len
                    if ratio < length_ratio_min:
                        break
                    if (mash_enabled and curr_len >= min_length_mash
                            and len(other) >= min_length_mash):
                        if not fwd_pass:
                            continue  # mash is strand-canonical already
                        if dmat is not None:
                            d = dmat[i, o]
                        else:
                            d = mash_distance(hashes[i], hashes[o],
                                              kmer_size)
                        if 1.0 - d >= block_group_est_identity:
                            best_group, found = j, True
                            break
                    elif ident_fwd or ident_rev:
                        gid = (ident_fwd if fwd_pass else ident_rev).get(
                            (i, o), 0.0)
                        if gid >= block_group_identity > 0:
                            best_group, found = j, True
                            break
                    else:
                        max_score = curr_len
                        score, cigar = wfa_align(curr, other, max_score=max_score)
                        if score is not None and score < max_score:
                            gid = gap_compressed_identity(cigar)
                            if gid >= block_group_identity:
                                best_group, found = j, True
                                break
                if found:
                    break
            if found:
                break
        if found:
            groups[best_group].append(i)
        else:
            groups.append([i])

    if len(groups) == 1:
        return [block]
    out = []
    for grp in groups:
        nb = Block()
        for gi in grp:
            for orank in orig_of[gi]:
                nb.path_ranges.append(block.path_ranges[orank])
        out.append(nb)
    return out
