"""Consensus pangenome graph derivation.

Reimplements the reference's create_consensus_graph (reference:
src/consensus_graph.cpp:95-1030): starting from the smoothed graph and its
consensus paths, derive a standalone graph of consensus paths plus "link
paths" preserving variation above a minimum allele length:

  * optional min-coverage filter over consensus paths (:125-154),
  * node -> owning consensus path map (:167-184),
  * per non-consensus path walk emitting candidate link paths where the
    jump (min of vector-space distance and on-consensus distance) is >=
    min_allele_length or the consensus changes (:314-450),
  * canonical orientation swap (:424-429), grouping by
    (from,part,to,part) (:692-718), per-group most-frequent-hash link +
    perfect edges + novelty filters (:544-690),
  * output graph: consensus paths, novelty-trimmed link paths, path-implied
    edges, perfect edges, boundary-preserving steps (:744-998),
  * unchop -> drop 0-depth -> unchop (:1003-1018).
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field

import numpy as np

from ..graph.index import FlatIndex
from ..graph.mutable import MutableGraph
from ..utils.params import handy_parameter, split_csv
from ..utils.progress import Log

BEGIN, MIDDLE, END = ord("b"), ord("m"), ord("e")


@dataclass
class ConsensusSpec:
    basename: str = ""
    min_allele_len: int = 0
    ref_file: str = ""
    ref_file_sanitized: str = ""
    keep_consensus_paths: bool = True
    min_consensus_path_cov: float = 0.0
    max_allele_len: int = 1_000_000


def parse_consensus_spec(spec_str: str, requires_consensus: bool
                         ) -> tuple[list[ConsensusSpec], bool]:
    """reference: src/consensus_graph.cpp:36-78."""
    fields = split_csv(spec_str)
    basename = fields[0]
    specs = []
    for f in fields[1:]:
        vals = f.split(":")
        spec = ConsensusSpec(basename=basename)
        if vals and vals[0]:
            spec.min_allele_len = int(handy_parameter(vals[0], 0))
        if len(vals) > 1:
            spec.ref_file = vals[1]
            spec.ref_file_sanitized = vals[1].replace("/", "_")
        spec.keep_consensus_paths = (vals[2] == "y") if len(vals) > 2 else True
        spec.min_consensus_path_cov = handy_parameter(vals[3], 0) if len(vals) > 3 else 0
        spec.max_allele_len = int(handy_parameter(vals[4], 1e6)) if len(vals) > 4 else int(1e6)
        requires_consensus |= spec.keep_consensus_paths
        specs.append(spec)
    return specs, requires_consensus


def displayname(spec: ConsensusSpec) -> str:
    return (f"{spec.basename}@{spec.min_allele_len}"
            f"_{spec.ref_file_sanitized}"
            f"_{'y' if spec.keep_consensus_paths else 'n'}"
            f"_{spec.min_consensus_path_cov:g}"
            f"_{spec.max_allele_len}")


@dataclass
class LinkPath:
    from_cons: int
    from_part: int
    to_cons: int
    to_part: int
    length: int = 0
    jump_length: int = 0
    hash: int = 0
    pid: int = 0
    begin: int = 0          # step rank on pid
    end: int = 0
    rank: int = 0

    def group_key(self):
        return (self.from_cons, self.from_part, self.to_cons, self.to_part)

    def sort_key(self):
        return (self.from_cons, self.from_part, self.to_cons, self.to_part,
                self.length, self.jump_length, self.begin, self.end, self.pid)


def _stable_hash(s: str) -> int:
    return int.from_bytes(hashlib.blake2b(s.encode(), digest_size=8).digest(), "little")


GROUP_POOL_MIN = 2000   # fan link groups over the pool only at scale


def create_consensus_graph(
    smoothed: FlatIndex,
    consensus_path_names: list[str],
    min_allele_length: int,
    max_allele_length: int,
    min_consensus_path_coverage: float = 0.0,
    threads: int = 1,
    smoothed_gfa: str | None = None,
) -> MutableGraph:
    cons_pids = [smoothed.get_path(n) for n in consensus_path_names
                 if smoothed.has_path(n)]
    # de-dup while preserving order
    seenp = set()
    cons_pids = [p for p in cons_pids if not (p in seenp or seenp.add(p))]
    if not cons_pids:
        Log.info("consensus_graph", "WARNING: no matching paths; empty graph")
        return MutableGraph()

    if min_consensus_path_coverage:
        keep = []
        for pid in cons_pids:
            length = 0
            coverage = 0
            for r in range(smoothed.step_count(pid)):
                h = smoothed.step_handle(pid, r)
                hl = smoothed.get_length(h)
                length += hl
                coverage += length * smoothed.node_depth(h >> 1)
            mean_cov = coverage / length if length else 0
            if mean_cov > min_consensus_path_coverage:
                keep.append(pid)
        cons_pids = keep
        if not cons_pids:
            return MutableGraph()

    is_cons = set(cons_pids)

    # node -> first consensus path touching it (reference: :167-184);
    # flat array, first-wins across (ordered) consensus paths
    n_nodes = smoothed.n_nodes
    owner_arr = np.full(n_nodes + 1, -1, dtype=np.int64)
    for pid in cons_pids:
        u = np.unique(np.asarray(smoothed.path_steps[pid],
                                 dtype=np.int64) >> 1)
        u = u[owner_arr[u] < 0]
        owner_arr[u] = pid

    # per consensus path: node -> (step position, step handle) of its LAST
    # step on that node — the value the reference's per-node scan leaves
    # behind (:247-308).  Flat (C, n_nodes+1) arrays; later steps
    # overwrite earlier ones (last-wins, same as the dict fill).
    cidx = {pid: i for i, pid in enumerate(cons_pids)}
    cidx_arr = np.full(max(cons_pids) + 1, -1, dtype=np.int64)
    # compact last-step map instead of dense (C, n_nodes) matrices —
    # O(consensus steps) memory, not O(C x V) (the dense form costs
    # hundreds of MB of first-touch at 169 paths x 39k nodes): sorted
    # (cidx<<32 | node) keys with the LAST step of each path on each
    # node winning, exactly the dense fill's overwrite semantics
    key_chunks, pos_chunks, h_chunks = [], [], []
    for pid in cons_pids:
        cidx_arr[pid] = cidx[pid]
        st = np.asarray(smoothed.path_steps[pid], dtype=np.int64)
        ps = np.asarray(smoothed.path_pos[pid][:len(st)], dtype=np.int64)
        key_chunks.append((np.int64(cidx[pid]) << 32) | (st >> 1))
        pos_chunks.append(ps)
        h_chunks.append(st)
    _keys = np.concatenate(key_chunks) if key_chunks else np.zeros(0, np.int64)
    _poss = np.concatenate(pos_chunks) if pos_chunks else np.zeros(0, np.int64)
    _hs = np.concatenate(h_chunks) if h_chunks else np.zeros(0, np.int64)
    _ord = np.argsort(_keys, kind="stable")
    _keys, _poss, _hs = _keys[_ord], _poss[_ord], _hs[_ord]
    if len(_keys):
        _last = np.empty(len(_keys), dtype=bool)
        _last[:-1] = _keys[1:] != _keys[:-1]
        _last[-1] = True
        _keys, _poss, _hs = _keys[_last], _poss[_last], _hs[_last]

    def last_step_of(c_arr, node_arr):
        """Vectorized (pos, handle) of consensus path row c's last step on
        node; (-1, -1) where the path never touches the node."""
        if not len(_keys):
            mone = np.full(len(np.atleast_1d(c_arr)), -1, dtype=np.int64)
            return mone, mone.copy()
        q = (np.asarray(c_arr, dtype=np.int64) << 32) | node_arr
        i = np.minimum(np.searchsorted(_keys, q), len(_keys) - 1)
        hit = _keys[i] == q
        return (np.where(hit, _poss[i], -1), np.where(hit, _hs[i], -1))

    _plen_arr = np.zeros(max(cons_pids) + 1, dtype=np.int64)
    for pid in cons_pids:
        _plen_arr[pid] = smoothed.get_path_length(pid)

    def consensus_part_batch(cons_pid_arr, node_arr) -> np.ndarray:
        """positions of the consensus steps on these nodes ->
        begin/middle/end eighths, vectorized (reference: :247-273)."""
        cons_pid_arr = np.asarray(cons_pid_arr, dtype=np.int64)
        node_arr = np.asarray(node_arr, dtype=np.int64)
        p_, _ = last_step_of(cidx_arr[cons_pid_arr], node_arr)
        clen = _plen_arr[cons_pid_arr]
        eighth = clen // 8
        return np.where(
            p_ < 0, MIDDLE,
            np.where(p_ < eighth, BEGIN,
                     np.where(p_ < clen - eighth, MIDDLE, END)))

    def consensus_part(cons_pid: int, node_id: int) -> int:
        return int(consensus_part_batch(
            np.array([cons_pid]), np.array([node_id], dtype=np.int64))[0])

    # ---- link candidate emission (reference: :314-450) ----
    # The reference's per-step state machine collapses to per-emission
    # work: after EVERY anchored step (a step whose node has a consensus
    # owner) the running link has begin == end == that step's rank — the
    # jump-too-small branch and the emit branch both reset it — so an
    # emission at anchored index i always has begin = aranks[i-1],
    # end = aranks[i], from_cons = owner(i-1), and from_part/to_part
    # pinned (equal) to the anchor where the link was created (the
    # previous emission).  Jump values for same-owner anchor pairs
    # vectorize: jump = min(|start_in_vector - end_in_vector|,
    # consensus_distance) with consensus_distance computed from the
    # last-step arrays above (reference: :275-308, incl. its use of
    # last_h's length for the end adjustment).
    links: list[LinkPath] = []
    non_cons = [p for p in range(smoothed.path_count()) if p not in is_cons]
    voff = smoothed.node_off
    vlen = smoothed.node_len
    for pid in non_cons:
        steps_a = np.asarray(smoothed.path_steps[pid], dtype=np.int64)
        own_a = owner_arr[steps_a >> 1] if len(steps_a) else steps_a
        am = own_a >= 0
        aS = steps_a[am]
        if not len(aS):
            continue
        acur = own_a[am]
        aranks = np.nonzero(am)[0]
        anid = aS >> 1
        if len(aS) >= 2:
            hp, hc = aS[:-1], aS[1:]
            npd, ncd = (hp >> 1) - 1, (hc >> 1) - 1
            lp = vlen[npd]
            siv = voff[ncd] + (hc & 1) * vlen[ncd]
            eiv = voff[npd] + (1 - (hp & 1)) * lp
            c = cidx_arr[acur[1:]]
            sp, sh = last_step_of(c, npd + 1)
            start = np.where(sp >= 0, sp + (sh == hp) * lp, -1)
            ep, eh = last_step_of(c, ncd + 1)
            end = np.where(ep >= 0, ep + (eh == (hc ^ 1)) * lp, -1)
            cd = np.where((start >= 0) & (end >= 0),
                          np.abs(end - start), -1)
            jump_arr = np.minimum(np.abs(siv - eiv), cd)
            same = acur[:-1] == acur[1:]
            emit_idx = (np.nonzero(
                ~same | (jump_arr >= min_allele_length))[0] + 1).tolist()
        else:
            same = jump_arr = np.zeros(0, dtype=np.int64)
            emit_idx = []
        if not emit_idx:
            continue
        # batch every consensus_part lookup this path's emissions need:
        # the "part" carried into emission i is the part at the previous
        # emission's anchor (or the path's first anchor), and the
        # orientation-swap test needs part_b/part_e per emission
        ei = np.asarray(emit_idx, dtype=np.int64)
        carry_i = np.concatenate(([0], ei[:-1]))
        part_arr = consensus_part_batch(acur[carry_i], anid[carry_i])
        pb_arr = consensus_part_batch(acur[ei - 1], aS[ei - 1] >> 1)
        pe_arr = consensus_part_batch(acur[ei], aS[ei] >> 1)
        for n_e, i in enumerate(emit_idx):
            from_cons = int(acur[i - 1])
            cur = int(acur[i])
            begin = int(aranks[i - 1])
            end_r = int(aranks[i])
            jump = int(jump_arr[i - 1]) if same[i - 1] else 0
            part = int(part_arr[n_e])
            lk = LinkPath(from_cons, part, cur, part, pid=pid,
                          begin=begin, end=end_r)
            seq = smoothed.range_seq(pid, begin + 1, end_r)
            lk.length = len(seq)
            lk.jump_length = jump
            hb = int(aS[i - 1])
            he = int(aS[i])
            lk.hash = _stable_hash(
                f"{lk.from_cons}_{lk.from_part}_{hb >> 1}_"
                f"{lk.to_cons}_{lk.to_part}_{he >> 1}_"
                f"{lk.length}_{lk.jump_length}_{seq}")
            rev_b, rev_e = bool(hb & 1), bool(he & 1)
            part_b = int(pb_arr[n_e])
            part_e = int(pe_arr[n_e])
            if (rev_b and rev_e) or ((rev_b or rev_e)
                                     and (hb >> 1, part_b) > (he >> 1, part_e)):
                lk.from_cons, lk.to_cons = lk.to_cons, lk.from_cons
                lk.from_part, lk.to_part = lk.to_part, lk.from_part
            links.append(lk)

    consensus_links: list[LinkPath] = []
    perfect_edges: list[tuple[int, int]] = []

    if links:
        links.sort(key=LinkPath.sort_key)
        # group by consensus pair (reference: :692-718)
        groups: list[list[LinkPath]] = []
        for lk in links:
            if groups and groups[-1][0].group_key() == lk.group_key():
                groups[-1].append(lk)
            else:
                groups.append([lk])
        # groups are independent (group-local seen set + rank counter;
        # outputs re-sorted below), so they fan over the worker pool at
        # scale — the reference OMPs this loop
        # (src/consensus_graph.cpp:709).  Below GROUP_POOL_MIN the
        # vectorized serial pass is sub-second (8x-DRB1: 296 groups in
        # ~0.05 s) and worker startup + index shipping would dominate.
        if (threads > 1 and smoothed_gfa is not None
                and len(groups) >= GROUP_POOL_MIN):
            from ..utils.procpool import chunked, get_pool
            pool = get_pool(threads)
            futs = [pool.submit(_link_groups_chunk, smoothed_gfa, ch,
                                min_allele_length, max_allele_length)
                    for ch in chunked(groups, max(
                        1, (len(groups) + 4 * threads - 1) // (4 * threads)))]
            for f in futs:
                cl, pe = f.result()
                consensus_links.extend(cl)
                perfect_edges.extend(pe)
        else:
            seen_epoch = np.zeros(smoothed.n_nodes + 1, dtype=np.int32)
            for ep, grp in enumerate(groups, start=1):
                _compute_link_paths(smoothed, grp, min_allele_length,
                                    max_allele_length, consensus_links,
                                    perfect_edges, seen_epoch, ep)

    consensus_links.sort(key=LinkPath.sort_key)

    # ---- build the output graph (reference: :744-998) ----
    cg = MutableGraph()
    # "seen by the growing consensus graph" as an epoch array: epoch 1 =
    # seen, vectorized by _novel_stats exactly like the group-local sets
    link_seen = np.zeros(smoothed.n_nodes + 1, dtype=np.int32)

    for pid in cons_pids:
        out_pid = cg.create_path(smoothed.get_path_name(pid))
        st = np.asarray(smoothed.path_steps[pid], dtype=np.int64)
        link_seen[st >> 1] = 1
        for h in st:
            h = int(h)
            nid = h >> 1
            if not cg.has_node(nid):
                cg.create_handle(smoothed.get_sequence(h & ~1), nid)
            cg.append_step(out_pid, h)

    cons_names_by_pid = {p: smoothed.get_path_name(p) for p in cons_pids}
    for link in consensus_links:
        if link.length <= 0:
            continue
        steps = smoothed.path_steps[link.pid]
        pieces: list[tuple[int, int]] = []
        novel_bp, gap_bp = _novel_stats(smoothed, link, link_seen, 1)
        if link.length > novel_bp:
            # partially redundant: keep only the novel prefix/suffix pieces,
            # and only when one novel run dominates (reference: :869-891)
            if gap_bp > 0.95 * link.length:
                s = link.begin + 1
                while s < link.end and not link_seen[int(steps[s]) >> 1]:
                    s += 1
                if s > link.begin + 1:
                    pieces.append((link.begin, s))
                e = link.end - 1
                while e > link.begin and not link_seen[int(steps[e]) >> 1]:
                    e -= 1
                if e + 1 < link.end:
                    pieces.append((e, link.end))
        else:
            pieces.append((link.begin, link.end))
        for i, (b, e) in enumerate(pieces):
            name = (f"Link_{cons_names_by_pid.get(link.from_cons, link.from_cons)}"
                    f"_{chr(link.from_part)}"
                    f"_{cons_names_by_pid.get(link.to_cons, link.to_cons)}"
                    f"_{chr(link.to_part)}_{link.rank}_{i}")
            out_pid = cg.create_path(name)
            step_count = 0
            # interior steps of the piece, (b, e) exclusive
            # (reference: :913-934)
            if e > b + 1:
                link_seen[np.asarray(steps[b + 1:e], dtype=np.int64) >> 1] = 1
            for rr in range(b + 1, e):
                h = int(steps[rr])
                nid = h >> 1
                if not cg.has_node(nid):
                    cg.create_handle(smoothed.get_sequence(h & ~1), nid)
                cg.append_step(out_pid, h)
                step_count += 1
            if step_count == 0:
                cg.path_steps.pop()
                cg.path_names.pop()
                del cg._name2path[name]

    # path-implied edges (reference: :944-957)
    cg.create_edges_from_paths()

    # perfect edges (reference: :959-968)
    for (a, b) in perfect_edges:
        if cg.has_node(a >> 1) and cg.has_node(b >> 1):
            cg.create_edge(a, b)

    # boundary steps of every link (reference: :986-998)
    for link in consensus_links:
        steps = smoothed.path_steps[link.pid]

        def _try_edge(r1, r2):
            h1, h2 = int(steps[r1]), int(steps[r2])
            if cg.has_node(h1 >> 1) and cg.has_node(h2 >> 1):
                cg.create_edge(h1, h2)

        if link.begin + 1 <= link.end:
            _try_edge(link.begin, min(link.begin + 1, link.end))
            if link.end - 1 > link.begin:
                _try_edge(link.end - 1, link.end)

    # compact first: node deletions above leave non-dense ids, which
    # would force the first unchop onto the python fallback (the native
    # graphcore path needs dense 1..N ids); ids are renumbered by the
    # final unchop_toposort anyway
    cg = cg.compact()
    cg = cg.unchop()
    # drop 0-depth nodes, then unchop again (reference: :1010-1018)
    depth: dict[int, int] = {}
    for steps in cg.path_steps:
        for h in steps:
            depth[h >> 1] = depth.get(h >> 1, 0) + 1
    to_drop = [n for n in cg.node_ids() if depth.get(n, 0) == 0]
    if to_drop:
        for n in to_drop:
            cg.destroy_handle(n << 1)
    # the reference re-unchops after the drop (:1010-1018); the fused
    # native unchop+toposort call covers that pass and the final renumber
    cg = cg.unchop_toposort()
    Log.info("consensus_graph",
             f"final graph {cg.total_seq_len()}bp in {cg.node_count()} nodes")
    return cg


def _novel_stats(smoothed, lk, seen_epoch, epoch):
    """(novel bp, largest contiguous novel run bp) over the link's interior
    steps, one vectorized pass — the two walks of the reference's filter
    (src/consensus_graph.cpp:620-656) share the same seen set, so one
    mask serves both."""
    hs = np.asarray(smoothed.path_steps[lk.pid][lk.begin:lk.end],
                    dtype=np.int64)
    if not len(hs):
        return 0, 0
    nid = hs >> 1
    lens = smoothed.node_len[nid - 1]
    novel = seen_epoch[nid] != epoch
    x = np.where(novel, lens, 0)
    total = int(x.sum())
    if total == 0:
        return 0, 0
    # largest weighted run of consecutive novel steps: c - (running max of
    # c at non-novel positions) is the current run length at every index
    c = np.cumsum(x)
    base = np.maximum.accumulate(np.where(~novel, c, 0))
    return total, int((c - base).max())


def _compute_link_paths(smoothed, links, min_allele_length, max_allele_length,
                        consensus_links, perfect_edges,
                        seen_epoch=None, epoch=1):
    """reference: compute_link_paths, src/consensus_graph.cpp:544-690.

    seen_epoch/epoch: a shared int32 per-node scratch array — a node is
    "seen" for this group iff seen_epoch[node] == epoch.  Callers looping
    over groups pass one array and bump epoch per group (O(1) reset);
    standalone calls allocate locally."""
    hash_counts: dict[int, int] = {}
    unique: list[LinkPath] = []
    for lk in links:
        c = hash_counts.get(lk.hash, 0)
        if c == 0:
            unique.append(lk)
        hash_counts[lk.hash] = c + 1
    unique.sort(key=lambda a: (hash_counts[a.hash],) + a.sort_key(), reverse=True)
    best = unique[0]
    if seen_epoch is None:
        seen_epoch = np.zeros(smoothed.n_nodes + 1, dtype=np.int32)
    perfect_edge_count = 0

    def link_cons_end(pid: int, at_back: bool, go_rev: bool, target_pid: int):
        nonlocal perfect_edge_count
        steps = smoothed.path_steps[pid]
        if len(steps) == 0:
            return
        ch = int(steps[-1 if at_back else 0])
        nbrs = smoothed.follow_left(ch) if go_rev else smoothed.follow_right(ch)
        for n in nbrs:
            for (p, r) in smoothed.steps_on_node(n >> 1):
                if p == target_pid:
                    pair = (ch, n) if not go_rev else (n, ch)
                    perfect_edges.append(pair)
                    seen_epoch[ch >> 1] = epoch
                    seen_epoch[n >> 1] = epoch
                    perfect_edge_count += 1

    a = (best.from_cons, best.from_part)
    b = (best.to_cons, best.to_part)
    if a != b:
        # reference probes every (end, direction) combination (:608-619)
        for (path_a, path_b) in ((a[0], b[0]), (b[0], a[0])):
            for at_back in (True, False):
                for go_rev in (False, True):
                    link_cons_end(path_a, at_back, go_rev, path_b)

    for pid in {a[0], b[0]}:
        st = np.asarray(smoothed.path_steps[pid], dtype=np.int64)
        seen_epoch[st >> 1] = epoch

    def mark(lk):
        hs = np.asarray(smoothed.path_steps[lk.pid][lk.begin:lk.end],
                        dtype=np.int64)
        seen_epoch[hs >> 1] = epoch

    link_rank = 0
    diff_consensi = a != b
    links_to_add = min(max(0, 2 - perfect_edge_count), len(unique))
    for i, lk in enumerate(unique):
        steps = smoothed.path_steps[lk.pid]
        if i < links_to_add:
            if lk.length == 0:
                if diff_consensi:
                    perfect_edges.append((int(steps[lk.begin]), int(steps[lk.end])))
            else:
                lk.rank = link_rank
                link_rank += 1
                consensus_links.append(lk)
                mark(lk)
        else:
            novel_bp, gap_bp = _novel_stats(smoothed, lk, seen_epoch, epoch)
            if lk.length == 0 and diff_consensi:
                perfect_edges.append((int(steps[lk.begin]), int(steps[lk.end])))
            elif lk.length == novel_bp and (
                    (best.from_cons == best.to_cons
                     and min_allele_length <= lk.jump_length < max_allele_length
                     and (lk.length == 0
                          or (novel_bp >= min_allele_length and gap_bp == novel_bp)))
                    or (min_allele_length <= novel_bp < max_allele_length)):
                lk.rank = link_rank
                link_rank += 1
                consensus_links.append(lk)
                mark(lk)


_WORKER_IDX_CACHE: dict = {}


def _worker_index(smoothed_gfa: str):
    """Per-worker FlatIndex cache: a pool worker serving many group
    chunks of the same spec reads the smoothed GFA once.  Keyed by the
    file's path, mtime and size (ROADMAP C5): the pool outlives a run, so
    a GFA rewritten at the same path by a later run is read again."""
    st = os.stat(smoothed_gfa)
    key = (smoothed_gfa, st.st_mtime_ns, st.st_size)
    idx = _WORKER_IDX_CACHE.get(key)
    if idx is None:
        from ..graph.index import FlatIndex
        from ..io.gfa import read_gfa
        idx = FlatIndex(read_gfa(smoothed_gfa))
        _WORKER_IDX_CACHE.clear()
        _WORKER_IDX_CACHE[key] = idx
    return idx


def _link_groups_chunk(smoothed_gfa: str, groups, min_allele_length: int,
                       max_allele_length: int):
    """Worker entry: run _compute_link_paths over a chunk of link groups.
    Groups are independent (group-local seen set and rank counter), and
    per-group outputs concatenate in group order, so chunked results are
    byte-identical to the serial pass."""
    idx = _worker_index(smoothed_gfa)
    consensus_links: list[LinkPath] = []
    perfect_edges: list[tuple[int, int]] = []
    seen_epoch = np.zeros(idx.n_nodes + 1, dtype=np.int32)
    for ep, grp in enumerate(groups, start=1):
        _compute_link_paths(idx, grp, min_allele_length, max_allele_length,
                            consensus_links, perfect_edges, seen_epoch, ep)
    return consensus_links, perfect_edges


def _spec_names(spec: ConsensusSpec,
                consensus_path_names: list[str]) -> list[str]:
    names: list[str] = []
    if spec.ref_file:
        with open(spec.ref_file) as f:
            names = [ln.strip() for ln in f if ln.strip()]
    if spec.keep_consensus_paths:
        names = list(consensus_path_names) + names
    return names


def _build_one_spec(smoothed_gfa: str, spec: ConsensusSpec,
                    consensus_path_names: list[str], outdir: str) -> str:
    """Worker entry: read the smoothed GFA, build one spec's consensus
    graph, write `<displayname>.gfa` under outdir (passed explicitly —
    pool workers keep the cwd they were spawned with, not the caller's)."""
    from ..io.gfa import write_gfa
    idx = _worker_index(smoothed_gfa)
    cg = create_consensus_graph(
        idx, _spec_names(spec, consensus_path_names),
        spec.min_allele_len, spec.max_allele_len,
        spec.min_consensus_path_cov)
    outname = displayname(spec) + ".gfa"
    write_gfa(cg, os.path.join(outdir, outname))
    return outname


def build_consensus_specs(smoothed_gfa: str, specs: list[ConsensusSpec],
                          consensus_path_names: list[str],
                          threads: int = 1) -> list[str]:
    """Build every spec's consensus graph (reference: the -C loop,
    src/main.cpp:986-1034).  Specs are independent, so -t fans them over
    the worker pool (each worker re-reads the smoothed GFA — cheaper than
    pickling a FlatIndex); serial path shares one index.  Within a spec,
    the link-group stage additionally fans over the pool at scale (see
    create_consensus_graph; reference OMPs the group loop,
    src/consensus_graph.cpp:709)."""
    if threads > 1 and len(specs) > 1:
        from ..utils.procpool import get_pool
        pool = get_pool(min(threads, len(specs)))
        outdir = os.getcwd()
        futs = [pool.submit(_build_one_spec, smoothed_gfa, sp,
                            consensus_path_names, outdir) for sp in specs]
        return [f.result() for f in futs]
    from ..graph.index import FlatIndex
    from ..io.gfa import read_gfa, write_gfa
    idx = FlatIndex(read_gfa(smoothed_gfa))
    out = []
    for spec in specs:
        cg = create_consensus_graph(
            idx, _spec_names(spec, consensus_path_names),
            spec.min_allele_len, spec.max_allele_len,
            spec.min_consensus_path_cov,
            threads=threads, smoothed_gfa=smoothed_gfa)
        outname = displayname(spec) + ".gfa"
        write_gfa(cg, outname)
        out.append(outname)
    return out
