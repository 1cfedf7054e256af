"""Partial order alignment graph: incremental construction, heaviest-bundle
consensus, and MSA column extraction.

Equivalent capability to spoa::Graph (reference usage:
src/smooth.cpp:736-770 — AddAlignment with per-sequence weights,
GenerateConsensus, GenerateMultipleSequenceAlignment) and to the abPOA graph
(reference: src/smooth.cpp:2414-2546), re-implemented from the published POA
algorithm (Lee, Grasso & Sharlow 2002) for this framework.

Nodes carry a byte base and an "aligned group" id; nodes in the same group
represent alternative bases at the same alignment column.  Edges carry
accumulated sequence weights.  Sequences are stored as explicit node paths,
which is what the block-graph conversion needs (reference:
build_odgi_SPOA, src/smooth.cpp:2548-2609).
"""
from __future__ import annotations

import numpy as np


class POAGraph:
    # guard-split events recorded by the fused engines that produced this
    # graph (0 for the spoa-faithful add_alignment path below; see
    # ops/poa_fused.py docstring and PARITY.md)
    guard_splits = 0
    # seq_paths as one array: (offsets int64[n + 1], node ids int64), set
    # by ops/poa_fused.rehydrate for pipeline/smooth.py's block graph;
    # None where the paths were grown here, or have grown since
    flat_paths = None

    def __init__(self) -> None:
        self.base: list[int] = []           # byte code per node
        self.preds: list[list[int]] = []
        self.succs: list[list[int]] = []
        self.edge_w: dict[tuple[int, int], int] = {}
        self.group: list[int] = []          # aligned-group id per node
        self.group_members: list[list[int]] = []
        self.seq_paths: list[list[int]] = []
        self.seq_weights: list[int] = []
        self._topo: list[int] | None = None

    # ---- structure ----
    def n_nodes(self) -> int:
        return len(self.base)

    def _new_node(self, base: int, group: int | None = None) -> int:
        v = len(self.base)
        self.base.append(base)
        self.preds.append([])
        self.succs.append([])
        if group is None:
            group = len(self.group_members)
            self.group_members.append([])
        self.group.append(group)
        self.group_members[group].append(v)
        self._topo = None
        return v

    def _add_edge(self, u: int, v: int, w: int) -> None:
        key = (u, v)
        if key in self.edge_w:
            self.edge_w[key] += w
        else:
            self.edge_w[key] = w
            self.succs[u].append(v)
            self.preds[v].append(u)
            self._topo = None

    def topo_order(self) -> list[int]:
        """Deterministic Kahn order (by node creation id)."""
        if self._topo is not None:
            return self._topo
        n = len(self.base)
        indeg = [len(p) for p in self.preds]
        import heapq
        heap = [v for v in range(n) if indeg[v] == 0]
        heapq.heapify(heap)
        order = []
        while heap:
            v = heapq.heappop(heap)
            order.append(v)
            for s in self.succs[v]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    heapq.heappush(heap, s)
        if len(order) != n:
            raise RuntimeError("POA graph has a cycle")
        self._topo = order
        return order

    # ---- sequence addition ----
    def add_sequence(self, seq: np.ndarray, weight: int) -> None:
        """Add the first (or an unaligned) sequence as a fresh chain
        (batched appends — this is a hot path for block seeding)."""
        self.flat_paths = None
        L = len(seq)
        if L == 0:
            self.seq_paths.append([])
            self.seq_weights.append(weight)
            return
        v0 = len(self.base)
        g0 = len(self.group_members)
        codes = seq.tolist() if hasattr(seq, "tolist") else [int(b) for b in seq]
        self.base.extend(int(b) for b in codes)
        self.preds.extend([v0 + i - 1] if i else [] for i in range(L))
        self.succs.extend([v0 + i + 1] if i < L - 1 else [] for i in range(L))
        self.group.extend(range(g0, g0 + L))
        self.group_members.extend([v0 + i] for i in range(L))
        ew = self.edge_w
        for i in range(L - 1):
            ew[(v0 + i, v0 + i + 1)] = weight
        self.seq_paths.append(list(range(v0, v0 + L)))
        self.seq_weights.append(weight)
        self._topo = None

    def add_alignment(self, aln: list[tuple[int | None, int | None]],
                      seq: np.ndarray, weight: int) -> None:
        """Thread `seq` through the graph along `aln`, a list of
        (node_id | None, seq_pos | None) pairs covering a (possibly partial)
        span of seq positions in increasing order.  Unaligned prefix/suffix
        positions get fresh nodes, mirroring spoa::Graph::AddAlignment."""
        self.flat_paths = None
        L = len(seq)
        target: dict[int, int | None] = {}   # seq_pos -> node id or None
        for node, pos in aln:
            if pos is not None:
                target[pos] = node
        path: list[int] = []
        prev = None
        for j in range(L):
            b = int(seq[j])
            v = None
            t = target.get(j, None)
            if t is not None:
                if self.base[t] == b:
                    v = t
                else:
                    for m in self.group_members[self.group[t]]:
                        if self.base[m] == b:
                            v = m
                            break
                    if v is None:
                        v = self._new_node(b, self.group[t])
            else:
                v = self._new_node(b)
            if prev is not None:
                self._add_edge(prev, v, weight)
            path.append(v)
            prev = v
        self.seq_paths.append(path)
        self.seq_weights.append(weight)

    # ---- consensus (heaviest bundle) ----
    def consensus_path(self) -> list[int]:
        """Heaviest-bundle traversal: per node pick the incoming edge with
        max (edge weight, pred score); extend from the best-scoring node to a
        sink via heaviest out-edges (spoa GenerateConsensus semantics)."""
        if not self.base:
            return []
        order = self.topo_order()
        score = {v: 0 for v in order}
        pred = {v: -1 for v in order}
        for v in order:
            best_w, best_s, best_p = -1, -1, -1
            for p in self.preds[v]:
                w = self.edge_w[(p, v)]
                if (w, score[p]) > (best_w, best_s):
                    best_w, best_s, best_p = w, score[p], p
            if best_p >= 0:
                pred[v] = best_p
                score[v] = best_s + best_w
        best = max(order, key=lambda v: (score[v], -v))
        path = [best]
        while pred[path[-1]] >= 0:
            path.append(pred[path[-1]])
        path.reverse()
        # extend to a sink along heaviest out-edges
        cur = path[-1]
        while self.succs[cur]:
            cur = max(self.succs[cur],
                      key=lambda s: (self.edge_w[(cur, s)], score[s], -s))
            path.append(cur)
        return path

    # ---- MSA ----
    def msa_columns(self) -> tuple[dict[int, int], int]:
        """Assign one MSA column per aligned group, ordered topologically over
        the group-contracted DAG (spoa MSA rank semantics).
        Returns (node -> column, n_columns)."""
        import heapq
        groups = [g for g, ms in enumerate(self.group_members) if ms]
        gsucc: dict[int, set[int]] = {g: set() for g in groups}
        gindeg: dict[int, int] = {g: 0 for g in groups}
        for (u, v) in self.edge_w:
            gu, gv = self.group[u], self.group[v]
            if gu != gv and gv not in gsucc[gu]:
                gsucc[gu].add(gv)
                gindeg[gv] += 1
        heap = [g for g in groups if gindeg[g] == 0]
        heapq.heapify(heap)
        gcol: dict[int, int] = {}
        col = 0
        # deterministic Kahn over the group-contracted DAG
        while heap:
            g = heapq.heappop(heap)
            gcol[g] = col
            col += 1
            for s in gsucc[g]:
                gindeg[s] -= 1
                if gindeg[s] == 0:
                    heapq.heappush(heap, s)
        if col != len(groups):
            # extremely unlikely contracted cycle; fall back to first-member order
            for g in groups:
                if g not in gcol:
                    gcol[g] = col
                    col += 1
        node_col = {v: gcol[self.group[v]] for v in range(len(self.base))}
        return node_col, col

    def msa_rows(self, include_consensus: bool, gap: int = ord("-")):
        """Return per-sequence MSA rows as uint8 arrays (+ consensus last when
        requested), matching spoa GenerateMultipleSequenceAlignment."""
        node_col, width = self.msa_columns()
        rows = []
        for path in self.seq_paths:
            row = np.full(width, gap, dtype=np.uint8)
            for v in path:
                row[node_col[v]] = self.base[v]
            rows.append(row)
        if include_consensus:
            row = np.full(width, gap, dtype=np.uint8)
            for v in self.consensus_path():
                row[node_col[v]] = self.base[v]
            rows.append(row)
        return rows
