"""The comparison that decides `correct`: what each smoothing job wrote,
judged against its input.

* The lace layer: every input path is spelled, base for base, by the path
  of the same name in the output GFA, and the output holds as many paths
  besides its consensus paths (the reference's own self-validation,
  src/main.cpp:762-800).
* The MAF rows: each row, without its gaps, is the stretch of its path
  that the row names, and the rows of all blocks cover every base of
  every input path once (every block of the graph is smoothed and
  written).
* The POA blocks: in every block of every job one row drawn from the
  seed, the largest (block, row) pair, and rows drawn from the rest up to
  MIN_PICKS (`sample_pairs`).  Row i of a block is a sequence that the POA aligned
  to the graph of the rows before it (the rows are in the order the POA
  took them: longest first, duplicates once).  That graph is rebuilt from
  the MAF, and `poa.fill` gives the best local score of row i against it
  and the best score of an alignment that agrees with the one the MAF
  shows.  The gap between the two is what the POA gave away; a sound POA
  gives away nothing but what the padding it aligned, and the MAF leaves
  out, hides.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from . import poa
from .seqs import read_gfa_paths, read_maf, row_source

GAP = ord("-")
# DP cells (node rows x sequence columns, over a batch's problems) a fill
# holds at once: H, E1, E2 in int32, ~18 GB; the traceback's host copy
# holds float32 planes of four
CELL_BUDGET = 1_500_000_000
KEEP_BUDGET = 400_000_000
MIN_PICKS = 128


def path_faults(in_paths: dict[str, bytes], out_gfa: str,
                consensus_prefix: str) -> int:
    """Input paths missing from the output or spelled differently there,
    plus the difference in the count of non-consensus paths."""
    out = read_gfa_paths(out_gfa)
    bad = sum(out.get(name) != seq for name, seq in in_paths.items())
    n_out = sum(not k.startswith(consensus_prefix) for k in out)
    return bad + abs(n_out - len(in_paths))


def cover_faults(in_paths: dict[str, bytes], maf_blocks) -> int:
    """Input path bases that the MAF's rows cover other than once."""
    cover = {k: np.zeros(len(v) + 1, np.int32) for k, v in in_paths.items()}
    for rows in maf_blocks:
        for r in rows:
            c = cover.get(r.src)
            if c is None:
                continue
            start = r.src_len - r.start - r.size if r.rev else r.start
            c[start] += 1
            c[start + r.size] -= 1
    return sum(int((np.cumsum(c)[:-1] != 1).sum()) for c in cover.values())


def block_rows(rows, consensus_prefix: str) -> tuple[list, int, list]:
    """(the unique rows of a block in the POA's order, as uint8 arrays;
    the padding the POA gave its sequences; the sizes of every range).
    The padding is smoothxg's rule (src/smooth.cpp:1919-1943) at its
    defaults -O 0.001, -Y 1000."""
    reads = [r for r in rows if not r.src.startswith(consensus_prefix)]
    sizes = [r.size for r in reads]
    order = sorted(range(len(reads)), key=lambda k: -reads[k].size)
    seen, uniq = set(), []
    for k in order:
        t = reads[k].text
        if t not in seen:
            seen.add(t)
            uniq.append(np.frombuffer(t, np.uint8))
    avg = sum(sizes) / max(len(sizes), 1)
    pad = max(int(avg * 0.001), 311 if len(sizes) <= 1000 else 0)
    return uniq, pad, sizes


def problem(uniq: list, i: int) -> tuple[poa.Problem, np.ndarray]:
    """Row i against the graph of rows 0..i-1 (nodes are (column, base)
    pairs, edges consecutive bases of a row), and the anchors of its bases:
    the column the MAF aligns each to, or -1 where it inserts it."""
    prev = np.stack(uniq[:i])
    C = prev.shape[1]
    occ = prev != GAP
    key = (np.arange(C)[None, :] * 256 + prev)
    keys = np.unique(key[occ])
    src, dst = [], []
    for r in range(i):
        ids = np.searchsorted(keys, key[r][occ[r]])
        src.append(ids[:-1])
        dst.append(ids[1:])
    N = len(keys)
    edges = np.unique(np.concatenate(dst) * N + np.concatenate(src)) \
        if src else np.zeros(0, np.int64)
    preds: list[list[int]] = [[] for _ in range(N)]
    for v, u in zip((edges // N).tolist(), (edges % N).tolist()):
        preds[v].append(u)
    t = uniq[i]
    pos = np.flatnonzero(t != GAP)
    has = np.zeros(C, bool)
    has[keys // 256] = True
    return (poa.Problem(keys // 256, (keys % 256).astype(np.uint8), preds,
                        t[pos].copy()), np.where(has[pos], pos, -1))


def sample_pairs(blocks: list, rng: np.random.Generator,
                 least: int = MIN_PICKS) -> list:
    """(job, block, row) picks: in every block of every job with two rows
    or more one row past the first, drawn from rng; the pair with the
    largest DP of all; and rows drawn from the rest until `least` are
    judged (every row, where there are fewer)."""
    rows = [(a, b, i) for a, blks in enumerate(blocks)
            for b, uniq in enumerate(blks) for i in range(1, len(uniq))]
    if not rows:
        return []
    picks = {(a, b, int(rng.integers(1, len(uniq))))
             for a, blks in enumerate(blocks)
             for b, uniq in enumerate(blks) if len(uniq) > 1}
    picks.add(max(rows, key=lambda r: r[2] * len(blocks[r[0]][r[1]][r[2]])))
    rest = [r for r in rows if r not in picks]
    more = rng.choice(len(rest), size=min(max(least - len(picks), 0),
                                          len(rest)), replace=False)
    return sorted(picks | {rest[k] for k in more.tolist()})


def _batches(blocks: list, picks: list, budget: int):
    """The picks' free problems and anchors, in batches of at most
    `budget` DP cells, each of blocks of like width (a fill takes as many
    steps as its widest block has columns)."""
    order = sorted(range(len(picks)),
                   key=lambda k: -blocks[picks[k][0]][picks[k][1]][0].size)
    batch, rmax, lmax = [], 0, 0
    for k in order:
        a, b, i = picks[k]
        free, anchor = problem(blocks[a][b], i)
        r, ln = len(free.col) + 3, len(free.seq) + 1
        if batch and (len(batch) + 1) * max(rmax, r) * max(lmax, ln) \
                > budget:
            yield batch
            batch, rmax, lmax = [], 0, 0
        batch.append((k, free, anchor))
        rmax, lmax = max(rmax, r), max(lmax, ln)
    if batch:
        yield batch


def poa_gaps(blocks: list, picks: list, device,
             budget: int = CELL_BUDGET) -> list:
    """For each pick, best local score minus the best score that agrees
    with the MAF's alignment."""
    gaps = [None] * len(picks)
    for batch in _batches(blocks, picks, budget // 2):
        probs = [f for _, f, _ in batch] + \
            [replace(f, anchor=anc) for _, f, anc in batch]
        sc = poa.fill(probs, device)
        for n, (k, _, _) in enumerate(batch):
            gaps[k] = sc[n] - sc[n + len(batch)]
    return gaps


def judge(jobs: list, consensus_prefix: str, seed: int, device) -> dict:
    """Readings of the jobs (each a dict with `in_paths`, `out_gfa`,
    `out_maf` and `error`): the faults of paths, MAF rows and the rows'
    cover of the paths, the widest
    POA gap of the sampled picks, how many were judged, each pick's job
    and gap (`gaps`), and the jobs whose paths or rows are wrong
    (`bad_jobs`)."""
    paths_bad = rows_bad = cover_bad = 0
    bad_jobs, blocks = [], []
    for a, job in enumerate(jobs):
        if job.get("error"):
            blocks.append([])
            continue
        pbad = path_faults(job["in_paths"], job["out_gfa"],
                           consensus_prefix)
        rbad = 0
        blks = []
        maf = read_maf(job["out_maf"])
        cbad = cover_faults(job["in_paths"], maf)
        for rows in maf:
            for r in rows:
                if r.src.startswith(consensus_prefix):
                    continue
                if row_source(r, job["in_paths"]) != \
                        r.text.replace(b"-", b""):
                    rbad += 1
            blks.append(block_rows(rows, consensus_prefix)[0])
        paths_bad += pbad
        rows_bad += rbad
        cover_bad += cbad
        blocks.append(blks)
        if pbad or rbad or cbad:
            bad_jobs.append(a)
    s = int(seed) % (1 << 64)
    rng = np.random.default_rng([s & 0xFFFFFFFF, s >> 32, 7])
    picks = sample_pairs(blocks, rng)
    gaps = poa_gaps(blocks, picks, device)
    return {"paths_bad": paths_bad, "maf_rows_bad": rows_bad,
            "maf_cover_bad": cover_bad, "poa_gap_max": max(gaps) if gaps else None,
            "poa_pairs": len(gaps),
            "gaps": [(a, gp) for (a, _, _), gp in zip(picks, gaps)],
            "bad_jobs": bad_jobs}


def control_gaps(blocks: list, picks: list, device,
                 dtype=torch.float16, budget: int = KEEP_BUDGET) -> list:
    """The control: for each pick, the gap of the alignment that a fill
    in `dtype` puts first (traced back through its own rounding, then
    scored exactly)."""
    gaps = [None] * len(picks)
    for batch in _batches(blocks, picks, budget):
        free = [f for _, f, _ in batch]
        best = poa.fill(free, device)
        _, store, lay = poa.fill(free, device, dtype=dtype, keep=True)
        held = [replace(p, anchor=poa.traceback(p, store, lay, n))
                for n, p in enumerate(free)]
        del store
        for n, h in enumerate(poa.fill(held, device)):
            gaps[batch[n][0]] = best[n] - h
    return gaps
