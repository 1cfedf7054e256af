"""Seeded synthetic pangenome: a variation graph in GFA (S, L, P records)
built from a random backbone and population-shared variants, with no source
graph needed.

Variants on the backbone:
  * SNV sites at `snv_rate` per base;
  * small insertions and deletions (1-10 bp) at `indel_rate` per base;
  * `sv_count` structural variants, insertions or deletions of
    length/80 .. length/16 bp (1-5 kb at 80 kb).
Each variant is carried by k of the `haplotypes` paths, k drawn from the
neutral site-frequency spectrum P(k) ~ 1/k, k = 1..H-1, so rare alleles
dominate and every allele is on at least one path.  Node ids follow
backbone order; edges are exactly the consecutive steps of the paths.  The
same arguments give the same bytes.

`make_block` draws a single POA block (a sequence and mutated copies) for
the kernel's tests; `make_population_block` a deep one whose copies share
a few founders' variants.
"""
from __future__ import annotations

import numpy as np

_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _rand_seq(rng: np.random.Generator, n: int) -> str:
    return _ACGT[rng.integers(0, 4, n)].tobytes().decode()


def make_pangenome(haplotypes: int = 16, length: int = 80_000,
                   snv_rate: float = 0.01, indel_rate: float = 0.001,
                   sv_count: int = 4, seed: int = 0) -> str:
    """GFA text of the synthetic pangenome (paths hap0..hap{H-1})."""
    if haplotypes < 2 or length < 100:
        raise ValueError("need >= 2 haplotypes and length >= 100")
    rng = np.random.default_rng(seed)
    backbone = _rand_seq(rng, length)
    # candidate variants: (pos, ref_len, alt)
    cand = []
    for pos in np.flatnonzero(rng.random(length) < snv_rate):
        ref = backbone[pos]
        alt = "ACGT"[("ACGT".index(ref) + int(rng.integers(1, 4))) % 4]
        cand.append((int(pos), 1, alt))
    for pos in np.flatnonzero(rng.random(length) < indel_rate):
        k = int(rng.integers(1, 11))
        if rng.random() < 0.5:
            cand.append((int(pos), 0, _rand_seq(rng, k)))
        else:
            cand.append((int(pos), k, ""))
    lo, hi = max(2, length // 80), max(3, length // 16)
    for _ in range(sv_count):
        pos = int(rng.integers(1, length - hi - 1))
        k = int(rng.integers(lo, hi + 1))
        if rng.random() < 0.5:
            cand.append((pos, 0, _rand_seq(rng, k)))
        else:
            cand.append((pos, k, ""))
    cand.sort(key=lambda t: (t[0], t[1]))
    # keep non-overlapping variants with a non-empty backbone segment
    # before each one and after the last
    variants = []
    end = 0
    for pos, rlen, alt in cand:
        if pos >= end + 1 and pos + rlen <= length - 1:
            variants.append((pos, rlen, alt))
            end = pos + rlen
    H = haplotypes
    ks = np.arange(1, H)
    sfs = (1.0 / ks) / np.sum(1.0 / ks)
    carriers = []
    for _ in variants:
        k = int(rng.choice(ks, p=sfs))
        carriers.append(set(rng.choice(H, size=k, replace=False).tolist()))

    seqs: list[str] = []

    def node(s: str) -> int:
        seqs.append(s)
        return len(seqs)

    paths: list[list[int]] = [[] for _ in range(H)]
    cur = 0
    for (pos, rlen, alt), carr in zip(variants, carriers):
        seg = node(backbone[cur:pos])
        ref = node(backbone[pos:pos + rlen]) if rlen else 0
        alt_id = node(alt) if alt else 0
        for h in range(H):
            paths[h].append(seg)
            a = alt_id if h in carr else ref
            if a:
                paths[h].append(a)
        cur = pos + rlen
    last = node(backbone[cur:])
    for h in range(H):
        paths[h].append(last)
    edges = sorted({(a, b) for p in paths for a, b in zip(p, p[1:])})
    out = ["H\tVN:Z:1.0"]
    out += [f"S\t{i + 1}\t{s}" for i, s in enumerate(seqs)]
    out += [f"L\t{a}\t+\t{b}\t+\t0M" for a, b in edges]
    out += [f"P\thap{h}\t" + ",".join(f"{v}+" for v in p) + "\t*"
            for h, p in enumerate(paths)]
    return "\n".join(out) + "\n"


def make_block(rng: np.random.Generator, length: int, n: int,
               div: float) -> list:
    """One seeded POA block: a random sequence and n-1 mutated copies (SNVs
    at rate `div`, most copies with one 1-7 bp insertion and deletion), as
    uint8 ASCII arrays."""
    base = rng.integers(0, 4, length)
    out = [base]
    for _ in range(n - 1):
        s = base.copy()
        hit = rng.random(length) < div
        s[hit] = (s[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
        s = list(s)
        if rng.random() < 0.7:
            p = int(rng.integers(3, len(s) - 3))
            s[p:p] = list(rng.integers(0, 4, int(rng.integers(1, 8))))
        if rng.random() < 0.6:
            p = int(rng.integers(3, len(s) - 12))
            del s[p:p + int(rng.integers(1, 8))]
        out.append(np.asarray(s))
    return [_ACGT[np.asarray(x)] for x in out]


def make_population_block(rng: np.random.Generator, length: int, n: int,
                          div: float, founders: int = 8) -> list:
    """One seeded deep POA block shaped like a pangenome's at pggb's -r: n
    sequences, sequence r a copy of founder r mod `founders` (the draws of
    make_block(rng, length, founders, div)), each copy past the founders
    with 1 + Poisson(length * div / 4) private SNVs.  The haplotypes share
    their variants, so the graph and its in-degree grow far slower with n
    than make_block's, whose every copy carries its own indels."""
    hap = make_block(rng, length, founders, div)
    out = []
    for r in range(n):
        s = hap[r % founders].copy()
        if r >= founders:
            k = 1 + int(rng.poisson(length * div / 4))
            pos = rng.integers(0, len(s), k)
            code = np.searchsorted(_ACGT, s[pos])
            s[pos] = _ACGT[(code + rng.integers(1, 4, k)) % 4]
        out.append(s)
    return out


def make_round_task(rng: np.random.Generator, length: int, n: int,
                    div: float, params) -> tuple:
    """One seeded POA round task (graph, query, params), as the round
    engine receives it: the POA graph of the first n-1 sequences of a
    make_block family, grown by the native engine, and the n-th as the
    query."""
    from ..ops.poa_native import NativePOAEngine
    seqs = make_block(rng, length, n, div)
    graph = NativePOAEngine().poa_block_batch(
        [(seqs[:-1], [1] * (n - 1), params)])[0]
    return graph, seqs[-1], params


def make_fan_in_block(rng: np.random.Generator, width: int,
                      flank: int) -> list:
    """A POA block whose graph gets a node of in-degree `width` (at most
    15): `width` sequences that differ in one middle base (IUPAC codes past
    ACGT), between seeded flanks of `flank` bases."""
    mids = b"ACGTNRYKMSWBDHV"[:width]
    left, right = (_ACGT[rng.integers(0, 4, flank)] for _ in range(2))
    return [np.concatenate([left, np.frombuffer(bytes([x]), np.uint8),
                            right]) for x in mids]


def make_fan_in_task(rng: np.random.Generator, width: int, flank: int,
                     params) -> tuple:
    """A round task whose graph has a node of in-degree `width`: the graph
    of make_fan_in_block; the query carries the first middle base."""
    from ..ops.poa_native import NativePOAEngine
    seqs = make_fan_in_block(rng, width, flank)
    graph = NativePOAEngine().poa_block_batch(
        [(seqs, [1] * width, params)])[0]
    return graph, seqs[0].copy(), params


def write_pangenome(path: str, **kw) -> str:
    """Write make_pangenome(**kw) to `path`; returns the path."""
    with open(path, "w") as f:
        f.write(make_pangenome(**kw))
    return path
