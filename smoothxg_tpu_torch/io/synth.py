"""Synthetic divergent pangenome fixtures (the port's copy of
smoothxg_tpu/io/synth.py, numpy only).

A graph whose haplotypes are near-identical (the DRB1 graph, or the port's
seeded generator, testing/synth.py) never exercises the identity splitting
machinery in the break stage (exact dedup -> mash / WFA
gap-compressed-identity clustering; reference: src/breaks.cpp:325-575).
This module manufactures a *divergent* variation graph from a real one by
tiling it and injecting haplogroup bubbles: per tile, a random subset of
nodes gains a mutated alt allele and each path is assigned to a haplogroup
that consistently takes either the original or the alt allele (with a
little per-step noise), modelling two diverged haplotype families sharing
one backbone.

Per-tile substitution rates span `sub_range`, so pairwise within-block
identities span roughly 1-node_frac*sub_hi .. 1-node_frac*sub_lo —
pick ranges so blocks straddle the -I threshold and greedy clustering
(reference: src/breaks.cpp:407-521) genuinely splits groups.  Alt
alleles occasionally carry a small indel so the WFA gap-compressed
identity path (not just mash) is exercised.

Output graphs are valid variation graphs: every path sequence is
well-defined and the smoothing pipeline's byte-exact path validation
applies unchanged.
"""
from __future__ import annotations

import numpy as np

_BASES = "ACGT"


def _mutate(seq: str, p_sub: float, rng: np.random.Generator,
            p_indel: float = 0.2) -> str:
    """Substitute bases at rate p_sub; with prob p_indel apply one small
    (1-3 bp) insertion or deletion so gap-compressed identity differs
    from raw identity."""
    out = list(seq)
    hits = np.flatnonzero(rng.random(len(out)) < p_sub)
    for i in hits:
        cur = out[i]
        repl = _BASES[int(rng.integers(0, 3))]
        out[i] = repl if repl != cur else _BASES[(_BASES.index(cur) + 1) % 4]
    if len(out) > 6 and rng.random() < p_indel:
        k = int(rng.integers(1, 4))
        pos = int(rng.integers(1, len(out) - k))
        if rng.random() < 0.5:
            del out[pos:pos + k]
        else:
            ins = "".join(_BASES[j] for j in rng.integers(0, 4, k))
            out.insert(pos, ins)
    return "".join(out)


def make_divergent_gfa(src: str, dst: str, tiles: int = 2, *,
                       seed: int = 0,
                       node_frac: float = 0.5,
                       sub_range: tuple[float, float] = (0.02, 0.12),
                       p_reroute_noise: float = 0.05) -> None:
    """Write a `tiles`-copy divergent version of GFA `src` to `dst`.

    Each tile is an id-offset copy of the source graph in which
    ~node_frac of the nodes gain a mutated alt allele; each path in the
    tile is assigned haplogroup 0 (original alleles) or 1 (alt alleles),
    flipped per-step with prob p_reroute_noise.  Tile t's substitution
    rate interpolates across sub_range, so different tiles diverge by
    different amounts.  Edges are the original links (per id offset)
    plus every path-implied adjacency of the alt alleles.
    """
    nodes: dict[int, str] = {}
    links: list[tuple[int, str, int, str]] = []
    paths: list[tuple[str, list[tuple[int, str]]]] = []
    for line in open(src):
        f = line.rstrip("\n").split("\t")
        if f[0] == "S":
            nodes[int(f[1])] = f[2]
        elif f[0] == "L":
            links.append((int(f[1]), f[2], int(f[3]), f[4]))
        elif f[0] == "P":
            steps = [(int(s[:-1]), s[-1]) for s in f[2].split(",")]
            paths.append((f[1], steps))
    if not nodes or not paths:
        raise ValueError(f"no S/P records in {src}")
    maxid = max(nodes)
    rng = np.random.default_rng(seed)
    span = maxid + 1
    next_alt = tiles * span + 1          # alt ids above all tile copies

    with open(dst, "w") as out:
        out.write("H\tVN:Z:1.0\n")
        for t in range(tiles):
            off = t * span
            frac = t / max(1, tiles - 1)
            p_sub = sub_range[0] + (sub_range[1] - sub_range[0]) * frac
            # alt alleles for a random node subset
            alt: dict[int, int] = {}
            for nid, seq in nodes.items():
                if rng.random() < node_frac:
                    alt[nid] = next_alt
                    out.write(f"S\t{next_alt}\t"
                              f"{_mutate(seq, p_sub, rng)}\n")
                    next_alt += 1
            for nid, seq in nodes.items():
                out.write(f"S\t{nid + off}\t{seq}\n")
            for a, ao, b, bo in links:
                out.write(f"L\t{a + off}\t{ao}\t{b + off}\t{bo}\t0M\n")
            edge_seen: set[tuple[int, str, int, str]] = set()
            for name, steps in paths:
                group = int(rng.random() < 0.5)
                walked: list[tuple[int, str]] = []
                for nid, o in steps:
                    take_alt = (group == 1) ^ (rng.random()
                                               < p_reroute_noise)
                    if take_alt and nid in alt:
                        walked.append((alt[nid], o))
                    else:
                        walked.append((nid + off, o))
                out.write(f"P\t{name}_tile{t}\t"
                          + ",".join(f"{n}{o}" for n, o in walked)
                          + "\t*\n")
                for (a, ao), (b, bo) in zip(walked, walked[1:]):
                    if a > tiles * span or b > tiles * span:
                        e = (a, ao, b, bo)
                        if e not in edge_seen:
                            edge_seen.add(e)
                            out.write(f"L\t{a}\t{ao}\t{b}\t{bo}\t0M\n")
