"""The comparison that decides `correct`: the path and row checks reject a
changed base, and the plain POA fill gives the port's host aligner's
scores."""
import os

import numpy as np
import pytest
import torch

from port_bench.reference import judge, poa, seqs
from port_bench.synth import make_pangenome


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """A tiny pangenome smoothed by the port's C++ engine at -l 4000."""
    from smoothxg_tpu_torch.cli import main
    d = str(tmp_path_factory.mktemp("job"))
    gfa = os.path.join(d, "in.gfa")
    with open(gfa, "w") as f:
        f.write(make_pangenome(haplotypes=4, length=6000, indel_rate=0.002,
                               sv_count=1, seed=11))
    out, maf = os.path.join(d, "out.gfa"), os.path.join(d, "out.maf")
    assert main(["-g", gfa, "-o", out, "-m", maf, "-r", "4", "-j", "5k",
                 "-e", "5k", "-l", "4000", "-t", "1", "--engine",
                 "native", "-b", d]) == 0
    return {"in_paths": seqs.read_gfa_paths(gfa), "out_gfa": out,
            "out_maf": maf, "error": None, "dir": d}


def test_sound_job_reads_clean(job):
    r = judge.judge([job], "Consensus_", 5, "cpu")
    assert (r["paths_bad"], r["maf_rows_bad"], r["bad_jobs"]) == (0, 0, [])
    assert r["poa_pairs"] > 0 and r["poa_gap_max"] == 0


def test_every_block_of_every_job_is_judged(job):
    """A pick in each block with two rows or more, of each job, and the
    largest pair besides; the gaps do not depend on how the fills are
    batched."""
    blocks = [[judge.block_rows(r, "Consensus_")[0]
               for r in seqs.read_maf(job["out_maf"])]] * 2
    picks = judge.sample_pairs(blocks, np.random.default_rng(3), least=0)
    want = {(a, b) for a, blks in enumerate(blocks)
            for b, uniq in enumerate(blks) if len(uniq) > 1}
    assert want and {(a, b) for a, b, _ in picks} == want
    assert all(1 <= i < len(blocks[a][b]) for a, b, i in picks)
    size = max(i * len(blocks[a][b][i]) for a, blks in enumerate(blocks)
               for b, uniq in enumerate(blks) for i in range(1, len(uniq)))
    assert max(i * len(blocks[a][b][i]) for a, b, i in picks) == size
    one = judge.poa_gaps(blocks, picks, "cpu", budget=1)
    assert one == judge.poa_gaps(blocks, picks, "cpu")
    assert len(one) == len(picks) and max(one) == 0
    rows = sum(len(u) - 1 for blks in blocks for u in blks)
    more = judge.sample_pairs(blocks, np.random.default_rng(3), least=9)
    assert len(more) == min(max(9, len(picks)), rows)
    assert len(set(more)) == len(more)
    assert len(judge.sample_pairs(blocks, np.random.default_rng(3),
                                  least=10**6)) == rows


def test_path_check_rejects_one_changed_base(job):
    text = open(job["out_gfa"]).read().split("\n")
    step = next(ln for ln in text if ln.startswith("P\thap0\t")) \
        .split("\t")[2].split(",")[0][:-1]
    k = next(i for i, ln in enumerate(text)
             if ln.startswith(f"S\t{step}\t"))
    f = text[k].split("\t")
    f[2] = ("C" if f[2][0] != "C" else "G") + f[2][1:]
    text[k] = "\t".join(f)
    bad = os.path.join(job["dir"], "bad.gfa")
    open(bad, "w").write("\n".join(text))
    assert judge.path_faults(job["in_paths"], bad, "Consensus_") >= 1
    assert judge.path_faults(job["in_paths"], job["out_gfa"],
                             "Consensus_") == 0


def test_row_check_rejects_one_changed_base(job):
    text = open(job["out_maf"]).read()
    k = text.index("\ns hap") + 1
    k = text.index("\n", k) - 10
    c = text[k]
    bad = os.path.join(job["dir"], "bad.maf")
    open(bad, "w").write(text[:k] + ("A" if c != "A" else "C") + text[k + 1:])
    r = judge.judge([dict(job, out_maf=bad)], "Consensus_", 5, "cpu")
    assert r["maf_rows_bad"] == 1 and r["bad_jobs"] == [0]


def _host_graph(rng, n, L):
    """A POA graph of n random relatives by the port's host aligner, and a
    further relative to align."""
    from smoothxg_tpu_torch.ops import poa_host
    from smoothxg_tpu_torch.ops.poa_graph import POAGraph
    p = poa_host.POAParams()
    base = rng.integers(0, 4, L)

    def relative():
        s = base.copy()
        hit = rng.random(L) < 0.08
        s[hit] = rng.integers(0, 4, int(hit.sum()))
        s = np.delete(s, rng.integers(0, L, 2))
        return np.frombuffer(b"ACGT", np.uint8)[s]
    g = POAGraph()
    g.add_sequence(relative(), 1)
    for _ in range(n - 1):
        s = relative()
        g.add_alignment(poa_host.align(g, s, p), s, 1)
    return g, relative(), p


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fill_gives_the_host_aligners_best_score(seed):
    from smoothxg_tpu_torch.ops import poa_host
    rng = np.random.default_rng(seed)
    g, q, p = _host_graph(rng, 4, 60)
    H = poa_host.fill(g, q, p)[0]
    rows = g.msa_rows(include_consensus=False)
    # the graph as its MSA shows it, and q against it
    uniq = [np.asarray(r, np.uint8) for r in rows]
    probe = np.full(len(uniq[0]), ord("-"), np.uint8)
    prob, _ = judge.problem(uniq + [probe], len(uniq))
    prob = poa.Problem(prob.col, prob.base, prob.preds, q)
    assert poa.fill([prob], "cpu")[0] == int(H.max())


@pytest.mark.parametrize("seed", [4, 5])
def test_anchored_score_of_the_optimal_alignment_is_the_best(seed):
    """Traced back from an exact fill, the alignment's anchored score is
    the best score; a shifted alignment scores less."""
    rng = np.random.default_rng(seed)
    g, q, _ = _host_graph(rng, 3, 50)
    uniq = [np.asarray(r, np.uint8) for r in g.msa_rows(False)]
    probe = np.full(len(uniq[0]), ord("-"), np.uint8)
    free, _ = judge.problem(uniq + [probe], len(uniq))
    free = poa.Problem(free.col, free.base, free.preds, q)
    best, store, lay = poa.fill([free], "cpu", keep=True)
    anchor = poa.traceback(free, store, lay)
    held = poa.Problem(free.col, free.base, free.preds, q, anchor)
    assert poa.fill([held], "cpu")[0] == best[0]
    shifted = np.where(anchor >= 0, anchor + 1, -1)
    held2 = poa.Problem(free.col, free.base, free.preds, q, shifted)
    assert poa.fill([held2], "cpu")[0] < best[0]
    assert poa.fill([free], "cpu", dtype=torch.float16)[0] > 0
