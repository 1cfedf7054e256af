"""The benchmark's frozen copies give what the port's own originals give
today: the pangenome generator's bytes and the fill's operation counts."""
import numpy as np
import pytest

import chip_smoke
from port_bench import fillops, synth
from smoothxg_tpu_torch.testing import synth as port_synth


@pytest.mark.parametrize("kw", [
    dict(haplotypes=5, length=3000, seed=3),
    dict(haplotypes=90, length=20_000, seed=2**31 + 77),
    dict(haplotypes=16, length=8000, snv_rate=0.02, indel_rate=0.003,
         sv_count=2, seed=20261016)])
def test_generator_bytes(kw):
    assert synth.make_pangenome(**kw) == port_synth.make_pangenome(**kw)


def test_fill_arithmetic():
    assert fillops.OPS_CELL == chip_smoke.OPS_CELL
    assert fillops.OPS_PRED == chip_smoke.OPS_PRED
    rng = np.random.default_rng(5)
    for _ in range(20):
        cells, pcells = (int(x) for x in rng.integers(0, 10**9, 2))
        for local in (True, False):
            assert fillops.fill_ops(cells, pcells, local) == \
                chip_smoke.fill_ops(cells, pcells, local)


@pytest.mark.parametrize("seed", [1, 2])
def test_block_work_counts_what_win_dp_work_counts(seed):
    """Unpadded, a POA graph's MSA gives the cells and predecessor cells
    that chip_smoke's count gives from the graph's own paths."""
    from smoothxg_tpu_torch.ops import poa_host
    from smoothxg_tpu_torch.ops.poa_graph import POAGraph
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, 80)
    seqs = []
    for _ in range(5):
        s = base.copy()
        hit = rng.random(len(s)) < 0.08
        s[hit] = rng.integers(0, 4, int(hit.sum()))
        seqs.append(np.frombuffer(b"ACGT", np.uint8)[np.delete(
            s, rng.integers(0, len(s), 2))])
    g, p = POAGraph(), poa_host.POAParams()
    g.add_sequence(seqs[0], 1)
    for s in seqs[1:]:
        g.add_alignment(poa_host.align(g, s, p), s, 1)
    rows = [np.asarray(r, np.uint8) for r in g.msa_rows(False)]
    assert fillops.block_work(rows, 0, banded=False) == \
        chip_smoke.win_dp_work(seqs, g.seq_paths)


def test_block_work_from_the_msa():
    """An MSA's rows give each round's graph: row 2 is aligned against the
    5 nodes of rows 0-1 (column 2 holds two bases) with one node fed by two
    rows past the first; no padding."""
    rows = [np.frombuffer(t, np.uint8) for t in (b"ACGT", b"ACTT", b"A-GT")]
    cells, pcells = fillops.block_work(rows, 0, banded=False)
    # round 1: 4 nodes x 5 columns; round 2: 5 nodes x 4 columns
    assert cells == 4 * 5 + 5 * 4
    # node (3, T) has two predecessors from round 2 on
    assert pcells == 1 * 4
    assert fillops.block_work(rows, 311, banded=True)[0] > 0
