"""Finalize's block graph on the flat route (graphcore.cpp
gc_block_unchop through native_bindings.block_unchop, and its numpy twin
pipeline/smooth._block_arrays without the native library) held to the JAX
package's `_finalize_block` on the same `_BlockState`: the unchopped graph's
arrays with its edges in order, path names, mappings, groom flip and MAF
rows; and the `flat N/M` count of the smoothing line on a small run."""
import contextlib
import io
import re
from types import SimpleNamespace

import numpy as np
import pytest

from smoothxg_tpu import native_bindings as jax_native
from smoothxg_tpu.pipeline import smooth as jax_smooth
from smoothxg_tpu_torch import native_bindings
from smoothxg_tpu_torch.ops.poa_fused import rehydrate
from smoothxg_tpu_torch.ops.poa_graph import POAGraph
from smoothxg_tpu_torch.ops.poa_host import POAParams
from smoothxg_tpu_torch.ops.poa_native import NativePOAEngine, poa_block
from smoothxg_tpu_torch.pipeline import smooth
from smoothxg_tpu_torch.pipeline.blocks import PathRange
from smoothxg_tpu_torch.pipeline.run import Config, run_smoothing
from smoothxg_tpu_torch.testing.synth import write_pangenome
from smoothxg_tpu_torch.utils import spans
from smoothxg_tpu_torch.utils.dna import encode_seq

FLAT_RE = re.compile(r"(\d+) blocks: engine .* flat (\d+)/(\d+)")


def _mutate(rng, s: str) -> str:
    out = []
    for c in s:
        r = rng.random()
        if r < 0.03:
            out.append("ACGT"[rng.integers(4)])
        elif r < 0.05:
            continue
        elif r < 0.07:
            out += [c, "ACGT"[rng.integers(4)]]
        else:
            out.append(c)
    return "".join(out)


def _block(seed, n_seqs, length, pad, dups=(), rev=(), abpoa=False,
           bid=0):
    """A block of `n_seqs` unique sequences around one random founder, the
    first range of each unique rank in `rev` reversed; `dups` adds ranges
    (unique rank, reversed) after them.  Returns (idx stand-in, state)."""
    rng = np.random.default_rng(seed)
    founder = "".join(rng.choice(list("ACGT"), length))
    useqs = [founder] + [_mutate(rng, founder) for _ in range(n_seqs - 1)]
    occ = [(u, u in rev) for u in range(n_seqs)] + list(dups)
    ranges = [PathRange(pid=i, begin=0, end=1, length=length)
              for i in range(len(occ))]
    st = smooth._BlockState(bid, ranges, padding=pad, abpoa_mode=abpoa,
                            params=POAParams(local=not abpoa,
                                             wb=311 if abpoa else -1))
    st.useqs = useqs
    st.weights = [sum(1 for u, _ in occ if u == k) for k in range(n_seqs)]
    st.dup_is_rev = [[] for _ in useqs]
    st.dup_names = [[] for _ in useqs]
    st.dup_range_idx = [[] for _ in useqs]
    for ri, (u, rev) in enumerate(occ):
        name = f"p{ri}_{10 * ri}"
        st.names_in_order.append(name)
        st.range_is_rev.append(rev)
        st.dup_is_rev[u].append(rev)
        st.dup_names[u].append(name)
        st.dup_range_idx[u].append(ri)
    enc = [encode_seq(s) for s in useqs]
    base, ring, order, flat, off = poa_block(enc, st.params)
    st.graph = rehydrate(base, ring, [int(v) for v in order],
                         [flat[off[i]:off[i + 1]] for i in range(len(enc))],
                         st.weights)
    plen = [len(useqs[u]) for u, _ in occ]
    idx = SimpleNamespace(
        path_pos=[np.array([10 * ri, 10 * ri + plen[ri] - 2 * pad])
                  for ri in range(len(occ))],
        path_len=[10 * ri + plen[ri] + 50 for ri in range(len(occ))],
        get_path_name=lambda pid: f"path{pid}")
    return idx, st


def _pangenome_states(tmp):
    """Every block state of a seeded multi-block pangenome, as the port's
    native -t 1 run hands them to _finalize_block."""
    gfa = write_pangenome(str(tmp / "in.gfa"), haplotypes=6, length=4000,
                          seed=11)
    seen = []
    orig = smooth._finalize_block

    def keep(idx, st, *args):
        seen.append((idx, st))
        return orig(idx, st, *args)

    cfg = Config(gfa_in=gfa, smoothed_out=str(tmp / "out.gfa"), n_haps=6,
                 poa_length_targets=[700], add_consensus=True,
                 engine="native", threads=1, tmp_base=str(tmp))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(smooth, "_finalize_block", keep)
        with contextlib.redirect_stderr(io.StringIO()):
            run_smoothing(cfg, device="cpu")
    return seen


def _cases(case, tmp):
    """(blocks, add_consensus) of a case: [(idx, state)]."""
    if case == "pangenome":
        return _pangenome_states(tmp), True
    kw, cons = {
        "spoa-consensus-pad0": (dict(seed=1, n_seqs=5, length=300, pad=0),
                                True),
        "spoa-consensus-pad": (dict(seed=2, n_seqs=6, length=300, pad=17),
                               True),
        "spoa-no-consensus": (dict(seed=3, n_seqs=5, length=250, pad=9),
                              False),
        "abpoa-consensus-filtered": (
            dict(seed=4, n_seqs=6, length=300, pad=23, abpoa=True), True),
        "reverse-duplicates": (
            dict(seed=5, n_seqs=5, length=200, pad=5, rev=(3, 4),
                 dups=[(0, True), (2, True), (1, False), (4, True)]), True),
        "one-sequence": (dict(seed=6, n_seqs=1, length=120, pad=4), True),
        "all-trimmed": (dict(seed=7, n_seqs=3, length=20, pad=15), False),
    }[case]
    return [_block(**kw)], cons


@pytest.mark.parametrize("case", [
    "spoa-consensus-pad0", "spoa-consensus-pad", "spoa-no-consensus",
    "abpoa-consensus-filtered", "reverse-duplicates", "one-sequence",
    "all-trimmed", "empty-graph", "pangenome", "fallback"])
def test_flat_route_matches_reference(case, tmp_path, monkeypatch):
    route = "flat"
    if case == "empty-graph":
        idx, st = _block(seed=8, n_seqs=2, length=50, pad=0)
        st.graph = POAGraph()
        blocks, cons = [(idx, st)], True
        route = None
    elif case == "fallback":
        blocks = [_block(seed=9, n_seqs=5, length=300, pad=11,
                         dups=[(1, True)]),
                  _block(seed=10, n_seqs=4, length=200, pad=13, abpoa=True)]
        cons = True
        route = "fallback"
    else:
        blocks, cons = _cases(case, tmp_path)
    if case == "pangenome":
        assert len(blocks) > 4
    if route == "fallback":
        # both packages without their native library: the Python unchop
        monkeypatch.setattr(native_bindings, "load", lambda: None)
        monkeypatch.setattr(jax_native, "load", lambda: None)
    reordered = 0
    for idx, st in blocks:
        if route == "flat":
            reordered += _check_arrays(st, cons)
        got = smooth._finalize_block(idx, st, cons, "cons@", True)
        want = jax_smooth._finalize_block(idx, st, cons, "cons@", True)
        assert got.route == route
        _same(got, want)
    if case == "pangenome":
        # the order of the edges handed to the unchop shows in its output
        assert reordered > 0


def _check_arrays(st, cons) -> int:
    """The native arrays before the unchop equal the numpy ones; returns
    1 when the unchop returns its edges in another order for the same
    edges in another (seeded) order."""
    args = smooth._block_args(st, st.graph, st.graph.consensus_path()
                              if cons else [], cons)
    native = native_bindings.block_unchop(*args, do_unchop=False,
                                          do_toposort=False)
    for a, b in zip(native, smooth._block_arrays(*args)):
        np.testing.assert_array_equal(a, b)
    seq, off, edges, poff, steps = native
    shuffled = np.random.default_rng(0).permutation(edges.reshape(-1, 2))
    a = native_bindings.unchop_arrays(seq, off, edges, poff, steps)
    b = native_bindings.unchop_arrays(seq, off, shuffled.ravel(), poff, steps)
    for x, y in zip(a, b):
        assert len(x) == len(y)
    return int(not np.array_equal(a[2], b[2]))


def _same(got, want):
    assert got.block_id == want.block_id
    assert got.path_mappings == want.path_mappings
    assert got.consensus_name == want.consensus_name
    assert got.groom_flip == want.groom_flip
    assert {k: [vars(r) for r in v] for k, v in (got.maf or {}).items()} == \
        {k: [vars(r) for r in v] for k, v in (want.maf or {}).items()}
    if want.graph is None:
        assert got.graph is None
        return
    assert got.graph.path_names == want.graph.path_names
    for a, b in zip(got.graph.to_arrays(), want.graph.to_arrays()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("native", [True, False], ids=["flat", "fallback"])
def test_flat_count(native, tmp_path, monkeypatch):
    """The smoothing line's `flat N/M` and the finalize.unchop spans'
    values count every block on the route the library allows."""
    if not native:
        monkeypatch.setattr(native_bindings, "load", lambda: None)
    gfa = write_pangenome(str(tmp_path / "in.gfa"), haplotypes=4,
                          length=3000, seed=5)
    cfg = Config(gfa_in=gfa, smoothed_out=str(tmp_path / "out.gfa"),
                 n_haps=4, poa_length_targets=[700], add_consensus=True,
                 engine="native", threads=1, tmp_base=str(tmp_path))
    err = io.StringIO()
    spans.take()
    spans.enable()
    try:
        with contextlib.redirect_stderr(err):
            run_smoothing(cfg, device="cpu", engine=NativePOAEngine())
        recs = spans.take()
    finally:
        spans.disable()
    lines = FLAT_RE.findall(err.getvalue())
    assert lines
    values = [r.attrs for r in recs if r.name == "finalize.unchop"]
    for blocks, flat, total in lines:
        assert int(total) == int(blocks) > 0
        assert int(flat) == (int(blocks) if native else 0)
    n = sum(int(b) for b, _, _ in lines)
    assert values.count("flat") == (n if native else 0)
    assert values.count("fallback") == (0 if native else n)
