"""The port's POA kernel module (smoothxg_tpu_torch/ops/poa_win.py) against
the Pallas kernel it replaces (ops/poa_pallas_win._win_fn, interpret mode)
and the numpy oracle (ops/poa_fused.FusedPOA): the same packed input planes
go through both, the port's through from_win_layout / to_win_layout, and
meta, base, ring, order, paths and guard_splits must be equal.  Tolerance:
none, all integers.  Where the Pallas kernel overflows for its 128-lane
window quantum alone, the port is held to the oracle only."""
import functools

import numpy as np
import pytest
import torch

from smoothxg_tpu.ops.poa_fused import FusedPOA
from smoothxg_tpu.ops.poa_host import POAParams
from smoothxg_tpu.ops.poa_pallas_win import _win_fn
from smoothxg_tpu_torch.ops.poa_win import (WinCaps, from_win_layout, poa_win,
                                            poa_win_reference, to_win_layout)

from test_poa_jax import CASES
from test_poa_pallas_win import codes, family

P_DEF = (1, 4, 6, 2, 26, 1)


def _pack(blocks, params, K, LW, W, RW):
    """The Pallas kernel's input planes, as FusedPallasEngine._launch packs
    them (char j of sequence r at flat position j+1)."""
    total = max(1, -(-len(blocks) // K)) * K
    SL, FW = LW // 128, W // 128
    nseq = np.ones((total, 1, 1), np.int32)
    par = np.zeros((total, 1, 8), np.int32)
    slen = np.zeros((total, 1, 128), np.int16)
    slen[:, 0, 0] = 1
    seqs = np.full((total, RW * SL + FW, 128), -1, np.int8)
    seqs[:, 0, 1] = 0
    for b, (sq, p) in enumerate(zip(blocks, params)):
        nseq[b, 0, 0] = len(sq)
        par[b, 0] = [p.m, p.n, p.g, p.e, p.q, p.c, max(p.wb, 0), p.wf_milli]
        for r, s in enumerate(sq):
            slen[b, 0, r] = len(s)
            flat = np.full(SL * 128, -1, np.int8)
            flat[1:len(s) + 1] = s
            seqs[b, r * SL:(r + 1) * SL] = flat.reshape(SL, 128)
    return nseq, par, slen, seqs


def _unpack(win, b, sq, VW, LW, RW):
    meta, exp, paths = win
    N = meta.shape[0]
    exp = np.asarray(exp).astype(np.int32).reshape(N, 3, VW)
    paths = np.asarray(paths).astype(np.int32).reshape(N, RW, LW)
    V = int(meta[b, 0])
    return (list(map(int, meta[b])), exp[b, 0, :V].tolist(),
            exp[b, 1, :V].tolist(), exp[b, 2, :V].tolist(),
            [paths[b, r, :len(s)].tolist() for r, s in enumerate(sq)])


def _oracle(sq, p):
    f = FusedPOA()
    for s in sq:
        f.add_sequence(np.asarray(s, np.int8), p)
    return ([f.n_nodes(), 0, len(sq), f.guard_splits], f.base, f.ring,
            f.topo_order(), f.paths)


def _run(blocks, params, K, VW, LW, W, RW, local, banded):
    """(pallas, port) outputs in _win_fn's layout for the same planes."""
    planes = _pack(blocks, params, K, LW, W, RW)
    B = planes[0].shape[0] // K
    pal = _win_fn(K, VW, LW, W, RW, local, True, B, banded)(*planes)
    pal = tuple(np.asarray(x) for x in pal)
    ins = from_win_layout(*planes, K, LW, W, RW)
    out = poa_win(*ins, WinCaps(VW, LW, W, local, banded))
    return pal, to_win_layout(*out, VW, LW, RW)


def _check_block(res, b, sq, p, VW, LW, RW):
    pal, port = res
    got = _unpack(port, b, sq, VW, LW, RW)
    assert got[0][1] == 0, "unexpected port overflow"
    assert got == _oracle(sq, p)
    ref = _unpack(pal, b, sq, VW, LW, RW)
    if ref[0][1] == 0:
        assert got == ref
    return got


@functools.lru_cache(maxsize=None)
def _fullwidth(local):
    blocks = [[codes(s) for s in c] for c in CASES]
    p = POAParams(*P_DEF, local=local)
    return blocks, p, _run(blocks, [p] * len(blocks), 1, 512, 256, 256, 16,
                           local, False)


@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_fullwidth_matches_pallas_and_oracle(case, local):
    blocks, p, res = _fullwidth(local)
    _check_block(res, case, blocks[case], p, 512, 256, 16)


@pytest.mark.parametrize("local", [True, False])
def test_stacked_k2_input_matches(local):
    rng = np.random.default_rng(5)
    blocks = [family(rng, 90, 4), family(rng, 70, 5), family(rng, 50, 3)]
    p = POAParams(*P_DEF, local=local)
    res = _run(blocks, [p] * 3, 2, 512, 256, 256, 16, local, False)
    for b, sq in enumerate(blocks):
        _check_block(res, b, sq, p, 512, 256, 16)


def test_adaptive_param_extremes_match():
    """Per-block penalty params (the adaptive tier extremes) in one K=2
    dispatch."""
    rng = np.random.default_rng(7)
    blocks = [family(rng, 120, 4), family(rng, 100, 4)]
    params = [POAParams(1, 19, 39, 3, 81, 1, local=False),
              POAParams(1, 4, 6, 2, 26, 1, local=False)]
    res = _run(blocks, params, 2, 512, 256, 256, 16, False, False)
    for b, (sq, p) in enumerate(zip(blocks, params)):
        _check_block(res, b, sq, p, 512, 256, 16)


@pytest.mark.parametrize("reason,caps,n", [
    ("node capacity", WinCaps(100, 256, 256, True, False), 6),
    ("pred slots", WinCaps(512, 256, 256, True, False, pcap=1), 6),
    ("sequence capacity", WinCaps(512, 64, 64, True, False), 3),
])
def test_capacity_overflow_is_flagged(reason, caps, n):
    rng = np.random.default_rng(17)
    sq = family(rng, 90, n)
    planes = _pack([sq], [POAParams(*P_DEF)], 1, 256, 256, 8)
    seqs, slen, nseq, par = from_win_layout(*planes, 1, 256, 256, 8)
    seqs = seqs[:, :, :caps.LW].contiguous()
    meta, exp, paths = poa_win(seqs, slen, nseq, par, caps)
    assert meta[0].tolist() == [0, 1, n, 0], reason
    assert (exp == -1).all() and (paths == -1).all()


def test_layout_roundtrip():
    rng = np.random.default_rng(2)
    blocks = [family(rng, 60, 3), family(rng, 40, 2)]
    planes = _pack(blocks, [POAParams(*P_DEF)] * 2, 2, 256, 256, 4)
    seqs, slen, nseq, par = from_win_layout(*planes, 2, 256, 256, 4)
    assert nseq.tolist() == [3, 2]
    for b, sq in enumerate(blocks):
        for r, s in enumerate(sq):
            assert slen[b, r] == len(s)
            assert seqs[b, r, :len(s)].tolist() == s.tolist()
    assert par[0].tolist() == [1, 4, 6, 2, 26, 1, 0, 30]
    meta = torch.tensor([[3, 0, 3, 0], [2, 0, 2, 0]], dtype=torch.int32)
    exp = torch.arange(2 * 3 * 256, dtype=torch.int32).reshape(2, 3, 256)
    paths = torch.zeros((2, 4, 256), dtype=torch.int32)
    m2, e2, p2 = to_win_layout(meta, exp, paths, 256, 256, 4)
    assert e2.shape == (2, 6, 128) and e2.dtype == np.int16
    assert p2.shape == (2, 8, 128)
    assert e2.reshape(2, 3, 256)[1, 2, 5] == exp[1, 2, 5]


def test_cpu_tensors_run_the_plain_version_without_a_launch():
    rng = np.random.default_rng(4)
    sq = family(rng, 50, 3)
    planes = _pack([sq], [POAParams(*P_DEF)], 1, 256, 256, 4)
    ins = from_win_layout(*planes, 1, 256, 256, 4)
    caps = WinCaps(512, 256, 256, True, False)
    before = poa_win.launches
    a = poa_win(*ins, caps)
    b = poa_win_reference(*ins, caps)
    assert poa_win.launches == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        poa_win(ins[0].to(torch.int16), *ins[1:], caps)
    with pytest.raises(ValueError):
        poa_win(*ins, WinCaps(512, 128, 128, True, False))
