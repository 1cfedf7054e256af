"""The port's code-chase POA module (smoothxg_tpu_torch/ops/poa_code.py)
against the Pallas kernel it replaces (ops/poa_pallas_fused._compiled_fused,
interpret mode), the numpy oracle FusedPOA and poa_win's plain version at 8
predecessor slots; and the engine's `shape` option.  (The engine against
FusedPallasEngine(shape=...) is in test_torch_code_engine.py, the kernel
source itself, run on the CPU, in test_torch_kernel_emu.py.)  Inputs are
seeded with numpy; tolerance: none, all outputs are integers.  The Pallas
kernel leaves exp past V and paths past each sequence unwritten, so it is
compared inside them."""
import functools

import numpy as np
import pytest
import torch

from smoothxg_tpu.ops.poa_host import POAParams
from smoothxg_tpu.ops.poa_pallas_fused import _compiled_fused
from smoothxg_tpu_torch.ops.poa_code import (CodeCaps, from_fused_layout,
                                             poa_code, poa_code_reference,
                                             to_fused_layout)
from smoothxg_tpu_torch.ops.poa_engine import TorchPOAEngine
from smoothxg_tpu_torch.ops.poa_win import (WinCaps, pack_blocks,
                                            poa_win_reference)
from smoothxg_tpu_torch.testing.synth import make_block, make_fan_in_block

from test_poa_pallas_win import family
from test_torch_poa_win import P_DEF, _oracle as _block_oracle

VW, LW, RW = 512, 256, 8
VARIANTS = [(True, -1), (False, -1), (False, 13), (True, 13)]


def pack_fused(blocks, params, RW=RW, LW=LW):
    """`_compiled_fused`'s input arrays, as FusedPallasEngine._launch packs
    them (char j of sequence r at flat position j+1 of its LW columns)."""
    B = len(blocks)
    nseq = np.ones((B, 1, 1), np.int32)
    par = np.zeros((B, 1, 8), np.int32)
    slen = np.zeros((B, 1, 128), np.int16)
    slen[:, 0, 0] = 1
    seqs = np.full((B, RW, LW), -1, np.int8)
    seqs[:, 0, 1] = 0
    for b, (sq, p) in enumerate(zip(blocks, params)):
        nseq[b, 0, 0] = len(sq)
        par[b, 0] = [p.m, p.n, p.g, p.e, p.q, p.c, max(p.wb, 0), p.wf_milli]
        for r, s in enumerate(sq):
            slen[b, 0, r] = len(s)
            seqs[b, r, 1:len(s) + 1] = s
    return nseq, par, slen, seqs.reshape(B, RW * 8, LW // 8)


def unpack(out, b, sq, VW=VW, LW=LW, RW=RW):
    """(meta, base, ring, order, paths) of block b from the Pallas-layout
    outputs, inside V and the sequence lengths."""
    meta, exp, paths = out
    N = meta.shape[0]
    exp = np.asarray(exp).astype(np.int32).reshape(N, 3, VW)
    paths = np.asarray(paths).astype(np.int32).reshape(N, RW, LW)
    V = int(meta[b, 0])
    return (list(map(int, meta[b])), exp[b, 0, :V].tolist(),
            exp[b, 1, :V].tolist(), exp[b, 2, :V].tolist(),
            [paths[b, r, :len(s)].tolist() for r, s in enumerate(sq)])


@functools.lru_cache(maxsize=None)
def _pallas_run(local, wb):
    rng = np.random.default_rng(100 + 2 * int(local) + (wb >= 0))
    blocks = [family(rng, int(rng.integers(30, 140)), int(rng.integers(2, 7)))
              for _ in range(3)]
    p = POAParams(*P_DEF, local=local, wb=wb, wf_milli=30)
    planes = pack_fused(blocks, [p] * 3)
    pal = _compiled_fused(VW, LW, RW, local, True, 3, banded=wb >= 0)(*planes)
    ins = from_fused_layout(*planes, LW, RW)
    port = poa_code_reference(*ins, CodeCaps(VW, LW, local, wb >= 0))
    return blocks, p, tuple(np.asarray(x) for x in pal), \
        to_fused_layout(*port, VW, LW, RW)


@pytest.mark.parametrize("local,wb", VARIANTS)
@pytest.mark.parametrize("b", range(3))
def test_plain_version_matches_pallas_and_oracle(local, wb, b):
    blocks, p, pal, port = _pallas_run(local, wb)
    got = unpack(port, b, blocks[b])
    assert got[0][1] == 0, "unexpected overflow"
    assert got == unpack(pal, b, blocks[b])
    assert got == _block_oracle(blocks[b], p)


@pytest.mark.parametrize("local,wb", VARIANTS)
def test_plain_version_matches_poa_win_at_pcap_8(local, wb):
    """Code chase == value re-derivation, bit for bit, overflow flags and
    padding included (blocks with in-degree up to 8 and a 9th)."""
    rng = np.random.default_rng(7 + int(local) + 2 * (wb >= 0))
    p = POAParams(*P_DEF, local=local, wb=wb, wf_milli=30)
    blocks = [make_block(rng, int(rng.integers(40, 180)),
                         int(rng.integers(2, 7)), 0.05) for _ in range(4)]
    blocks += [make_fan_in_block(rng, 8, 30), make_fan_in_block(rng, 9, 30)]
    ins = pack_blocks([(sq, p) for sq in blocks], LW)
    got = poa_code_reference(*ins, CodeCaps(1024, LW, local, wb >= 0))
    want = poa_win_reference(*ins, WinCaps(1024, LW, LW, local, wb >= 0,
                                           pcap=8))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0][:, 1].tolist() == [0] * 5 + [1]


def test_options_are_checked():
    with pytest.raises(ValueError):
        TorchPOAEngine(device="cpu", shape=(512, 256), kernel="stacked")
    with pytest.raises(ValueError):
        TorchPOAEngine(device="cpu", shape=(512, 256),
                       tiers=((512, 256, 256),))
    with pytest.raises(ValueError):
        TorchPOAEngine(device="cpu", kernel="fused")


def test_cpu_tensors_run_the_plain_version_without_a_launch():
    rng = np.random.default_rng(4)
    ins = pack_blocks([(make_block(rng, 60, 3, 0.05), POAParams(*P_DEF))],
                      LW)
    caps = CodeCaps(VW, LW, True, False)
    before = poa_code.launches
    a = poa_code(*ins, caps)
    b = poa_code_reference(*ins, caps)
    assert poa_code.launches == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        poa_code(ins[0].to(torch.int16), *ins[1:], caps)
    with pytest.raises(ValueError):
        poa_code(*ins, CodeCaps(VW, 128, True, False))


@pytest.mark.parametrize("reason,caps,n", [
    ("node capacity", CodeCaps(100, LW, True, False), 6),
    ("sequence capacity", CodeCaps(VW, 64, True, False), 3),
])
def test_capacity_overflow_is_canonical(reason, caps, n):
    rng = np.random.default_rng(17)
    seqs, slen, nseq, par = pack_blocks([(family(rng, 90, n),
                                          POAParams(*P_DEF))], LW)
    seqs = seqs[:, :, :caps.LW].contiguous()
    meta, exp, paths = poa_code(seqs, slen, nseq, par, caps)
    assert meta[0].tolist() == [0, 1, n, 0], reason
    assert (exp == -1).all() and (paths == -1).all()


def test_layout_roundtrip():
    rng = np.random.default_rng(2)
    blocks = [family(rng, 60, 3), family(rng, 40, 2)]
    planes = pack_fused(blocks, [POAParams(*P_DEF)] * 2)
    seqs, slen, nseq, par = from_fused_layout(*planes, LW, RW)
    assert nseq.tolist() == [3, 2]
    for b, sq in enumerate(blocks):
        for r, s in enumerate(sq):
            assert slen[b, r] == len(s)
            assert seqs[b, r, :len(s)].tolist() == s.tolist()
            assert (seqs[b, r, len(s):] == -1).all()
    assert par[1].tolist() == [1, 4, 6, 2, 26, 1, 0, 30]
    with pytest.raises(ValueError):
        from_fused_layout(*planes, LW, RW + 1)
