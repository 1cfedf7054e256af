"""The port's stacked POA module (smoothxg_tpu_torch/ops/poa_stacked.py)
against the Pallas kernel it replaces (ops/poa_pallas_stacked.
_compiled_stacked, interpret mode, K = 2 blocks per grid step) and the
numpy oracle FusedPOA, at 4 predecessor slots; the engine's
kernel="stacked" tiers; and the refusal of windowed tiers.  (The engine
against FusedPallasEngine(kernel="stacked") is in
test_torch_stacked_engine.py.)  Inputs are seeded with numpy; tolerance:
none, all outputs are integers.  Helpers as in test_torch_poa_code.py."""
import functools

import numpy as np
import pytest
import torch

from smoothxg_tpu.ops.poa_host import POAParams
from smoothxg_tpu.ops.poa_pallas_stacked import _compiled_stacked
from smoothxg_tpu_torch.ops.poa_code import CodeCaps, poa_code_reference
from smoothxg_tpu_torch.ops.poa_engine import TorchPOAEngine
from smoothxg_tpu_torch.ops.poa_host import POAParams as PortParams
from smoothxg_tpu_torch.ops.poa_stacked import (from_stacked_layout,
                                                poa_stacked,
                                                poa_stacked_reference,
                                                stacked_caps,
                                                to_stacked_layout)
from smoothxg_tpu_torch.ops.poa_win import WinCaps, pack_blocks
from smoothxg_tpu_torch.testing.synth import make_block, make_fan_in_block

from test_poa_pallas_win import family
from test_torch_poa_code import LW, RW, VARIANTS, VW, pack_fused, unpack
from test_torch_poa_win import P_DEF, _oracle as _block_oracle

K = 2


@functools.lru_cache(maxsize=None)
def _pallas_run(local, wb):
    rng = np.random.default_rng(200 + 2 * int(local) + (wb >= 0))
    blocks = [family(rng, int(rng.integers(30, 110)), int(rng.integers(2, 5)))
              for _ in range(K)]
    p = POAParams(*P_DEF, local=local, wb=wb, wf_milli=30)
    planes = pack_fused(blocks, [p] * K)
    pal = _compiled_stacked(K, VW, LW, RW, local, True, 1,
                            banded=wb >= 0)(*planes)
    ins = from_stacked_layout(*planes, K, LW, RW)
    port = poa_stacked_reference(*ins, stacked_caps(VW, LW, local, wb >= 0))
    return blocks, p, tuple(np.asarray(x) for x in pal), \
        to_stacked_layout(*port, VW, LW, RW)


@pytest.mark.parametrize("local,wb", VARIANTS)
@pytest.mark.parametrize("b", range(K))
def test_plain_version_matches_pallas_and_oracle(local, wb, b):
    blocks, p, pal, port = _pallas_run(local, wb)
    got = unpack(port, b, blocks[b])
    assert got[0][1] == 0, "unexpected overflow"
    assert got == unpack(pal, b, blocks[b])
    assert got == _block_oracle(blocks[b], p)


@pytest.mark.parametrize("local,wb", VARIANTS)
def test_plain_version_is_poa_code_at_4_slots(local, wb):
    """The 16-bit code chase equals the 32-bit one at pcap 4, overflow
    (a 5th predecessor) included."""
    rng = np.random.default_rng(61 + int(local) + 2 * (wb >= 0))
    p = POAParams(*P_DEF, local=local, wb=wb, wf_milli=30)
    blocks = [make_block(rng, int(rng.integers(40, 160)),
                         int(rng.integers(2, 6)), 0.05) for _ in range(3)]
    blocks += [make_fan_in_block(rng, 4, 30), make_fan_in_block(rng, 5, 30)]
    ins = pack_blocks([(sq, p) for sq in blocks], LW)
    got = poa_stacked_reference(*ins, stacked_caps(1024, LW, local, wb >= 0))
    want = poa_code_reference(*ins, CodeCaps(1024, LW, local, wb >= 0,
                                             pcap=4))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0][:, 1].tolist() == [0] * 4 + [1]


def test_default_tiers_are_the_full_width_ones():
    eng = TorchPOAEngine(device="cpu", kernel="stacked")
    assert eng.kernel == "stacked"
    assert eng.tiers == tuple(t for t in TorchPOAEngine.TIERS if t[1] == t[2])
    assert len(eng.tiers) == 4


def test_windowed_tier_or_caps_raise():
    with pytest.raises(ValueError):
        TorchPOAEngine(device="cpu", kernel="stacked",
                       tiers=((512, 256, 256), (1024, 768, 384)))
    ins = pack_blocks([(make_block(np.random.default_rng(1), 50, 2, 0.05),
                        PortParams())], 256)
    with pytest.raises(ValueError):
        poa_stacked(*ins, WinCaps(512, 256, 128, False, True, pcap=4))
    with pytest.raises(ValueError):
        poa_stacked(*ins, CodeCaps(512, 256, True, False))       # pcap 8


def test_cpu_tensors_run_the_plain_version_without_a_launch():
    rng = np.random.default_rng(4)
    ins = pack_blocks([(make_block(rng, 60, 3, 0.05), PortParams())], LW)
    caps = stacked_caps(VW, LW, True, False)
    before = poa_stacked.launches
    a = poa_stacked(*ins, caps)
    b = poa_stacked_reference(*ins, caps)
    assert poa_stacked.launches == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_stacked_layout_needs_whole_grid_steps():
    rng = np.random.default_rng(2)
    planes = pack_fused([family(rng, 40, 2)] * 3, [POAParams(*P_DEF)] * 3)
    with pytest.raises(ValueError):
        from_stacked_layout(*planes, 2, LW, RW)
    seqs, slen, nseq, _ = from_stacked_layout(*planes, 3, LW, RW)
    assert nseq.tolist() == [2, 2, 2] and slen[0, 0] == 40
