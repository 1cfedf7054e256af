"""The sources of the whole-block kernels, csrc/poa_win.cu, poa_code.cu and
poa_stacked.cu, compiled with g++ against the CUDA emulation of
smoothxg_tpu_torch/testing/cuda_emu.h and run on the CPU (threads and
barriers stand in for the card's), against their plain PyTorch versions:
exact equality of meta, exp and paths on seeded local, global and banded
blocks (poa_win's banded rows in a window narrower than the row), a
fan-in each kernel holds and one it overflows on; for the code-chase
kernels, at the launch's row stride LS, a node past VW and rows longer
than one of poa_code's 2,048-column tiles.  poa_stacked runs on 2
emulated SMs, so its thread blocks carry several warps and a partial
last one.  (Both table placements and K = 1, 2, 8: test_torch_chase_emu.py.)"""
import numpy as np
import pytest
import torch

from smoothxg_tpu_torch.ops.poa_code import CodeCaps, poa_code_reference
from smoothxg_tpu_torch.ops.poa_host import POAParams
from smoothxg_tpu_torch.ops.poa_stacked import (poa_stacked_reference,
                                                scratch_words, stacked_caps)
from smoothxg_tpu_torch.ops.poa_win import (WinCaps, pack_blocks,
                                            poa_win_reference, row_stride)
from smoothxg_tpu_torch.testing import cuda_emu
from smoothxg_tpu_torch.testing.synth import make_block, make_fan_in_block

VARIANTS = [(True, -1), (False, -1), (False, 13), (True, 13)]
# kernel: (plain version, caps, scratch words at LS, in-degree held,
# overflowing)
KERNELS = {
    "poa_win": (poa_win_reference,
                lambda VW, LW, local, banded: WinCaps(
                    VW, LW, 3 * LW // 4 if banded else LW, local, banded),
                lambda c, LS: c.scratch_words(LS), 4, 5),
    "poa_code": (poa_code_reference, CodeCaps,
                 lambda c, LS: c.scratch_words(LS), 8, 9),
    "poa_stacked": (poa_stacked_reference, stacked_caps, scratch_words,
                    4, 5),
}
CHASE = ("poa_code", "poa_stacked")


@pytest.fixture(scope="module")
def exes(tmp_path_factory):
    d = tmp_path_factory.mktemp("emu")
    return {name: cuda_emu.build(name, str(d / name)) for name in KERNELS}


def run_emu(exes, name, ins, caps, **device):
    """The emulated kernel's (outputs, geometry) and the plain version's
    outputs on the same inputs, at the launch's row stride."""
    ref, _, words, _, _ = KERNELS[name]
    LS = row_stride(ins[1], caps.LW)
    got, geo = cuda_emu.run_geometry(exes[name], *ins, caps, words(caps, LS),
                                     LS=LS, **device)
    return got, geo, ref(*ins, caps)


def assert_equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("local,wb", VARIANTS)
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_source_matches_plain_version(exes, name, local, wb):
    _, mkcaps, _, held, over = KERNELS[name]
    rng = np.random.default_rng(31 + int(local) + 2 * (wb >= 0))
    p = POAParams(1, 4, 6, 2, 26, 1, local=local, wb=wb, wf_milli=30)
    blocks = [make_block(rng, int(rng.integers(20, 70)),
                         int(rng.integers(2, 5)), 0.06) for _ in range(2)]
    blocks += [make_fan_in_block(rng, held, 6),
               make_fan_in_block(rng, over, 6)]
    ins = pack_blocks([(sq, p) for sq in blocks], 128)
    # poa_stacked on 2 emulated SMs: 2 warps a thread block
    got, _, want = run_emu(exes, name, ins, mkcaps(256, 128, local, wb >= 0),
                           sms=2 if name == "poa_stacked" else 132)
    assert_equal(got, want)
    assert want[0][:, 1].tolist() == [0, 0, 0, 1]


@pytest.mark.parametrize("name", CHASE)
def test_chase_kernel_node_overflow_and_long_rows(exes, name):
    """A block that needs node VW + 1 overflows, its neighbour does not;
    rows of 2,301 columns take two of poa_code's 2,048-column tiles and
    spans of 72 columns in poa_stacked, local and global."""
    _, mkcaps, _, _, _ = KERNELS[name]
    rng = np.random.default_rng(91)
    p = POAParams(1, 4, 6, 2, 26, 1, local=False)
    small = [make_block(rng, 40, 3, 0.2), make_block(rng, 30, 2, 0.0)]
    ins = pack_blocks([(sq, p) for sq in small], 128)
    got, _, want = run_emu(exes, name, ins, mkcaps(44, 128, False, False))
    assert_equal(got, want)
    assert want[0][:, 1].tolist() == [1, 0]
    # a 60-base seed and a 2,300-base read that contains it: few rows,
    # each of them long
    read = make_block(rng, 2300, 1, 0.0)[0]
    long = [read[1000:1060], read]
    for local in (True, False):
        ins = pack_blocks([(long, POAParams(local=local))], 2400)
        got, _, want = run_emu(exes, name, ins,
                               mkcaps(2400, 2400, local, False))
        assert_equal(got, want)
        assert want[0][0, 1] == 0
    assert row_stride(ins[1], 2400) == 2304
