"""The sources of the whole-block kernels, csrc/poa_win.cu, poa_code.cu and
poa_stacked.cu, compiled with g++ against the CUDA emulation of
smoothxg_tpu_torch/testing/cuda_emu.h and run on the CPU (threads and
barriers stand in for the card's), against their plain PyTorch versions:
exact equality of meta, exp and paths on seeded local, global and banded
blocks (poa_win's banded rows in a window narrower than the row), a
fan-in each kernel holds and one it overflows on.  The stacked kernel is
built with 2 SMs in place of 132, so its thread blocks carry several warps
and a partial last one."""
import numpy as np
import pytest
import torch

from smoothxg_tpu_torch.ops.poa_code import CodeCaps, poa_code_reference
from smoothxg_tpu_torch.ops.poa_host import POAParams
from smoothxg_tpu_torch.ops.poa_stacked import (poa_stacked_reference,
                                                scratch_words, stacked_caps)
from smoothxg_tpu_torch.ops.poa_win import (WinCaps, pack_blocks,
                                            poa_win_reference)
from smoothxg_tpu_torch.testing import cuda_emu
from smoothxg_tpu_torch.testing.synth import make_block, make_fan_in_block

VARIANTS = [(True, -1), (False, -1), (False, 13), (True, 13)]
# kernel: (plain version, caps, scratch words, in-degree held, overflowing)
KERNELS = {
    "poa_win": (poa_win_reference,
                lambda VW, LW, local, banded: WinCaps(
                    VW, LW, 3 * LW // 4 if banded else LW, local, banded),
                lambda c: c.scratch_words(), 4, 5),
    "poa_code": (poa_code_reference, CodeCaps,
                 lambda c: c.scratch_words(), 8, 9),
    "poa_stacked": (poa_stacked_reference, stacked_caps, scratch_words,
                    4, 5),
}


@pytest.fixture(scope="module")
def exes(tmp_path_factory):
    d = tmp_path_factory.mktemp("emu")
    return {"poa_win": cuda_emu.build("poa_win", str(d / "win")),
            "poa_code": cuda_emu.build("poa_code", str(d / "code")),
            "poa_stacked": cuda_emu.build("poa_stacked", str(d / "stk"),
                                          sms=2)}


@pytest.mark.parametrize("local,wb", VARIANTS)
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_source_matches_plain_version(exes, name, local, wb):
    ref, mkcaps, words, held, over = KERNELS[name]
    rng = np.random.default_rng(31 + int(local) + 2 * (wb >= 0))
    p = POAParams(1, 4, 6, 2, 26, 1, local=local, wb=wb, wf_milli=30)
    blocks = [make_block(rng, int(rng.integers(20, 70)),
                         int(rng.integers(2, 5)), 0.06) for _ in range(2)]
    blocks += [make_fan_in_block(rng, held, 6),
               make_fan_in_block(rng, over, 6)]
    ins = pack_blocks([(sq, p) for sq in blocks], 128)
    caps = mkcaps(256, 128, local, wb >= 0)
    got = cuda_emu.run(exes[name], *ins, caps, words(caps))
    want = ref(*ins, caps)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert want[0][:, 1].tolist() == [0, 0, 0, 1]
