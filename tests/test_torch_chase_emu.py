"""The whole-block kernel sources that choose a launch geometry,
csrc/poa_code.cu, poa_stacked.cu and poa_win.cu, on the CPU emulation of
the CUDA runtime (testing/cuda_emu.h) against their plain PyTorch
versions, exact equality of meta, exp and paths, in every launch geometry
they choose: graph tables in shared memory (VW 256) and in device memory
(VW 8704, where they do not fit the 227 KB a block may use), and for
poa_stacked K = 1, 2 and 8 POA blocks a thread block (the emulated
device's SM count set to 132, 2 and 1).  Full-width rows are at the
launch's row stride LS, below LW = 256 and with L + 1 ragged against 32
and a lane's span (poa_win's banded rows keep their window of 192
columns); local, global and banded; the last block of each launch
overflows its predecessor slots (a 5th or 9th).  Inputs are seeded with
numpy."""
import numpy as np
import pytest

from smoothxg_tpu_torch.ops.poa_host import POAParams
from smoothxg_tpu_torch.ops.poa_win import pack_blocks, row_stride
from smoothxg_tpu_torch.testing import cuda_emu
from smoothxg_tpu_torch.testing.synth import make_block, make_fan_in_block

from test_torch_kernel_emu import CHASE, KERNELS, assert_equal, run_emu


@pytest.fixture(scope="module")
def exes(tmp_path_factory):
    d = tmp_path_factory.mktemp("chase")
    return {name: cuda_emu.build(name, str(d / name))
            for name in (*CHASE, "poa_win")}


# (kernel, VW, emulated SMs, blocks, expected per_block, tables)
GEOMETRIES = [
    ("poa_stacked", 256, 132, 3, 1, "shared"),
    ("poa_stacked", 256, 2, 4, 2, "shared"),
    ("poa_stacked", 256, 1, 8, 8, "shared"),
    ("poa_stacked", 8704, 132, 3, 1, "device"),
    ("poa_stacked", 8704, 1, 8, 8, "device"),
    ("poa_code", 256, 132, 3, 1, "shared"),
    ("poa_code", 8704, 132, 3, 1, "device"),
    ("poa_win", 256, 132, 3, 1, "shared"),
    ("poa_win", 8704, 132, 3, 1, "device"),
]


@pytest.mark.parametrize("local,wb", [(True, -1), (False, -1), (False, 9)])
@pytest.mark.parametrize("name,VW,sms,nb,per_block,tables", GEOMETRIES)
def test_chase_kernel_geometry_matches_plain_version(exes, name, VW, sms,
                                                     nb, per_block, tables,
                                                     local, wb):
    """Both table placements, K = 1, 2, 8; row stride below LW = 256 with
    ragged rows; the last block overflows its predecessor slots."""
    _, mkcaps, _, _, over = KERNELS[name]
    rng = np.random.default_rng(70 + VW + sms + 2 * int(local) + (wb >= 0))
    p = POAParams(1, 4, 6, 2, 26, 1, local=local, wb=wb, wf_milli=30)
    blocks = [make_block(rng, int(rng.integers(25, 75)),
                         int(rng.integers(2, 4)), 0.06)
              for _ in range(nb - 1)]
    blocks.append(make_fan_in_block(rng, over, 5))
    ins = pack_blocks([(sq, p) for sq in blocks], 256)
    got, geo, want = run_emu(exes, name, ins,
                             mkcaps(VW, 256, local, wb >= 0), sms=sms)
    assert_equal(got, want)
    assert (geo["per_block"], geo["tables"]) == (per_block, tables)
    assert geo["grid"] == -(-nb // per_block)
    assert row_stride(ins[1], 256) < 256
    assert want[0][:, 1].tolist() == [0] * (nb - 1) + [1]
