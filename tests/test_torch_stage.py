"""The `stage` profiling knob of the code-chase kernels: the port's plain
versions (ops/poa_code.poa_code_reference, ops/poa_stacked.
poa_stacked_reference) at stages 0, 1 and 2 against the Pallas kernels
they replace (ops/poa_pallas_fused._compiled_fused and ops/
poa_pallas_stacked._compiled_stacked, interpret mode, the same stage), and
the kernel sources csrc/poa_code.cu (stages 0-7) and csrc/poa_stacked.cu
(stages 0-2) on the CPU emulation against the plain versions, with the
graph tables in shared memory and, for stages 1 and 2, in device memory
(VW 8704).  Stage 1
stops each round at the end cell and stage 2 after the traceback, so the
graph stays the seed chain of sequence 0 and only path 0 is written; the
Pallas kernels leave the other paths unwritten, the port leaves them -1.
Inputs are seeded with numpy; tolerance: none, all outputs are
integers."""
import functools

import numpy as np
import pytest
import torch

from smoothxg_tpu.ops.poa_host import POAParams
from smoothxg_tpu.ops.poa_pallas_fused import _compiled_fused
from smoothxg_tpu.ops.poa_pallas_stacked import _compiled_stacked
from smoothxg_tpu_torch.ops.poa_code import (CodeCaps, from_fused_layout,
                                             poa_code, poa_code_reference,
                                             to_fused_layout)
from smoothxg_tpu_torch.ops.poa_host import POAParams as PortParams
from smoothxg_tpu_torch.ops.poa_stacked import (poa_stacked,
                                                poa_stacked_reference,
                                                scratch_words, stacked_caps)
from smoothxg_tpu_torch.ops.poa_win import pack_blocks, row_stride
from smoothxg_tpu_torch.testing import cuda_emu
from smoothxg_tpu_torch.testing.synth import make_block

from test_poa_pallas_win import family
from test_torch_poa_code import LW, RW, VW, pack_fused, unpack
from test_torch_poa_win import P_DEF

K = 2                         # blocks per grid step of the stacked kernel


@functools.lru_cache(maxsize=None)
def _blocks(local: bool):
    rng = np.random.default_rng(300 + int(local))
    return [family(rng, int(rng.integers(20, 50)), int(rng.integers(3, 5)))
            for _ in range(K)]


@functools.lru_cache(maxsize=None)
def _pallas(kernel: str, local: bool, stage: int):
    blocks = _blocks(local)
    p = POAParams(*P_DEF, local=local)
    planes = pack_fused(blocks, [p] * K)
    if kernel == "code":
        pal = _compiled_fused(VW, LW, RW, local, True, K, stage)(*planes)
        ins = from_fused_layout(*planes, LW, RW)
        port = poa_code_reference(*ins, CodeCaps(VW, LW, local, False),
                                  stage)
    else:
        pal = _compiled_stacked(K, VW, LW, RW, local, True, 1, stage)(
            *planes)
        ins = from_fused_layout(*planes, LW, RW)
        port = poa_stacked_reference(*ins, stacked_caps(VW, LW, local,
                                                        False), stage)
    return (tuple(np.asarray(x) for x in pal),
            to_fused_layout(*port, VW, LW, RW), port)


@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("kernel", ["code", "stacked"])
def test_plain_version_matches_the_pallas_stage(kernel, local, stage):
    pal, port_l, port = _pallas(kernel, local, stage)
    for b, sq in enumerate(_blocks(local)):
        got = unpack(port_l, b, sq)
        want = unpack(pal, b, sq)
        assert got[0][1] == 0, "unexpected overflow"
        if stage == 0:
            assert got == want
            continue
        # meta, base, ring, order and path 0 (the seed chain)
        assert got[:4] == want[:4] and got[4][0] == want[4][0]
        assert got[0][0] == len(sq[0])
        assert (port[2][b, 1:] == -1).all()


@pytest.mark.parametrize("kernel", ["code", "stacked"])
def test_stage_0_is_the_kernel_of_the_engine(kernel):
    rng = np.random.default_rng(5)
    ins = pack_blocks([(make_block(rng, 70, 4, 0.05), PortParams())], LW)
    if kernel == "code":
        caps = CodeCaps(VW, LW, True, False)
        a, b = poa_code_reference(*ins, caps), poa_code_reference(*ins, caps,
                                                                  0)
    else:
        caps = stacked_caps(VW, LW, True, False)
        a, b = (poa_stacked_reference(*ins, caps),
                poa_stacked_reference(*ins, caps, 0))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_stages_are_checked():
    rng = np.random.default_rng(6)
    ins = pack_blocks([(make_block(rng, 40, 2, 0.05), PortParams())], LW)
    with pytest.raises(ValueError):
        poa_code(*ins, CodeCaps(VW, LW, True, False), stage=8)
    with pytest.raises(ValueError):
        poa_stacked(*ins, stacked_caps(VW, LW, True, False), stage=3)
    before = poa_code.launches
    got = poa_code(*ins, CodeCaps(VW, LW, True, False), stage=4)
    assert poa_code.launches == before
    want = poa_code_reference(*ins, CodeCaps(VW, LW, True, False), 4)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


# ---- the kernel sources on the CPU emulation ----

@pytest.fixture(scope="module")
def exes(tmp_path_factory):
    d = tmp_path_factory.mktemp("stage")
    return {"code": cuda_emu.build("poa_code", str(d / "code")),
            "stacked": cuda_emu.build("poa_stacked", str(d / "stk"))}


def _emu_inputs(local: bool):
    rng = np.random.default_rng(41 + int(local))
    p = PortParams(1, 4, 6, 2, 26, 1, local=local)
    blocks = [make_block(rng, int(rng.integers(20, 45)), 3, 0.06)
              for _ in range(2)]
    return pack_blocks([(sq, p) for sq in blocks], 128)


def _emu_stage(exes, kernel, stage, local, VW):
    """The emulated kernel at a stage (poa_stacked on 2 emulated SMs: one
    thread block of 2 warps) against the plain version; returns the
    launch geometry."""
    ins = _emu_inputs(local)
    LS = row_stride(ins[1], 128)
    if kernel == "code":
        caps = CodeCaps(VW, 128, local, False)
        got, geo = cuda_emu.run_geometry(exes[kernel], *ins, caps,
                                         caps.scratch_words(LS), stage=stage,
                                         LS=LS)
        want = poa_code_reference(*ins, caps, stage)
    else:
        caps = stacked_caps(VW, 128, local, False)
        got, geo = cuda_emu.run_geometry(exes[kernel], *ins, caps,
                                         scratch_words(caps, LS),
                                         stage=stage, LS=LS, sms=2)
        want = poa_stacked_reference(*ins, caps, stage)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert want[0][:, 1].tolist() == [0, 0]
    return geo


@pytest.mark.parametrize("kernel,stage,local", [
    *[("code", s, True) for s in range(8)],
    *[("code", s, False) for s in range(3)],
    *[("stacked", s, lc) for s in range(3) for lc in (True, False)]])
def test_kernel_source_matches_plain_version_at_each_stage(exes, kernel,
                                                           stage, local):
    assert _emu_stage(exes, kernel, stage, local, 256)["tables"] == "shared"


@pytest.mark.parametrize("kernel,stage", [(k, s) for k in ("code", "stacked")
                                          for s in (1, 2)])
def test_stage_outputs_with_device_tables(exes, kernel, stage):
    assert _emu_stage(exes, kernel, stage, True, 8704)["tables"] == "device"
