"""The POA kernel sources, csrc/poa_win.cu, poa_code.cu, poa_stacked.cu,
poa_round.cu and poa_batch.cu, built for the CUDA emulation under
AddressSanitizer and UBSan (cuda_emu.build(..., sanitize=True)) and run on
the inputs of their emulation tests, held to their plain PyTorch versions
(exact: every output is an integer).  The emulated shared memory is a heap
block of exactly the launch's bytes, so a read or write past it is a
sanitizer report; with -fno-sanitize-recover=all any report ends the launch
with a nonzero exit, which the run_* helpers raise with the report as the
message.  Each source runs its shared-memory and its device-memory layout
(graph or row tables pushed out of shared memory by the row count or by a
small emulated shared memory).  A kernel that writes one word past its
shared memory must fail with an AddressSanitizer report: the flags apply.
(The split, SGD, autocorrelation and probe sources:
test_torch_sanitize_emu_other.py.)"""
import numpy as np
import pytest
import torch

from smoothxg_tpu_torch.ops import poa_host
from smoothxg_tpu_torch.ops.poa_batch import pack_tasks as pack_batch
from smoothxg_tpu_torch.ops.poa_batch import poa_batch_reference
from smoothxg_tpu_torch.ops.poa_code import CodeCaps, poa_code_reference
from smoothxg_tpu_torch.ops.poa_host import POAParams
from smoothxg_tpu_torch.ops.poa_round import pack_tasks as pack_round
from smoothxg_tpu_torch.ops.poa_round import poa_round_reference
from smoothxg_tpu_torch.ops.poa_stacked import (poa_stacked_reference,
                                                scratch_words, stacked_caps)
from smoothxg_tpu_torch.ops.poa_win import (WinCaps, pack_blocks,
                                            poa_win_reference, row_stride)
from smoothxg_tpu_torch.testing import cuda_emu
from smoothxg_tpu_torch.testing.synth import (make_block, make_fan_in_block,
                                              make_fan_in_task,
                                              make_round_task)

SOURCES = ("poa_win", "poa_code", "poa_stacked", "poa_round", "poa_batch")
# whole-block kernels: plain version, caps, scratch words at LS, in-degree
# held, emulated SMs (poa_stacked on 2: two warps a thread block)
BLOCK = {
    "poa_win": (poa_win_reference,
                lambda VW, LW, local, banded: WinCaps(
                    VW, LW, 3 * LW // 4 if banded else LW, local, banded),
                lambda c, LS: c.scratch_words(LS), 8, 132),
    "poa_code": (poa_code_reference, CodeCaps,
                 lambda c, LS: c.scratch_words(LS), 8, 132),
    "poa_stacked": (poa_stacked_reference, stacked_caps, scratch_words, 4,
                    2),
}


@pytest.fixture(scope="module")
def exes(tmp_path_factory):
    return cuda_emu.build_many(SOURCES, str(tmp_path_factory.mktemp("asan")),
                               sanitize=True)


def _blocks(exe, name):
    """test_torch_chase_emu's inputs: two seeded blocks, a fan-in the
    kernel holds and one past it; tables in shared memory (VW 256, local,
    then banded) and in device memory (VW 8704, global)."""
    ref, mkcaps, words, held, sms = BLOCK[name]
    rng = np.random.default_rng(31)
    tables = set()
    for VW, local, wb in ((256, True, -1), (256, False, 9),
                          (8704, False, -1)):
        p = POAParams(1, 4, 6, 2, 26, 1, local=local, wb=wb, wf_milli=30)
        blocks = [make_block(rng, int(rng.integers(25, 75)), 3, 0.06)
                  for _ in range(2)]
        blocks += [make_fan_in_block(rng, held, 5),
                   make_fan_in_block(rng, held + 1, 5)]
        ins = pack_blocks([(sq, p) for sq in blocks], 128)
        caps = mkcaps(VW, 128, local, wb >= 0)
        LS = row_stride(ins[1], 128)
        got, geo = cuda_emu.run_geometry(exe, *ins, caps, words(caps, LS),
                                         LS=LS, sms=sms, timeout=240)
        for g, w in zip(got, ref(*ins, caps)):
            assert torch.equal(g, w)
        tables.add(geo["tables"])
    assert tables == {"shared", "device"}


def _round(exe, _):
    """test_torch_round_emu's: rows of two warps on the ring route and a
    fan-in of 7, the row tables in shared memory, then in device memory
    (an emulated card with room for the ring only)."""
    rng = np.random.default_rng(49)
    p = poa_host.POAParams(local=True)
    tasks = [make_round_task(rng, int(rng.integers(180, 240)), 3, 0.06, p),
             make_fan_in_task(rng, 7, 40, p)]
    ins, _ = pack_round(tasks)
    want = poa_round_reference(*ins, True)
    smem = 3 * 8 * ((ins[6].shape[1] + 4) & ~3) * 4 + 1024 + 2048
    tables = set()
    for device in ({}, {"smem_block": smem, "smem_sm": smem + 1024}):
        (codes, meta), geo = cuda_emu.run_round(exe, *ins, True, timeout=240,
                                                **device)
        assert torch.equal(codes, want[0]) and torch.equal(meta, want[1])
        tables.add(geo["tables"])
    assert tables == {0, 1}


def _batch(exe, _):
    """test_torch_batch_emu's: rows of two warps on the ring route, a
    fan-in of 7 (P 8) and a predecessor past the ring, the row tables in
    shared memory, then in device memory (room for the ring only)."""
    rng = np.random.default_rng(81)
    p = poa_host.POAParams(local=False)
    tasks = [make_round_task(rng, int(rng.integers(180, 240)), 3, 0.06, p),
             make_fan_in_task(rng, 7, 40, p)]
    ins, _ = pack_batch(tasks)
    want = poa_batch_reference(*ins, False)
    Lp = ins[2].shape[1]
    smem = 3 * 8 * ((Lp + 4) & ~3) * 4 + 2 * (4 * 5 + 16) * 4 + 512 + 2048
    tables = set()
    for device in ({}, {"smem_block": smem, "smem_sm": smem + 1024}):
        got, geo = cuda_emu.run_batch_geometry(exe, *ins, False, timeout=240,
                                               **device)
        for g, w in zip(got, want):
            assert torch.equal(g, w.to(torch.int32))
        tables.add(geo["tables"])
    assert tables == {0, 1}


CASES = {"poa_win": _blocks, "poa_code": _blocks, "poa_stacked": _blocks,
         "poa_round": _round, "poa_batch": _batch}


@pytest.mark.parametrize("name", SOURCES)
def test_sanitized_source_matches_plain_version(exes, name):
    CASES[name](exes[name], name)


PAST_END = r"""
#include <cuda_runtime.h>
#include <cstdlib>
// each thread writes its own word of `words` words of shared memory
__global__ void own_word(int words) {
    extern __shared__ int smem[];
    smem[threadIdx.x] = words;
}
int main(int argc, char** argv) {
    const int threads = std::atoi(argv[3]);
    own_word<<<1, threads, 32 * sizeof(int), nullptr>>>(32);
    return cudaGetLastError();
}
"""


OPT_IN = r"""
#include <cuda_runtime.h>
#include <cstdlib>
#include "smem.cuh"
// a kernel with a __shared__ buffer of its own beside its dynamic bytes
__global__ void both(int words) {
    __shared__ int own[32];
    extern __shared__ int smem[];
    own[threadIdx.x] = words;
    smem[threadIdx.x] = own[threadIdx.x];
}
int main(int argc, char** argv) {
    const size_t smem = 48 * 1024 - 100;
    if (std::atoi(argv[1]) && opt_in_smem(both, smem) != cudaSuccess)
        return 3;
    both<<<1, 32, smem, nullptr>>>(32);
    return cudaGetLastError();
}
"""


def test_launch_under_48_kb_with_static_buffers_opts_in(tmp_path):
    """48 KB less 100 bytes of dynamic shared memory, with the kernel's
    static buffers past 48 KB: refused unless csrc/smem.cuh's opt_in_smem
    raised the cap (the emulation counts 512 static bytes a kernel, and
    the card refuses such a launch with an invalid argument)."""
    src = tmp_path / "both.cu"
    src.write_text(OPT_IN)
    exe = cuda_emu.build("both", str(tmp_path / "b"), sanitize=True,
                         source=str(src))
    cuda_emu.run_exe(exe, ["1"], timeout=60)
    with pytest.raises(cuda_emu.LaunchError, match="rc 1 "):
        cuda_emu.run_exe(exe, ["0"], timeout=60)


def test_sanitizer_reports_a_write_past_shared_memory(tmp_path):
    """32 threads on 32 words run clean; 33 write one word past the end,
    and the launch fails with AddressSanitizer's report."""
    src = tmp_path / "past_end.cu"
    src.write_text(PAST_END)
    exe = cuda_emu.build("past_end", str(tmp_path / "b"), sanitize=True,
                         source=str(src))
    cuda_emu.run_exe(exe, ["-", "-", "32"], timeout=60)
    with pytest.raises(cuda_emu.LaunchError,
                       match="AddressSanitizer: heap-buffer-overflow"):
        cuda_emu.run_exe(exe, ["-", "-", "33"], timeout=60)
