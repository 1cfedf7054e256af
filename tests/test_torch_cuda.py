"""The port's CUDA kernels on the GPU: each kernel (poa_win, poa_round,
poa_code, poa_stacked) against its plain PyTorch version (exact equality,
all outputs are integers) and each GPU engine's slice end to end against
the native engine's bytes.  Every test needs an NVIDIA GPU and
skips without one.  Nothing here imports jax, so on a GPU machine without
it: python -m pytest --noconftest -m cuda tests/test_torch_cuda.py"""
import hashlib

import numpy as np
import pytest
import torch

from smoothxg_tpu.pipeline.run import Config as JaxConfig
from smoothxg_tpu.pipeline.run import run_smoothing as jax_pkg_run
from smoothxg_tpu_torch.ops.poa_code import (CodeCaps, poa_code,
                                             poa_code_reference)
from smoothxg_tpu_torch.ops.poa_engine import TorchPOAEngine
from smoothxg_tpu_torch.ops import poa_host
from smoothxg_tpu_torch.ops.poa_graph import POAGraph
from smoothxg_tpu_torch.ops.poa_host import POAParams
from smoothxg_tpu_torch.ops.poa_round import (TorchRoundPOAEngine,
                                              decode_moves, pack_tasks,
                                              poa_round, poa_round_reference)
from smoothxg_tpu_torch.ops.poa_stacked import (poa_stacked,
                                                poa_stacked_reference,
                                                stacked_caps)
from smoothxg_tpu_torch.ops.poa_win import (WinCaps, pack_blocks, poa_win,
                                            poa_win_reference)
from smoothxg_tpu_torch.pipeline.run import Config, run_smoothing
from smoothxg_tpu_torch.testing.synth import (make_block, make_fan_in_block,
                                              make_fan_in_task,
                                              make_round_task,
                                              write_pangenome)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("local,banded", [(True, False), (False, False),
                                          (False, True)])
def test_kernel_matches_plain_version(cuda_device, local, banded):
    rng = np.random.default_rng(29)
    p = POAParams(1, 4, 6, 2, 26, 1, local=local, wb=40 if banded else -1)
    blocks = [(make_block(rng, 300 + 40 * i, 3 + i % 3, 0.02), p)
              for i in range(6)]
    VW, LW, W = (2048, 1024, 512) if banded else (1024, 512, 512)
    ins = pack_blocks(blocks, LW)
    caps = WinCaps(VW, LW, W, local, banded)
    before = poa_win.launches
    got = poa_win(*(x.to(cuda_device) for x in ins), caps)
    torch.cuda.synchronize()
    assert poa_win.launches == before + 1
    want = poa_win_reference(*ins, caps)
    assert int(want[0][:, 1].sum()) == 0, "fixture overflows"
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# kernel: (wrapper, plain version, caps, in-degree held, overflowing)
CHASE = {"poa_code": (poa_code, poa_code_reference, CodeCaps, 8, 9),
         "poa_stacked": (poa_stacked, poa_stacked_reference, stacked_caps,
                         4, 5)}


@pytest.mark.parametrize("local,banded", [(True, False), (False, False),
                                          (False, True), (True, True)])
@pytest.mark.parametrize("name", sorted(CHASE))
def test_chase_kernel_matches_plain_version(cuda_device, name, local,
                                            banded):
    """Seeded blocks, a fan-in the kernel holds and one that overflows
    it, banded (abPOA band narrower than the rows) or not; 140 blocks in
    one launch, so poa_stacked packs 2 warps per thread block."""
    kern, ref, mkcaps, held, over = CHASE[name]
    rng = np.random.default_rng(53)
    p = POAParams(1, 4, 6, 2, 26, 1, local=local, wb=12 if banded else -1)
    blocks = [make_block(rng, int(rng.integers(20, 60)), 2 + i % 3, 0.05)
              for i in range(134)]
    blocks += [make_block(rng, 300 + 60 * i, 3, 0.03) for i in range(4)]
    blocks += [make_fan_in_block(rng, held, 40),
               make_fan_in_block(rng, over, 40)]
    ins = pack_blocks([(sq, p) for sq in blocks], 1024)
    caps = mkcaps(2048, 1024, local, banded)
    before = kern.launches
    got = kern(*(x.to(cuda_device) for x in ins), caps)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = ref(*ins, caps)
    assert want[0][:, 1].tolist() == [0] * 139 + [1]
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("local", [True, False])
def test_round_kernel_matches_plain_version(cuda_device, local):
    """Seeded round tasks up to ~1 kb, a node of in-degree 12 and an empty
    slot in one launch; decoded moves equal the oracle's."""
    rng = np.random.default_rng(41)
    p = POAParams(local=local)
    tasks = [make_round_task(rng, 200 + 160 * i, 3 + i % 5, 0.03, p)
             for i in range(6)]
    tasks += [make_fan_in_task(rng, 12, 150, p), (POAGraph(), tasks[0][1], p)]
    ins, orders = pack_tasks(tasks)
    before = poa_round.launches
    got = poa_round(*(x.to(cuda_device) for x in ins), local)
    torch.cuda.synchronize()
    assert poa_round.launches == before + 1
    want = poa_round_reference(*ins, local)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    codes, meta = want
    assert (meta[:, 2] == 0).all()
    for b, t in enumerate(tasks):
        assert decode_moves(codes[b].numpy(), int(meta[b, 0]), orders[b]) \
            == poa_host.align(*t)


def test_round_kernel_past_the_pallas_packing(cuda_device):
    """A query longer than 2^15 (read from global memory, not shared) that
    ends in the graph's sequence: 64-bit codes past the Pallas packing."""
    rng = np.random.default_rng(43)
    p = POAParams(local=True)
    g, q, _ = make_round_task(rng, 200, 2, 0.03, p)
    q = np.concatenate([rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                   1 << 15), q])
    ins, orders = pack_tasks([(g, q, p)])
    got = poa_round(*(x.to(cuda_device) for x in ins), True)
    want = poa_round_reference(*ins, True)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    codes, meta = want
    assert int(codes[0, 0] & 0xFFFFFFFF) >= 1 << 15
    assert decode_moves(codes[0].numpy(), int(meta[0, 0]), orders[0]) == \
        poa_host.align(g, q, p)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _cfg(gfa, tmp, tag, engine, config=Config):
    return config(gfa_in=gfa, smoothed_out=str(tmp / f"{tag}.gfa"),
                  write_msa_in_maf_format=str(tmp / f"{tag}.maf"),
                  n_haps=4, max_path_jump=5000, max_edge_jump=5000,
                  poa_length_targets=[700], threads=1, add_consensus=True,
                  tmp_base=str(tmp), engine=engine)


def test_slice_on_gpu_matches_native_bytes(cuda_device, tmp_path):
    gfa = write_pangenome(str(tmp_path / "in.gfa"), haplotypes=4,
                          length=3000, seed=7)
    eng = TorchPOAEngine(device=cuda_device)
    eng.warmup(locals_=(True, False), banded=(False, True))
    assert eng.stats()["kernel_launches"] == 4
    run_smoothing(_cfg(gfa, tmp_path, "port", "fused"), engine=eng)
    jax_pkg_run(_cfg(gfa, tmp_path, "native", "native", JaxConfig))
    assert eng.stats()["kernel_launches"] > 4
    assert eng.stats()["device_blocks"] > 0
    for ext in ("gfa", "maf"):
        assert _sha(tmp_path / f"port.{ext}") == \
            _sha(tmp_path / f"native.{ext}")


@pytest.mark.parametrize("option", ["shape", "stacked"])
def test_chase_slices_on_gpu_match_native_bytes(cuda_device, tmp_path,
                                                option):
    """TorchPOAEngine(shape=...) runs every block on poa_code,
    TorchPOAEngine(kernel="stacked") on poa_stacked; both give the native
    engine's bytes."""
    gfa = write_pangenome(str(tmp_path / "in.gfa"), haplotypes=4,
                          length=3000, seed=7)
    eng = TorchPOAEngine(device=cuda_device, shape=(4352, 2048)) \
        if option == "shape" else \
        TorchPOAEngine(device=cuda_device, kernel="stacked")
    kern = poa_code if option == "shape" else poa_stacked
    before = (kern.launches, poa_win.launches)
    run_smoothing(_cfg(gfa, tmp_path, "port", "fused"), engine=eng)
    jax_pkg_run(_cfg(gfa, tmp_path, "native", "native", JaxConfig))
    st = eng.stats()
    assert kern.launches > before[0] and poa_win.launches == before[1]
    assert st["kernel_launches"] == kern.launches - before[0]
    assert st["device_blocks"] > 0 and st["fallbacks"] == 0
    for ext in ("gfa", "maf"):
        assert _sha(tmp_path / f"port.{ext}") == \
            _sha(tmp_path / f"native.{ext}")


def test_round_slice_on_gpu_matches_native_bytes(cuda_device, tmp_path):
    gfa = write_pangenome(str(tmp_path / "in.gfa"), haplotypes=4,
                          length=3000, seed=7)
    eng = TorchRoundPOAEngine(device=cuda_device)
    eng.warmup(locals_=(True, False))
    assert eng.stats()["kernel_launches"] == 2
    run_smoothing(_cfg(gfa, tmp_path, "port", "pallas"), engine=eng)
    jax_pkg_run(_cfg(gfa, tmp_path, "native", "native", JaxConfig))
    st = eng.stats()
    assert st["kernel_launches"] > 2 and st["device_tasks"] > 0
    assert st["fallbacks"] == 0 and st["stuck_fallbacks"] == 0
    for ext in ("gfa", "maf"):
        assert _sha(tmp_path / f"port.{ext}") == \
            _sha(tmp_path / f"native.{ext}")
