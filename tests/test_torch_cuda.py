"""The port's CUDA kernel on the GPU: the kernel against its plain PyTorch
version (exact equality, all outputs are integers) and the slice end to end
against the native engine's bytes.  Every test needs an NVIDIA GPU and
skips without one.  Nothing here imports jax, so on a GPU machine without
it: python -m pytest --noconftest -m cuda tests/test_torch_cuda.py"""
import hashlib

import numpy as np
import pytest
import torch

from smoothxg_tpu.ops.poa_host import POAParams
from smoothxg_tpu.pipeline.run import run_smoothing as jax_pkg_run
from smoothxg_tpu_torch.ops.poa_engine import TorchPOAEngine
from smoothxg_tpu_torch.ops.poa_win import (WinCaps, pack_blocks, poa_win,
                                            poa_win_reference)
from smoothxg_tpu_torch.pipeline.run import Config, run_smoothing
from smoothxg_tpu_torch.testing.synth import make_block, write_pangenome

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


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _cfg(gfa, tmp, tag, engine):
    return Config(gfa_in=gfa, smoothed_out=str(tmp / f"{tag}.gfa"),
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
    jax_pkg_run(_cfg(gfa, tmp_path, "native", "native"))
    assert eng.stats()["kernel_launches"] > 4
    assert eng.stats()["device_blocks"] > 0
    for ext in ("gfa", "maf"):
        assert _sha(tmp_path / f"port.{ext}") == \
            _sha(tmp_path / f"native.{ext}")
