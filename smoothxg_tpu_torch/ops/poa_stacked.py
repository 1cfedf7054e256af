"""Whole-block partial order alignment, several blocks per thread block.

`poa_stacked` computes the function of ops/poa_code.poa_code — the whole
POA loop of FusedPOA per block, full-width rows, code-chase traceback,
optional rank band — at 4 predecessor slots per node, with poa_win's I/O
contract and layouts.  It is the port of the stacked Pallas kernel
smoothxg_tpu/ops/poa_pallas_stacked.py:_stacked_core (wrappers
`_stacked_fn`, `_compiled_stacked`), which keeps K blocks' DP rows in one
grid step and records a 16-bit code per cell with 2-bit slot fields
(`CODE16`, poa_pallas_stacked.py:433-442); a 5th distinct predecessor of
a node overflows, as there.  On the GPU, csrc/poa_stacked.cu runs one warp
per POA block and several warps per thread block, with no lockstep: each
warp fills its own rows with warp shuffles only.  For CPU tensors
`poa_stacked` runs `poa_stacked_reference`, the code-chase plain version
of ops/poa_code with the 16-bit code layout.  A windowed caps (W < LW) or
more than 4 predecessor slots raises ValueError: the kernel is full width
only, as `FusedPallasEngine(kernel="stacked")` is.

`from_stacked_layout` / `to_stacked_layout` convert from and to the Pallas
kernel's (B*K, ...) arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .poa_code import (CodeCaps, CodeLayout, code_reference,
                       from_fused_layout, to_fused_layout)
from .poa_win import _check_inputs, launch

PCAP = 4
CODE16 = CodeLayout(2)


def stacked_caps(VW: int, LW: int, local: bool, banded: bool) -> CodeCaps:
    return CodeCaps(VW, LW, local, banded, pcap=PCAP)


def scratch_words(caps) -> int:
    """int32 words of per-block scratch: node and row tables,
    target/splice lists, the int32 planes H, E1, E2 and the 16-bit code
    plane (14 B per cell; the layout is spelled out in
    csrc/poa_stacked.cu)."""
    v1 = caps.VW + 1
    cells = v1 * caps.LW
    return (12 + 2 * caps.pcap) * v1 + 3 * caps.LW + 3 * cells + \
        (cells + 1) // 2


def _check_caps(caps) -> None:
    if caps.W != caps.LW:
        raise ValueError(f"poa_stacked is full width only: W={caps.W} < "
                         f"LW={caps.LW}")
    if caps.pcap > PCAP:
        raise ValueError(f"poa_stacked holds {PCAP} predecessor slots, not "
                         f"{caps.pcap}")


def poa_stacked(seqs: torch.Tensor, slen: torch.Tensor, nseq: torch.Tensor,
                params: torch.Tensor, caps):
    """Run the whole POA loop of every block.  CUDA tensors launch the
    kernel (and raise on any launch error); CPU tensors run the plain
    version.  Returns (meta, exp, paths) on the inputs' device."""
    _check_caps(caps)
    _check_inputs(seqs, slen, nseq, params, caps)
    if seqs.device.type == "cpu":
        return poa_stacked_reference(seqs, slen, nseq, params, caps)
    out = launch("poa_stacked", seqs, slen, nseq, params, caps,
                 scratch_words(caps), caps.pcap)
    poa_stacked.launches += 1
    return out


poa_stacked.launches = 0     # kernel launches made by this wrapper


def poa_stacked_reference(seqs: torch.Tensor, slen: torch.Tensor,
                          nseq: torch.Tensor, params: torch.Tensor, caps):
    """The same function in plain PyTorch on the CPU (ops/poa_code's
    code-chase plain version with 2-bit slot fields)."""
    _check_caps(caps)
    return code_reference(seqs, slen, nseq, params, caps, CODE16)


def from_stacked_layout(nseq, par, slen, seqs, K: int, LW: int, RW: int):
    """`_compiled_stacked`'s input arrays (numpy, N = grid steps x K blocks;
    the arrays of `from_fused_layout`) -> the port's (seqs, slen, nseq,
    params) CPU tensors."""
    N = int(np.asarray(nseq).shape[0])
    if N % K:
        raise ValueError(f"{N} blocks is not a multiple of K={K}")
    return from_fused_layout(nseq, par, slen, seqs, LW, RW)


def to_stacked_layout(meta, exp, paths, VW: int, LW: int, RW: int):
    """The port's outputs -> `_stacked_fn`'s (meta (N,4) int32, exp
    (N, 3*VW/128, 128) int16, paths (N, RW*LW/128, 128) int16)."""
    return to_fused_layout(meta, exp, paths, VW, LW, RW)
