"""Explicit device selection: the port never picks a device behind the
caller's back, and never falls back from CUDA to the CPU."""
from __future__ import annotations

import torch


_GPU_ENGINES = ("the GPU engines (fused, pallas) run their POA kernels on "
                "an NVIDIA GPU")


def resolve(device: str | torch.device | None = "cuda",
            what: str = _GPU_ENGINES,
            instead: str = "use --engine native for a CPU run"
            ) -> torch.device:
    """The torch.device a run will use.  A CUDA device must exist: asking
    for one on a machine without CUDA raises instead of quietly running on
    the CPU.  `what` says what needs the card and `instead` what a CPU run
    takes, for the message."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"CUDA required: {what} and torch.cuda.is_available() is False "
            f"({instead})")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
