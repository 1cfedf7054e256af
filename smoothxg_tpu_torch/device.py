"""Explicit device selection: the port never picks a device behind the
caller's back, and never falls back from CUDA to the CPU."""
from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = "cuda") -> torch.device:
    """The torch.device a run will use.  A CUDA device must exist: asking
    for one on a machine without CUDA raises instead of quietly running on
    the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA required: the default engine runs its POA kernel on an "
            "NVIDIA GPU and torch.cuda.is_available() is False (use "
            "--engine native for a CPU run)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
