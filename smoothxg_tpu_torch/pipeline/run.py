"""Smoothing entry point of the port: build the engine, then run the reused
pipeline (smoothxg_tpu/pipeline/run.run_smoothing) with the engine
instance.  Only the engine differs from the JAX package's run; every host
stage is the same code."""
from __future__ import annotations

import dataclasses

import torch

from smoothxg_tpu.pipeline.run import Config
from smoothxg_tpu.pipeline.run import run_smoothing as _run_smoothing

__all__ = ["Config", "make_engine", "run_smoothing"]


def make_engine(cfg: Config, device: str | torch.device = "cuda"):
    """The engine `cfg.engine` names: "fused" is the GPU engine (on
    `device`), "native" and "host" are the JAX package's jax-free engines;
    "jax" and "pallas" are not ported yet.  An engine instance passes
    through."""
    if not isinstance(cfg.engine, str):
        return cfg.engine
    threads = cfg.poa_threads or cfg.threads or 1
    if cfg.engine == "fused":
        from ..ops.poa_engine import TorchPOAEngine
        return TorchPOAEngine(device=device, threads=threads)
    if cfg.engine == "native":
        from smoothxg_tpu.ops.poa_native import NativePOAEngine
        return NativePOAEngine(threads=threads)
    if cfg.engine == "host":
        from smoothxg_tpu.pipeline.smooth import HostPOAEngine
        return HostPOAEngine()
    if cfg.engine in ("jax", "pallas"):
        raise NotImplementedError(
            f"--engine {cfg.engine} is not yet ported to smoothxg_tpu_torch "
            f"(use fused, native or host)")
    raise ValueError(f"unknown engine {cfg.engine!r}")


def run_smoothing(cfg: Config, device: str | torch.device = "cuda",
                  engine=None):
    """Run the multi-iteration smoothing pipeline with the port's engine.
    Returns (final gfa path, consensus path names, engine)."""
    engine = engine if engine is not None else make_engine(cfg, device)
    out, names = _run_smoothing(dataclasses.replace(cfg, engine=engine))
    return out, names, engine
