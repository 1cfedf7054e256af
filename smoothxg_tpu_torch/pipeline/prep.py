"""Graph prep: sort + groom + toposort + chop before block finding.

Reimplements the reference's prep stage (reference: src/prep.cpp:10-151,
equivalent to `odgi sort -p Ygs` + `odgi chop`):

  * path-guided 1D SGD layout (reference: odgi path_linear_sgd_order with
    zipf-sampled term updates, theta=0.99, 100 iters, cooling 0.5,
    src/prep.cpp:30-125) — ops/sgd.py: the native host backend below
    5M term updates an iteration, the batched route at or above it (the
    CUDA kernel csrc/sgd.cu, or its plain version on a CPU run); optional,
  * groom + topological sort (src/prep.cpp:131-140),
  * chop to max node length (default 100, src/prep.cpp:142-144).
"""
from __future__ import annotations

from ..graph.mutable import MutableGraph
from ..utils.progress import Log


def prep(g: MutableGraph, node_chop: int = 100, use_sgd: bool = True,
         sgd_term_updates: float = 1.0, threads: int = 1,
         device: str | torch.device = "cuda") -> MutableGraph:
    """threads>1 runs the native SGD layout Hogwild over racy worker
    threads — the reference's semantics (odgi path_linear_sgd) and its
    non-determinism; threads=1 (default) is sequential and deterministic.
    device: the run's device, which the SGD layout takes at or above 5M
    term updates an iteration ("cuda": the kernel, "cpu": its plain
    version)."""
    if use_sgd:
        import torch
        from ..ops.sgd import path_sgd_order
        order = path_sgd_order(g, min_term_updates_factor=sgd_term_updates,
                               threads=threads,
                               auto_device=torch.device(device).type)
        g = g.compact(order)
    order, flips = g.groom()
    g = g.compact(order, flips)
    g = g.compact(g.topological_order())
    g = g.chop(node_chop)
    Log.info("prep", f"prepped graph: {g.node_count()} nodes after chop({node_chop})")
    return g
