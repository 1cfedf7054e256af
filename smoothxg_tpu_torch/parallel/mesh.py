"""Per-card block sharding: the port of smoothxg_tpu/parallel/mesh.py and
of the sharded wrappers of the JAX package's POA kernels (`_compiled_*
_sharded` in ops/poa_pallas_{win,fused,stacked}.py).

The JAX package jits one batch over a 1-D device mesh with the block axis
sharded (shard_map / NamedSharding).  Here a mesh is a list of
torch.devices: a batch's block axis is cut into contiguous shards, one per
entry, each shard's kernel is launched on its own device and stream, and
the results are gathered in block order.  A card may appear more than once
(its shards then run on separate streams), and the CPU counts as one shard
(the wrappers run their plain versions there).  Blocks are independent, so
a sharded batch gives the results of the same batch in one launch.
"""
from __future__ import annotations

import torch

from .multiproc import init_process_group, shard_bounds


def make_mesh(n_devices: int | list | None = None) -> list[torch.device]:
    """The mesh's devices: every visible card (None), the first n cards,
    or the devices of a list as given."""
    if isinstance(n_devices, (list, tuple)):
        return [torch.device(d) for d in n_devices]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else n_devices
    if n < 1 or n > have:
        raise RuntimeError(f"CUDA required: a mesh of {n} cards needs "
                           f"them, and {have} are visible")
    return [torch.device("cuda", k) for k in range(n)]


# the JAX package's name for the multi-process bootstrap: torch.distributed
# (gloo) on tcp://coordinator, init_distributed(coordinator, num_processes,
# process_id)
init_distributed = init_process_group


def launch_shards(devices, fn, inputs, dims=None) -> list:
    """Cut every input along its block axis (`dims`, 0 by default) into
    contiguous shards, one per device, and call fn(*shard) on each device:
    with one device on its current stream, with more on a stream of its
    own each.  Returns [(stream or None, fn's outputs)] without waiting."""
    devices = [torch.device(d) for d in devices]
    dims = dims or [0] * len(inputs)
    for x in inputs:
        if x.is_cuda:             # the shards' streams read these
            torch.cuda.synchronize(x.device)
    B = inputs[0].shape[dims[0]]
    out = []
    for k, dev in enumerate(devices):
        lo, hi = shard_bounds(B, k, len(devices))
        if hi == lo:
            continue
        xs = [x.narrow(d, lo, hi - lo) for x, d in zip(inputs, dims)]
        if dev.type != "cuda":
            out.append((None, fn(*(x.to(dev).contiguous() for x in xs))))
            continue
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if len(devices) == 1:
            with torch.cuda.device(dev):
                out.append((None, fn(*(x.to(dev).contiguous()
                                       for x in xs))))
            continue
        stream = torch.cuda.Stream(dev)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            out.append((stream, fn(*(x.to(dev).contiguous() for x in xs))))
    return out


def wait_shards(launched) -> list:
    """Each shard's outputs, its stream finished."""
    for stream, _ in launched:
        if stream is not None:
            stream.synchronize()
    return [outs for _, outs in launched]


def gather_shards(launched, device=None) -> tuple:
    """The shards' outputs concatenated along the block axis on `device`
    (the first shard's by default)."""
    parts = wait_shards(launched)
    device = device or parts[0][0].device
    return tuple(torch.cat([p[k].to(device) for p in parts])
                 for k in range(len(parts[0])))


def sharded_poa_round(devices, base, pred, seq, slen, nvalid, sink, par,
                      local: bool = True):
    """One batched POA fill + traceback (ops/poa_batch.poa_batch, the
    function of the XLA `_make_fn`) with the block batch sharded over the
    devices; returns (out, outpos, bv) on the first device."""
    from ..ops.poa_batch import poa_batch
    return gather_shards(launch_shards(
        devices, lambda *x: poa_batch(*x, local),
        [base, pred, seq, slen, nvalid, sink, par],
        dims=[1, 1, 0, 0, 0, 0, 0]), torch.device(devices[0]))


def sharded_pallas_round(devices, slen, nv, par, ninfo, seq, *, VW: int,
                         LW: int, P: int, local: bool = True):
    """One per-round POA kernel launch (ops/poa_round.poa_round, the port
    of `_pallas_fn`) with the block batch sharded over the devices.  Takes
    the Pallas kernel's inputs at (VW, LW, P), as the JAX function does;
    returns poa_round's (codes, meta) on the first device."""
    from ..ops.poa_round import from_pallas_layout, poa_round
    ins = from_pallas_layout(slen, nv, par, ninfo, seq, P)
    if ins[3].shape[1] != VW or ins[6].shape[1] != LW - 1:
        raise ValueError(f"inputs are not at VW {VW}, LW {LW}")
    return gather_shards(launch_shards(
        devices, lambda *x: poa_round(*x, local), list(ins)),
        torch.device(devices[0]))


def dp_train_step(devices, base, pred, seq, slen, nvalid, sink, par,
                  local: bool = True):
    """Alias of sharded_poa_round, the name the JAX package's multichip
    dry run calls: one data-parallel smoothing step (fill + traceback)."""
    return sharded_poa_round(devices, base, pred, seq, slen, nvalid, sink,
                             par, local=local)
