"""Path-guided 1D SGD graph sort: the native C++ host backend
(csrc/host/sgd.cpp) and the batched route on the GPU (csrc/sgd.cu).

Equivalent capability to odgi's path_linear_sgd_order used by the reference's
prep stage (reference: src/prep.cpp:30-125; hyperparameters: iter_max=100,
zipf theta=0.99, eps=0.01, cooling at 0.5, eta_max=max_path_step_count^2,
min_term_updates = factor * sum_path_step_count, seed "pangenomic!").
Terms sample a step uniformly, a second step of the same path at a
zipf-distributed rank distance, and pull the two nodes' 1D positions toward
their nucleotide distance along the path.

Routes (`path_sgd_order(device=...)`, named after the JAX package's):
  * "native": sequential updates on the host — the exact semantics the
    reference's Hogwild threads approximate;
  * "cuda": the batched route of smoothxg_tpu/ops/sgd.py:_compiled_run on
    the card, two launches of the hand-written kernels of csrc/sgd.cu an
    iteration (`sgd_plan`, then `sgd_iter`'s chain); the JAX package's
    "default";
  * "cpu": the same batched route through its plain PyTorch version,
    `sgd_reference`, on the host (the JAX package's "cpu");
  * "auto": "native" below SGD_DEVICE_MIN_TERMS term updates an iteration,
    `auto_device` ("cuda" unless the caller says "cpu") at or above.  It
    never falls back: without a card the "cuda" route raises "CUDA
    required".

The batched route: an iteration applies B_pad = ceil(_bucket(B) / 1024) *
1024 term updates as B_pad / 1024 sequential minibatches, conflict-averaged
within a minibatch (x[n] += acc[n] / max(cnt[n], 1)) and compounding across
them; float32 positions and x; then a stable argsort of x.  The draws (i1
uniform over the steps, the zipf rank z by searchsorted on the float32 CDF
capped by the iteration's cap, the sign) come from a torch.Generator seeded
from `seed` on the run's device, one iteration at a time (`sgd_draws`).
They cannot reproduce jax.random's streams, so the route matches the JAX
package on quality (rank-jump), and on the same draws within float
rounding.  i1 is drawn as an integer: the JAX package's floor(u * T) from a
float32 uniform reaches at most 2^23 distinct steps (ROADMAP C8).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..graph.mutable import MutableGraph

# "auto" takes the batched route at or above this many term updates an
# iteration (the JAX package's threshold, smoothxg_tpu/ops/sgd.py:242)
SGD_DEVICE_MIN_TERMS = 5_000_000
MINIBATCH = 1024


def _zipf_cdf(n: int, theta: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-theta)
    cdf = np.cumsum(w)
    return cdf / cdf[-1]


def _bucket(v: int, base: float = 1.3, floor: int = 256) -> int:
    b = floor
    while b < v:
        b = int(np.ceil(b * base))
    return b


_NATIVE = None
_NATIVE_TRIED = False


def _native_lib():
    """ctypes handle to csrc/host/sgd.cpp built with g++ (sequential /
    Hogwild host backend); None when it does not build."""
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE is not None or _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True

    from ._build import host_lib
    path = host_lib("sgd")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    i64 = ctypes.c_int64
    f64 = ctypes.c_double
    p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    pd = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.sgd_solve.restype = None
    lib.sgd_solve.argtypes = [i64, p32, pd, p32, p32, i64, pd, i64, f64,
                              f64, f64, i64, ctypes.c_uint64,
                              ctypes.c_int32, pd]
    _NATIVE = lib
    return _NATIVE


@dataclass
class SGDProblem:
    """A graph's SGD layout: flat step arrays over all paths (node index,
    position of the node's center along the path, the path's first step
    and step count), the zipf CDF over ranks 1..zipf_space, the learning
    rate schedule (eta_max, lam), B term updates an iteration and the
    initial positions x0 (node centers in node order)."""
    node_ids: list
    node: np.ndarray       # (T,) int32
    pos: np.ndarray        # (T,) float64
    start: np.ndarray      # (T,) int32
    count: np.ndarray      # (T,) int32
    zipf_space: int
    cdf: np.ndarray        # (zipf_space,) float64
    eta_max: float
    lam: float
    B: int
    x0: np.ndarray         # (n,) float64

    @property
    def T(self) -> int:
        return len(self.node)

    @property
    def B_pad(self) -> int:
        """Term updates an iteration on the batched route: whole
        minibatches."""
        return -(-_bucket(self.B) // MINIBATCH) * MINIBATCH

    def etas(self, iter_max: int) -> np.ndarray:
        """The float32 learning rate of each iteration."""
        return (self.eta_max * np.exp(-self.lam * np.arange(iter_max))
                ).astype(np.float32)

    def caps(self, iter_max: int, cooling_start: float) -> list[int]:
        """The zipf rank cap of each iteration: the whole zipf space
        before iter_max * cooling_start, at most 1000 after."""
        return [self.zipf_space if t < iter_max * cooling_start
                else min(self.zipf_space, 1000) for t in range(iter_max)]

    def tensors(self, dev: torch.device) -> dict:
        """The step arrays and the CDF on `dev`, float32 as the kernel
        takes them."""
        return {"node": torch.from_numpy(self.node).to(dev),
                "pos": torch.from_numpy(self.pos.astype(np.float32)).to(dev),
                "start": torch.from_numpy(self.start).to(dev),
                "count": torch.from_numpy(self.count).to(dev),
                "cdf": torch.from_numpy(self.cdf.astype(np.float32)).to(dev)}


def sgd_problem(g: MutableGraph, iter_max: int = 100, eps: float = 0.01,
                theta: float = 0.99, min_term_updates_factor: float = 1.0
                ) -> SGDProblem | None:
    """The SGD layout of `g`; None when there is nothing to sort (at most
    one node, or no path steps)."""
    node_ids = list(g.node_ids())
    n = len(node_ids)
    if n <= 1:
        return None
    ids_arr = np.fromiter(node_ids, dtype=np.int64, count=n)
    # dense lookup: node id -> index in node_ids (ids are small ints)
    lut = np.full(int(ids_arr.max()) + 1, -1, dtype=np.int32)
    lut[ids_arr] = np.arange(n, dtype=np.int32)
    node_len = np.array([len(g.seqs[nid]) for nid in node_ids],
                        dtype=np.float64)

    # flat step arrays over all paths (vectorized per path)
    per_path = []
    for steps in g.path_steps:
        if not steps:
            per_path.append((np.zeros(0, np.int32), np.zeros(0, np.float64)))
            continue
        ix = lut[np.asarray(steps, dtype=np.int64) >> 1]
        ln = node_len[ix]
        pos = np.cumsum(ln) - ln / 2.0
        per_path.append((ix.astype(np.int32), pos))
    lens = [len(ix) for ix, _ in per_path]
    T = int(sum(lens))
    if T == 0:
        return None
    offs = np.cumsum([0] + lens[:-1])
    max_steps = max(lens) if lens else 1
    zipf_space = int(max(2, max_steps))
    eta_max = float(max_steps) ** 2
    return SGDProblem(
        node_ids=node_ids,
        node=np.concatenate([ix for ix, _ in per_path]),
        pos=np.concatenate([p for _, p in per_path]),
        start=np.repeat(offs.astype(np.int32), lens),
        count=np.repeat(np.asarray(lens, np.int32), lens),
        zipf_space=zipf_space, cdf=_zipf_cdf(zipf_space, theta),
        eta_max=eta_max,
        lam=float(np.log(eta_max / eps) / max(iter_max - 1, 1)),
        B=max(int(min_term_updates_factor * T), 1),
        # init positions at current vector offsets (node center)
        x0=np.cumsum(node_len) - node_len / 2.0)


def path_sgd_order(
    g: MutableGraph,
    iter_max: int = 100,
    eps: float = 0.01,
    theta: float = 0.99,
    cooling_start: float = 0.5,
    min_term_updates_factor: float = 1.0,
    seed: int = 9399527, # fnv-ish hash of "pangenomic!"
    device: str = "auto",
    threads: int = 1,
    auto_device: str = "cuda",
) -> list[int]:
    """Returns node ids ordered by their optimized 1D position.

    device: "native", "cuda", "cpu" or "auto" (module docstring); "auto"
    takes `auto_device` at or above SGD_DEVICE_MIN_TERMS term updates an
    iteration.
    threads: Hogwild worker count for the native backend (>1 is racy and
    non-deterministic, like the reference; the pipeline keeps 1)."""
    prob = sgd_problem(g, iter_max, eps, theta, min_term_updates_factor)
    if prob is None:
        return list(g.node_ids())
    route = device
    if device == "auto":
        route = "native" if prob.B < SGD_DEVICE_MIN_TERMS else auto_device
    if route == "native":
        x = native_solve(prob, iter_max, cooling_start, seed, threads)
    elif route in ("cuda", "cpu"):
        x = sgd_solve(prob, iter_max, cooling_start, seed, route)
        x = x.cpu().numpy().astype(np.float64)
    else:
        raise ValueError(f"unknown SGD device {device!r} "
                         f"(auto, native, cuda or cpu)")
    order = np.argsort(x, kind="stable")
    return [prob.node_ids[i] for i in order]


def native_solve(prob: SGDProblem, iter_max: int, cooling_start: float,
                 seed: int, threads: int = 1) -> np.ndarray:
    """Final positions from the native C++ backend (float64)."""
    lib = _native_lib()
    if lib is None:
        raise RuntimeError("native SGD backend unavailable "
                           "(csrc/host/sgd.cpp failed to build)")
    x = prob.x0.copy()
    lib.sgd_solve(prob.T, np.ascontiguousarray(prob.node),
                  np.ascontiguousarray(prob.pos),
                  np.ascontiguousarray(prob.start),
                  np.ascontiguousarray(prob.count),
                  prob.zipf_space, np.ascontiguousarray(prob.cdf),
                  iter_max, prob.eta_max, float(prob.lam),
                  cooling_start, prob.B, seed, max(int(threads), 1), x)
    return x


def sgd_solve(prob: SGDProblem, iter_max: int = 100,
              cooling_start: float = 0.5, seed: int = 9399527,
              device: str | torch.device = "cuda") -> torch.Tensor:
    """Final float32 positions from the batched route on `device` ("cuda":
    the kernel; "cpu": its plain version): iter_max iterations of
    prob.B_pad term updates, each drawn on the device and applied by
    `sgd_iter`."""
    for step in sgd_steps(prob, iter_max, cooling_start, seed, device):
        x = step()
    return x


def sgd_steps(prob: SGDProblem, iter_max: int = 100,
              cooling_start: float = 0.5, seed: int = 9399527,
              device: str | torch.device = "cuda"):
    """`sgd_solve`'s loop, one iteration at a time: draws an iteration's
    terms, then yields the call that applies them (a partial of
    `sgd_iter`, which plans and applies them; it returns x).  So a caller
    that times the call times the launches alone, or makes the plan
    itself from the partial's arguments and passes it as `plan=`
    (tools/time_sgd.py)."""
    from ..device import resolve
    if iter_max < 1:
        raise ValueError(f"iter_max must be at least 1: {iter_max}")
    dev = resolve(device, what=f"path SGD at {prob.B} term updates an "
                  f"iteration takes its CUDA kernels (csrc/sgd.cu)",
                  instead="pass device='native' or 'cpu' for a host run")
    arr = prob.tensors(dev)
    x = torch.from_numpy(prob.x0.astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    etas = prob.etas(iter_max)
    for t, cap in enumerate(prob.caps(iter_max, cooling_start)):
        i1, z, sgn = sgd_draws(gen, prob.T, prob.B_pad, arr["cdf"], cap)
        yield functools.partial(sgd_iter, x, i1, z, sgn, arr["node"],
                                arr["pos"], arr["start"], arr["count"],
                                float(etas[t]))


def sgd_draws(gen: torch.Generator, T: int, B: int, cdf: torch.Tensor,
              cap: int) -> tuple:
    """One iteration's draws on the generator's device: i1 (B,) int32
    uniform over [0, T), z (B,) int32 the zipf rank searchsorted(cdf, u) +
    1 capped at `cap`, sgn (B,) int8 +1 or -1."""
    dev = cdf.device
    i1 = torch.randint(0, T, (B,), generator=gen, device=dev,
                       dtype=torch.int32)
    u = torch.rand(B, generator=gen, device=dev, dtype=torch.float32)
    z = torch.searchsorted(cdf, u).add_(1).clamp_max_(cap).to(torch.int32)
    sgn = torch.randint(0, 2, (B,), generator=gen, device=dev,
                        dtype=torch.int8).mul_(2).sub_(1)
    return i1, z, sgn


def _check(x, i1, z, sgn, node, pos, start, count) -> None:
    """x may be None (the plan takes no x)."""
    dev = i1.device
    want = ((i1, torch.int32), (z, torch.int32), (sgn, torch.int8),
            (node, torch.int32), (pos, torch.float32),
            (start, torch.int32), (count, torch.int32))
    if x is not None:
        want = ((x, torch.float32),) + want
    for t, dt in want:
        if t.dtype != dt or t.device != dev or t.dim() != 1 \
                or not t.is_contiguous():
            raise ValueError(f"sgd_iter wants contiguous 1-D {dt} tensors "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    B = i1.numel()
    if B % MINIBATCH or z.numel() != B or sgn.numel() != B:
        raise ValueError(f"sgd_iter wants B a multiple of {MINIBATCH} "
                         f"draws of each kind")
    T = node.numel()
    if pos.numel() != T or start.numel() != T or count.numel() != T:
        raise ValueError("node, pos, start and count must have T steps")


def plan_words(B: int) -> int:
    """int32 words of an iteration's plan (csrc/sgd.cu): 4 a term (n1, n2,
    d with ok as its sign, mu) and 2 a term (the run words of its two
    pairs)."""
    return 6 * B


def sgd_plan(i1: torch.Tensor, z: torch.Tensor, sgn: torch.Tensor,
             node: torch.Tensor, pos: torch.Tensor, start: torch.Tensor,
             count: torch.Tensor, eta: float) -> torch.Tensor:
    """The plan of one iteration's draws: what csrc/sgd.cu's chain needs
    that does not depend on x (each term's nodes, d, mu and ok; each
    pair's run word, its place in its minibatch's fold order).  CUDA tensors launch sgd_plan_kernel (and
    raise on a launch error); CPU tensors run the plain version,
    `sgd_plan_reference`.  (plan_words(B),) int32."""
    dev = i1.device
    _check(None, i1, z, sgn, node, pos, start, count)
    if dev.type == "cpu":
        return sgd_plan_reference(i1, z, sgn, node, pos, start, count, eta)
    if dev.type != "cuda":
        raise ValueError(f"sgd_plan: unsupported device {dev}")
    from . import _build
    lib = _build.load()
    B = i1.numel()
    plan = torch.empty(plan_words(B), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.sgd_plan_launch(
            node.data_ptr(), pos.data_ptr(), start.data_ptr(),
            count.data_ptr(), i1.data_ptr(), z.data_ptr(), sgn.data_ptr(),
            ctypes.c_float(eta), B, plan.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sgd plan kernel launch failed: CUDA error {rc} "
                           f"({lib.poa_win_error_string(rc).decode()})")
    sgd_plan.launches += 1
    return plan


sgd_plan.launches = 0     # kernel launches made by this wrapper


def sgd_iter(x: torch.Tensor, i1: torch.Tensor, z: torch.Tensor,
             sgn: torch.Tensor, node: torch.Tensor, pos: torch.Tensor,
             start: torch.Tensor, count: torch.Tensor,
             eta: float, plan: torch.Tensor | None = None) -> torch.Tensor:
    """One iteration of len(i1) term updates applied to x in place.  CUDA
    tensors launch csrc/sgd.cu's chain kernel on `plan`, the `sgd_plan` of
    these same draws (made here when it is None), and raise on a launch
    error; CPU tensors run the plain version, `sgd_reference`, which needs
    no plan.  Returns x."""
    _check(x, i1, z, sgn, node, pos, start, count)
    if x.device.type == "cpu":
        return sgd_reference(x, i1, z, sgn, node, pos, start, count, eta)
    if x.device.type != "cuda":
        raise ValueError(f"sgd_iter: unsupported device {x.device}")
    if plan is None:
        plan = sgd_plan(i1, z, sgn, node, pos, start, count, eta)
    B = i1.numel()
    if plan.dtype != torch.int32 or plan.device != x.device \
            or plan.numel() != plan_words(B) or not plan.is_contiguous():
        raise ValueError(f"sgd_iter wants sgd_plan's ({plan_words(B)},) "
                         f"int32 plan on {x.device}")
    from . import _build
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.sgd_chain_launch(x.data_ptr(), plan.data_ptr(), B, stream)
    if rc != 0:
        raise RuntimeError(f"sgd kernel launch failed: CUDA error {rc} "
                           f"({lib.poa_win_error_string(rc).decode()})")
    sgd_iter.launches += 1
    return x


sgd_iter.launches = 0     # chain kernel launches made by this wrapper


def sgd_plan_reference(i1: torch.Tensor, z: torch.Tensor, sgn: torch.Tensor,
                       node: torch.Tensor, pos: torch.Tensor,
                       start: torch.Tensor, count: torch.Tensor, eta: float,
                       mb: int = MINIBATCH) -> torch.Tensor:
    """Plain PyTorch version of csrc/sgd.cu's plan kernel, on any device:
    the terms' nodes, d (negated where the term is not ok) and mu as
    `sgd_reference` computes them, then each minibatch's pairs sorted by
    (node, pair index) into runs of one node, and each pair's run word: a
    head's 1 << 31 | its sorted position | its run's length << 11, any
    other pair's sorted position | its head's pair index << 11.
    Bit-identical to the kernel's plan."""
    dev = i1.device
    B = i1.numel()
    M, P = B // mb, 2 * mb
    a = i1.long()
    sz = sgn.int() * z
    st, cnt = start[a], count[a]
    r1 = a.int() - st
    r2 = r1 + sz
    r2 = torch.where((r2 < 0) | (r2 >= cnt), r1 - sz, r2)
    r2 = torch.minimum(r2.clamp_min(0), cnt - 1)
    b = (st + r2).long()
    n1, n2 = node[a], node[b]
    d = (pos[a] - pos[b]).abs()
    ok = (n1 != n2) & (d > 0)
    d = d.clamp_min(1e-3)
    mu = (torch.tensor(eta, dtype=torch.float32, device=dev) / (d * d)
          ).clamp_max(1.0)
    terms = torch.stack([n1, n2, torch.where(ok, d, -d).view(torch.int32),
                         mu.view(torch.int32)], dim=1)
    keys = torch.cat([n1.view(M, mb), n2.view(M, mb)], dim=1).long()
    skey = torch.sort((keys << 11) | torch.arange(P, device=dev), dim=1
                      ).values
    pair = (skey & (P - 1)).flatten()
    nd = skey >> 11
    head = torch.ones_like(nd, dtype=torch.bool)
    head[:, 1:] = nd[:, 1:] != nd[:, :-1]
    head = head.flatten()
    heads = torch.nonzero(head).squeeze(1)        # each row starts one
    ends = torch.cat([heads[1:], heads.new_tensor([M * P])])
    seg = torch.cumsum(head, 0) - 1
    flat = torch.arange(M * P, device=dev)
    word = torch.where(head, (1 << 31) | (flat % P) | ((ends - heads)[seg]
                                                      << 11),
                       (flat % P) | (pair[heads[seg]] << 11))
    runs = torch.zeros(M * P, dtype=torch.int64, device=dev)
    runs[pair + flat // P * P] = word
    runs = runs.view(M, 2, mb).transpose(1, 2).reshape(-1)
    runs = torch.where(runs >= 1 << 31, runs - (1 << 32), runs)
    return torch.cat([terms.reshape(-1), runs.to(torch.int32)])


def sgd_reference(x: torch.Tensor, i1: torch.Tensor, z: torch.Tensor,
                  sgn: torch.Tensor, node: torch.Tensor, pos: torch.Tensor,
                  start: torch.Tensor, count: torch.Tensor, eta: float,
                  mb: int = MINIBATCH) -> torch.Tensor:
    """Plain PyTorch version of csrc/sgd.cu, on any device, in place on x:
    the minibatches of smoothxg_tpu/ops/sgd.py:_compiled_run's `one_mb` in
    order, with each node's contributions summed from 0.0 in the kernel's
    order (the n1 side in term order, then the n2 side) — one index_add_
    per occurrence rank, so no add has two contributions to one node —
    and x written once per node touched.  Bit-identical to the kernel on
    the same draws."""
    dev = x.device
    eta_t = torch.tensor(eta, dtype=torch.float32, device=dev)
    for s in range(0, i1.numel(), mb):
        a = i1[s:s + mb].long()
        sz = sgn[s:s + mb].int() * z[s:s + mb]
        st, cnt = start[a], count[a]
        r1 = a.int() - st
        r2 = r1 + sz
        r2 = torch.where((r2 < 0) | (r2 >= cnt), r1 - sz, r2)
        r2 = torch.minimum(r2.clamp_min(0), cnt - 1)
        b = (st + r2).long()
        n1, n2 = node[a].long(), node[b].long()
        d = (pos[a] - pos[b]).abs()
        ok = (n1 != n2) & (d > 0)
        d = d.clamp_min(1e-3)
        mu = (eta_t / (d * d)).clamp_max(1.0)
        x1, x2 = x[n1], x[n2]
        dx = x1 - x2
        mag = dx.abs() + 1e-9
        delta = mu * (mag - d) / 2.0
        rr = torch.where(ok, delta / mag, torch.zeros_like(mag))
        upd = rr * dx
        keys = torch.cat([n1, n2])
        vals = torch.cat([-upd, upd])
        hits = torch.cat([ok, ok]).to(torch.float32)
        xs = torch.cat([x1, x2])
        skey, perm = torch.sort(keys, stable=True)
        head = torch.ones_like(skey, dtype=torch.bool)
        head[1:] = skey[1:] != skey[:-1]
        seg = torch.cumsum(head, 0) - 1
        heads = torch.nonzero(head).squeeze(1)
        rank = torch.arange(len(skey), device=dev) - heads[seg]
        acc = torch.zeros(len(heads), dtype=torch.float32, device=dev)
        cn = torch.zeros_like(acc)
        for r in range(int(rank.max()) + 1):
            sel = rank == r
            acc.index_add_(0, seg[sel], vals[perm[sel]])
            cn.index_add_(0, seg[sel], hits[perm[sel]])
        x[skey[heads]] = xs[perm[heads]] + acc / cn.clamp_min(1.0)
    return x
