"""The port's path-SGD routes (smoothxg_tpu_torch/ops/sgd.py) against the JAX
package's (smoothxg_tpu/ops/sgd.py) on small seeded pangenomes:

  * the plain version `sgd_reference` on draws re-derived with the public
    jax.random calls of `_compiled_run` (:73-84), against `_compiled_run`
    itself, two iterations of four minibatches: x within rtol 1e-5 (the
    two sum each minibatch's contributions in the same order, the n1 side
    then the n2 side in term order, so on this CPU they agree bit for bit;
    the tolerance leaves XLA free to contract a multiply-add);
  * the quality of the batched route (the port's "cpu" and the JAX
    package's "cpu") against the native backend on a shuffled node order:
    mean step rank-jump within 1.2x (the bound of
    tests/test_parallel.py:186-208);
  * the routes: "auto" below SGD_DEVICE_MIN_TERMS is the native backend,
    at or above it the card, which without CUDA raises "CUDA required";
  * csrc/sgd.cu compiled against the CUDA emulation, bit-identical to the
    plain version on the same draws;
  * the draws, and the JAX route's float32 i1 (ROADMAP C8)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smoothxg_tpu.io.gfa import read_gfa as jax_read_gfa
from smoothxg_tpu.ops import sgd as jax_sgd
from smoothxg_tpu_torch.io.gfa import read_gfa
from smoothxg_tpu_torch.ops import sgd
from smoothxg_tpu_torch.testing import cuda_emu
from smoothxg_tpu_torch.testing.synth import write_pangenome

SEED = 9399527


@pytest.fixture(scope="module")
def gfa(tmp_path_factory):
    return write_pangenome(str(tmp_path_factory.mktemp("sgd") / "g.gfa"),
                           haplotypes=8, length=20_000, seed=5)


def _pad(a, size, fill=0):
    out = np.full(size, fill, dtype=a.dtype)
    out[:len(a)] = a
    return out


def jax_run_and_draws(prob, iters: int):
    """x after `iters` iterations of the JAX package's _compiled_run, on
    the arrays padded as its path_sgd_order pads them, and the draws of
    each iteration re-derived as its `one_iter` splits the key."""
    T_pad, Z_pad = jax_sgd._bucket(prob.T), jax_sgd._bucket(prob.zipf_space)
    n = len(prob.x0)
    cdf = jnp.asarray(_pad(prob.cdf.astype(np.float32), Z_pad, fill=1.0))
    caps = prob.caps(iters, 0.5)
    T = jnp.float32(prob.T)
    x = jax_sgd._compiled_run(prob.B_pad, iters)(
        jnp.asarray(_pad(prob.x0.astype(np.float32), jax_sgd._bucket(n))),
        jax.random.PRNGKey(SEED), jnp.asarray(_pad(prob.node, T_pad)),
        jnp.asarray(_pad(prob.pos, T_pad).astype(np.float32)),
        jnp.asarray(_pad(prob.start, T_pad)),
        jnp.asarray(_pad(prob.count, T_pad, fill=1)), cdf,
        jnp.asarray(prob.etas(iters)), jnp.asarray(caps, dtype=jnp.int32), T)
    key = jax.random.PRNGKey(SEED)
    draws = []
    for t in range(iters):
        key, k1, k2, k3 = jax.random.split(key, 4)
        u1 = jax.random.uniform(k1, (prob.B_pad,))
        i1 = jnp.minimum((u1 * T).astype(jnp.int32), T.astype(jnp.int32) - 1)
        u = jax.random.uniform(k2, (prob.B_pad,))
        z = jnp.minimum(jnp.searchsorted(cdf, u) + 1, caps[t])
        sgn = jnp.where(jax.random.bernoulli(k3, 0.5, (prob.B_pad,)), 1, -1)
        draws.append(tuple(torch.from_numpy(np.asarray(v).astype(dt))
                           for v, dt in ((i1, np.int32), (z, np.int32),
                                         (sgn, np.int8))))
    return np.asarray(x)[:n], draws


def test_plain_version_matches_jax_compiled_run(gfa):
    prob = sgd.sgd_problem(read_gfa(gfa).compact())
    assert prob.B_pad == 4096          # four minibatches an iteration
    xj, draws = jax_run_and_draws(prob, 2)
    arr = prob.tensors(torch.device("cpu"))
    x = torch.from_numpy(prob.x0.astype(np.float32))
    for t, eta in enumerate(prob.etas(2)):
        sgd.sgd_reference(x, *draws[t], arr["node"], arr["pos"],
                          arr["start"], arr["count"], float(eta))
    np.testing.assert_allclose(x.numpy(), xj, rtol=1e-5, atol=0)
    assert not np.allclose(x.numpy(), prob.x0)      # the layout moved


def _shuffled(gfa):
    """Each package's graph in one random node order, so the sort has
    work to do (the generator's own order is already path-coherent)."""
    g, gj = read_gfa(gfa).compact(), jax_read_gfa(gfa).compact()
    ids = list(g.node_ids())
    perm = [ids[i] for i in np.random.default_rng(0).permutation(len(ids))]
    return g.compact(perm), gj.compact(perm)


def rank_jump(g, order) -> float:
    rank = {nid: i for i, nid in enumerate(order)}
    tot = n = 0
    for steps in g.path_steps:
        rs = [rank[h >> 1] for h in steps]
        tot += sum(abs(b - a) for a, b in zip(rs, rs[1:]))
        n += max(len(rs) - 1, 0)
    return tot / max(n, 1)


def test_batched_routes_match_native_quality(gfa):
    g, gj = _shuffled(gfa)
    before = rank_jump(g, list(g.node_ids()))
    rn = rank_jump(g, sgd.path_sgd_order(g, device="native"))
    rc = rank_jump(g, sgd.path_sgd_order(g, device="cpu"))
    rj = rank_jump(gj, jax_sgd.path_sgd_order(gj, device="cpu"))
    assert rn < before / 5
    assert rc <= 1.2 * rn, (rc, rn)
    assert rj <= 1.2 * rn, (rj, rn)


def test_batched_route_is_deterministic(gfa):
    g, _ = _shuffled(gfa)
    prob = sgd.sgd_problem(g)
    a = sgd.sgd_solve(prob, 3, device="cpu")
    b = sgd.sgd_solve(prob, 3, device="cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, sgd.sgd_solve(prob, 3, seed=1, device="cpu"))


def test_steps_are_the_solve_loop_and_time_the_plain_route(gfa):
    """tools/time_sgd.py times `sgd_steps`, sgd_solve's own loop: its
    steps give sgd_solve's bytes, and its CPU estimate covers the draws
    and the plain version of each timed iteration."""
    from smoothxg_tpu_torch.tools import time_sgd
    g, _ = _shuffled(gfa)
    prob = sgd.sgd_problem(g)
    for step in sgd.sgd_steps(prob, 3, device="cpu"):
        x = step()
    assert torch.equal(x, sgd.sgd_solve(prob, 3, device="cpu"))
    with pytest.raises(ValueError, match="iter_max"):
        next(sgd.sgd_steps(prob, 0, device="cpu"))
    est = time_sgd.time_plain_cpu(prob, 2, iter_max=3)
    assert est["cpu_iters"] == 2 and est["cpu_plain_s_iter"] > 0
    assert est["cpu_route_s_estimate"] == pytest.approx(
        3 * (est["cpu_draws_s_iter"] + est["cpu_plain_s_iter"]))


def test_auto_routes_by_term_updates(gfa, monkeypatch):
    """Below SGD_DEVICE_MIN_TERMS "auto" is the native backend; at or
    above it, `auto_device` (the card by default, which without CUDA
    raises "CUDA required" and never falls back)."""
    g = read_gfa(gfa).compact()
    assert sgd.path_sgd_order(g) == sgd.path_sgd_order(g, device="native")
    T = sgd.sgd_problem(g).T
    factor = -(-sgd.SGD_DEVICE_MIN_TERMS // T)      # B >= the threshold
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA required"):
        sgd.path_sgd_order(g, min_term_updates_factor=factor)
    seen = []
    monkeypatch.setattr(sgd, "sgd_solve",
                        lambda prob, *a: seen.append((prob.B, a[-1]))
                        or torch.from_numpy(prob.x0.astype(np.float32)))
    sgd.path_sgd_order(g, min_term_updates_factor=factor, auto_device="cpu")
    sgd.path_sgd_order(g, device="cuda")
    assert seen == [(factor * T, "cpu"), (T, "cuda")]
    with pytest.raises(ValueError, match="unknown SGD device"):
        sgd.path_sgd_order(g, device="default")


def test_prep_passes_the_run_device(gfa, monkeypatch):
    from smoothxg_tpu_torch.pipeline import prep
    seen = []
    real = sgd.path_sgd_order
    monkeypatch.setattr(sgd, "path_sgd_order", lambda g, **kw: seen.append(
        kw["auto_device"]) or real(g, **kw))
    for dev in ("cpu", "cuda", torch.device("cpu")):
        prep.prep(read_gfa(gfa), 100, device=dev)
    assert seen == ["cpu", "cuda", "cpu"]


def test_kernel_emulated_matches_plain_version(gfa, tmp_path):
    """csrc/sgd.cu on the CUDA emulation, two iterations of four
    minibatches on the card's draws' layout: x bit-identical."""
    g, _ = _shuffled(gfa)
    prob = sgd.sgd_problem(g)
    arr = prob.tensors(torch.device("cpu"))
    exe = cuda_emu.build("sgd", str(tmp_path / "sgd"))
    gen = torch.Generator().manual_seed(3)
    x = torch.from_numpy(prob.x0.astype(np.float32))
    xk = x.clone()
    for eta, cap in zip(prob.etas(2), (prob.zipf_space, 1000)):
        d = sgd.sgd_draws(gen, prob.T, prob.B_pad, arr["cdf"], cap)
        ins = (*d, arr["node"], arr["pos"], arr["start"], arr["count"],
               float(eta))
        sgd.sgd_iter(x, *ins)
        xk = cuda_emu.run_sgd(exe, xk, *ins)
        assert torch.equal(xk, x)
    assert not torch.equal(x, torch.from_numpy(prob.x0.astype(np.float32)))


def test_draws():
    cdf = torch.from_numpy(sgd._zipf_cdf(50, 0.99).astype(np.float32))
    a = sgd.sgd_draws(torch.Generator().manual_seed(7), 1000, 4096, cdf, 20)
    b = sgd.sgd_draws(torch.Generator().manual_seed(7), 1000, 4096, cdf, 20)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    i1, z, sgn = a
    assert i1.dtype == z.dtype == torch.int32 and sgn.dtype == torch.int8
    assert 0 <= int(i1.min()) and int(i1.max()) < 1000
    assert 1 <= int(z.min()) and int(z.max()) == 20
    assert set(sgn.tolist()) == {-1, 1}


def test_jax_float_draw_misses_steps_past_2_23():
    """ROADMAP C8: jax.random.uniform's float32 carries 23 random bits, so
    floor(u * T) reaches at most 2^23 of T steps (at T = 10^8, 91.6% are
    never drawn as i1); the port's integer draw reaches them."""
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (4096,)))
    assert np.array_equal(u * 2 ** 23, np.floor(u * 2 ** 23))
    T = 100_000_000
    grid = (np.arange(2 ** 23, dtype=np.float32) / np.float32(2 ** 23))
    reach = np.unique(np.minimum((grid * np.float32(T)).astype(np.int64),
                                 T - 1))
    assert len(reach) == 2 ** 23
    i1 = torch.randint(0, T, (20_000,),
                       generator=torch.Generator().manual_seed(1)).numpy()
    missed = ~np.isin(i1, reach)
    assert missed.mean() > 0.9
