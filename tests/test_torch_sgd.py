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
  * csrc/sgd.cu compiled against the CUDA emulation, its plan kernel
    bit-identical to `sgd_plan_reference` and its chain kernel's x to
    `sgd_reference` on the same draws: one minibatch, two iterations of
    four, a hub node that every term's i1 hits, and one plan applied to
    two different x (the plan does not depend on x);
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


@pytest.fixture(scope="module")
def sgd_exe(tmp_path_factory):
    return cuda_emu.build("sgd", str(tmp_path_factory.mktemp("sgd_emu")))


def _inputs(prob, i1, z, sgn, eta):
    arr = prob.tensors(torch.device("cpu"))
    return (i1, z, sgn, arr["node"], arr["pos"], arr["start"],
            arr["count"], float(eta))


def _hold(exe, x, ins):
    """The emulated plan and chain on x against the plain versions: the
    plan's words and the new x bit for bit.  Returns (x, plan)."""
    want = sgd.sgd_reference(x.clone(), *ins)
    xk, plan = cuda_emu.run_sgd(exe, x, *ins, timeout=120)
    assert torch.equal(plan, sgd.sgd_plan_reference(*ins))
    assert torch.equal(xk, want)
    return xk, plan


def test_kernel_emulated_matches_plain_version(gfa, sgd_exe):
    """csrc/sgd.cu on the CUDA emulation, two iterations of four
    minibatches on the card's draws' layout: plan and x bit-identical."""
    g, _ = _shuffled(gfa)
    prob = sgd.sgd_problem(g)
    arr = prob.tensors(torch.device("cpu"))
    gen = torch.Generator().manual_seed(3)
    x = torch.from_numpy(prob.x0.astype(np.float32))
    for eta, cap in zip(prob.etas(2), (prob.zipf_space, 1000)):
        d = sgd.sgd_draws(gen, prob.T, prob.B_pad, arr["cdf"], cap)
        x, _ = _hold(sgd_exe, x, _inputs(prob, *d, eta))
    assert not torch.equal(x, torch.from_numpy(prob.x0.astype(np.float32)))


def test_kernel_emulated_one_minibatch(gfa, sgd_exe):
    prob = sgd.sgd_problem(read_gfa(gfa).compact())
    arr = prob.tensors(torch.device("cpu"))
    d = sgd.sgd_draws(torch.Generator().manual_seed(4), prob.T,
                      sgd.MINIBATCH, arr["cdf"], prob.zipf_space)
    x0 = torch.from_numpy(prob.x0.astype(np.float32))
    x, plan = _hold(sgd_exe, x0, _inputs(prob, *d, prob.etas(1)[0]))
    assert plan.numel() == sgd.plan_words(sgd.MINIBATCH)
    assert not torch.equal(x, x0)


def test_kernel_emulated_hub_node(gfa, sgd_exe):
    """Every term's i1 on one step: its node heads a run of at least 1,024
    pairs, which one thread folds in order."""
    prob = sgd.sgd_problem(read_gfa(gfa).compact())
    arr = prob.tensors(torch.device("cpu"))
    B = 2 * sgd.MINIBATCH
    _, z, sgn = sgd.sgd_draws(torch.Generator().manual_seed(5), prob.T, B,
                              arr["cdf"], prob.zipf_space)
    i1 = torch.full((B,), prob.T // 3, dtype=torch.int32)
    x, plan = _hold(sgd_exe, torch.from_numpy(prob.x0.astype(np.float32)),
                    _inputs(prob, i1, z, sgn, prob.etas(1)[0]))
    runs = plan[4 * B:6 * B]
    assert int((runs[runs < 0] >> 11 & 0xfff).max()) >= sgd.MINIBATCH


def test_plan_does_not_depend_on_x(gfa, sgd_exe):
    """One plan, made once, applied by the emulated chain to two different
    x: each equals the plain version on that x.  On the CPU the wrappers
    run the plain versions, plan or no plan."""
    g, _ = _shuffled(gfa)
    prob = sgd.sgd_problem(g)
    arr = prob.tensors(torch.device("cpu"))
    d = sgd.sgd_draws(torch.Generator().manual_seed(6), prob.T, prob.B_pad,
                      arr["cdf"], 1000)
    ins = _inputs(prob, *d, prob.etas(3)[2])
    plan = sgd.sgd_plan(*ins)
    assert torch.equal(plan, sgd.sgd_plan_reference(*ins))
    xa = torch.from_numpy(prob.x0.astype(np.float32))
    xb = xa[torch.randperm(len(xa), generator=torch.Generator()
                           .manual_seed(7))].contiguous()
    for x in (xa, xb):
        want = sgd.sgd_reference(x.clone(), *ins)
        got, same = cuda_emu.run_sgd(sgd_exe, x, *ins, plan=plan,
                                     timeout=120)
        assert torch.equal(same, plan)
        assert torch.equal(got, want)
        assert torch.equal(sgd.sgd_iter(x.clone(), *ins, plan=plan), want)
    with pytest.raises(ValueError, match="sgd_iter wants"):
        sgd.sgd_plan(ins[0][:100], *ins[1:])


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


def test_cuts_apply_to_the_chain_kernel(gfa, tmp_path):
    """tools/sgd_cuts.py's timing-only variants are compile-time switches of
    csrc/sgd.cu: the source with every cut still compiles (against the
    emulation), and its chain of a cluster of 2 thread blocks instead of 8
    is still a valid kernel, bit-identical to the plain version."""
    from smoothxg_tpu_torch.tools import sgd_cuts
    assert sgd_cuts.defines(("loads", "stores", "cluster 2")) == [
        "SGD_CLUSTER=2", "SGD_CUTS=3"]
    assert sgd_cuts.defines(()) == []
    every = sgd_cuts.defines(("stores", "loads", "fold", "barriers"))
    assert every == ["SGD_CUTS=15"]
    cuda_emu.build("sgd", str(tmp_path / "emu"), every)
    exe = cuda_emu.build("sgd", str(tmp_path / "emu2"),
                         sgd_cuts.defines(("cluster 2",)))
    prob = sgd.sgd_problem(read_gfa(gfa).compact())
    arr = prob.tensors(torch.device("cpu"))
    d = sgd.sgd_draws(torch.Generator().manual_seed(8), prob.T, prob.B_pad,
                      arr["cdf"], prob.zipf_space)
    _hold(exe, torch.from_numpy(prob.x0.astype(np.float32)),
          _inputs(prob, *d, prob.etas(1)[0]))
