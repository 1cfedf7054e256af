"""ROADMAP C3 on a pair past 46,340 bp: the JAX package's banded identity
(smoothxg_tpu/ops/ident_jax.py:_compiled) computes the window's first
column from i * lb in int32, which wraps once i * lb passes 2^31 - 1, and
reports another identity than its numpy mirror (which computes in Python
integers); the port computes it in int64 on every route and agrees with
the mirror.  (One pair of 46,400 rows on each route, ~40 s, alone in its
file.)"""
import numpy as np

import jax.numpy as jnp

from smoothxg_tpu.ops import ident_jax
from smoothxg_tpu_torch.ops import ident_cuda as ic

L = 46_400          # the last rows' i * lb pass 2^31 - 1


def test_pair_past_the_int32_center_bound():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 4, L)
    b = a.copy()
    hits = rng.integers(0, L, L // 50)
    b[hits] = (b[hits] + 1) % 4
    sa, sb = ("".join("ACGT"[i] for i in s) for s in (a, b))
    assert L * L > 2 ** 31 - 1
    want = ic.host_banded_identity(sa, sb, return_counts=True)
    # the JAX function at this very length (one pair, 128 columns)
    av, bv = ident_jax._prep_pair(sa, sb)
    fn = ident_jax._compiled(1, L, 128, 7, 11, 1)
    res = fn(jnp.asarray(av[None].astype(np.int32)),
             jnp.asarray(bv[None].astype(np.int32)),
             jnp.asarray([L], jnp.int32), jnp.asarray([L], jnp.int32))
    jax_counts = tuple(int(np.asarray(v)[0]) for v in res)
    assert jax_counts != want
    mine = ic.DeviceBandedIdentity(device="cpu").identities([(sa, sb)])[0]
    assert mine == ic.identity_from_counts(*want[1:]) > 0.95
