"""The Hopper micro-probes (smoothxg_tpu_torch/tools/_probe.py,
csrc/probes.cu) against the TPU micro-probes they replace.

Each Pallas body of the JAX package's tools/probe_*.py is a closure inside
its file's main(), so it is transcribed here beside its file:line and run
in interpret mode at a small N; its (1, 128) output must equal the port's
plain version exactly.  Then csrc/probes.cu, compiled against the CUDA
emulation (testing/cuda_emu.h) and run on the CPU, must equal the plain
version for every case and variant.  Interpret mode gives scratch that is
read before it is written as zero, which the port's kernels reproduce; the
masked write case still runs at N >= 4096, where every element has been
written.  Tolerance: none, all outputs are int32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from smoothxg_tpu_torch.testing import cuda_emu
from smoothxg_tpu_torch.tools import _probe as P

DT = jnp.int32
N = 600                       # a multiple of 8: the manual 8x bodies
N_WRITE = 4104                # >= 4096: every element of the plane written


def _pallas(kernel, args=(), scratch=()):
    fn = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((1, 128), DT),
                        scratch_shapes=list(scratch), interpret=True)
    return np.asarray(fn(*args))[0]


def _x7():
    return jnp.asarray(np.arange(32 * 128, dtype=np.int32).reshape(32, 128)
                       % 7)


def _x11():
    return jnp.asarray(np.arange(4096 * 256, dtype=np.int32)
                       .reshape(4096, 256) % 11)


def _pread(inp, v):
    lane128 = jax.lax.broadcasted_iota(DT, (1, 128), 1)
    row = inp[pl.ds(v // 128, 1), :]
    return jnp.max(jnp.where(lane128 == (v % 128), row, -(1 << 30)))


# ---- tools/probe_scalar_latency.py:35-64 (mk) ----
def scalar_latency(kind, n):
    VWr = 32

    def kernel(inp, out):
        if kind == "chase":
            acc = jax.lax.fori_loop(0, n, lambda i, v: _pread(inp, v),
                                    jnp.int32(0))
        elif kind == "indep":
            acc = jax.lax.fori_loop(
                0, n, lambda i, a: a + _pread(inp, i % (VWr * 128)),
                jnp.int32(0))
        else:
            def body(i, acc):
                j = 4 * i
                M = VWr * 128
                return (acc + _pread(inp, j % M) + _pread(inp, (j + 1) % M)
                        + _pread(inp, (j + 2) % M)
                        + _pread(inp, (j + 3) % M))
            acc = jax.lax.fori_loop(0, n // 4, body, jnp.int32(0))
        out[:, :] = jnp.full((1, 128), acc, DT)
    return _pallas(kernel, (_x7(),))


# ---- tools/probe_smem.py:27-55 (mk) ----
def smem(kind, n, SZ):
    def kernel(out, sm):
        def init(i, _):
            sm[i] = (i * 97 + 13) % SZ
            return 0
        jax.lax.fori_loop(0, SZ, init, 0)
        if kind == "chase":
            acc = jax.lax.fori_loop(0, n, lambda i, v: sm[v], jnp.int32(0))
        elif kind == "indep":
            acc = jax.lax.fori_loop(0, n, lambda i, a: a + sm[i % SZ],
                                    jnp.int32(0))
        else:
            def body(i, acc):
                j = i % SZ
                v = sm[j]
                sm[j] = v + 1
                return acc + v
            acc = jax.lax.fori_loop(0, n, body, jnp.int32(0))
        out[:, :] = jnp.full((1, 128), acc, DT)
    return _pallas(kernel, scratch=[pltpu.SMEM((SZ,), DT)])


# ---- tools/probe_loop.py:56-64 (mk_empty), probe_loop2.py:45-52 ----
def loop_empty(unroll, n):
    def kernel(out):
        acc = jax.lax.fori_loop(0, n, lambda i, v: (v * 5 + 1) & 0xFFFF,
                                jnp.int32(1), unroll=unroll)
        out[:, :] = jnp.full((1, 128), acc, DT)
    return _pallas(kernel)


# ---- tools/probe_loop.py:70-84 (mk_smem), probe_loop2.py:54-67 ----
def loop_smem(SZ, unroll, n):
    def kernel(out, sm):
        def init(i, _):
            sm[i] = (i * 97 + 13) % SZ
            return 0
        jax.lax.fori_loop(0, SZ, init, 0)
        acc = jax.lax.fori_loop(0, n, lambda i, v: sm[v], jnp.int32(0),
                                unroll=unroll)
        out[:, :] = jnp.full((1, 128), acc, DT)
    return _pallas(kernel, scratch=[pltpu.SMEM((SZ,), DT)])


# ---- tools/probe_loop2.py:69-84 (mk_smem_u8: 8 reads a body) ----
def loop2_smem_u8(n):
    SZ = 4096

    def kernel(out, sm):
        def init(i, _):
            sm[i] = (i * 97 + 13) % SZ
            return 0
        jax.lax.fori_loop(0, SZ, init, 0)

        def body(i, v):
            for _ in range(8):
                v = sm[v]
            return v
        acc = jax.lax.fori_loop(0, n // 8, body, jnp.int32(0))
        out[:, :] = jnp.full((1, 128), acc, DT)
    return _pallas(kernel, scratch=[pltpu.SMEM((SZ,), DT)])


# ---- tools/probe_loop.py:91-99 (mk_slab) ----
def loop_slab(unroll, n):
    def kernel(inp, out):
        acc = jax.lax.fori_loop(
            0, n, lambda i, a: a + inp[pl.ds(8 * (i % 512), 8), :],
            jnp.zeros((8, 256), DT), unroll=unroll)
        out[:, :] = acc[0:1, 0:128]
    return _pallas(kernel, (_x11(),))


# ---- tools/probe_loop.py:107-122 (mk_mwrite), probe_smem2.py:97-111 ----
def loop_mwrite(n, use_and):
    def kernel(out, pln):
        lane128 = jax.lax.broadcasted_iota(DT, (1, 128), 1)

        def body(i, acc):
            v = (i * 13) & 4095 if use_and else (i * 13) % 4096
            r = v // 128
            m = lane128 == (v % 128)
            row = pln[pl.ds(r, 1), :]
            pln[pl.ds(r, 1), :] = jnp.where(m, acc, row)
            return acc + 1
        acc = jax.lax.fori_loop(0, n, body, jnp.int32(0))
        out[:, :] = pln[0:1, :] + acc
    return _pallas(kernel, scratch=[pltpu.VMEM((32, 128), DT)])


# ---- tools/probe_loop.py:127-140 (mk_mread), probe_loop2.py:86-97 ----
def loop_mread(unroll, n):
    def kernel(inp, out):
        acc = jax.lax.fori_loop(
            0, n, lambda i, a: a + _pread(inp, (i * 13) % 4096),
            jnp.int32(0), unroll=unroll)
        out[:, :] = jnp.full((1, 128), acc, DT)
    return _pallas(kernel, (_x7(),))


# ---- tools/probe_loop2.py:99-112 (mk_mread_u8: 8 reads a body) ----
def loop2_mread_u8(n):
    def kernel(inp, out):
        def body(i, acc):
            for k in range(8):
                acc = acc + _pread(inp, (i * 8 + k) * 13 % 4096)
            return acc
        acc = jax.lax.fori_loop(0, n // 8, body, jnp.int32(0))
        out[:, :] = jnp.full((1, 128), acc, DT)
    return _pallas(kernel, (_x7(),))


# ---- tools/probe_loop2.py:114-124 (mk_chase) ----
def loop2_chase(n):
    def kernel(inp, out):
        acc = jax.lax.fori_loop(0, n, lambda i, v: _pread(inp, v),
                                jnp.int32(0))
        out[:, :] = jnp.full((1, 128), acc, DT)
    return _pallas(kernel, (_x7(),))


# ---- tools/probe_loop2.py:126-136 (mk_slab_u8: 8 slabs a body) ----
def loop2_slab_u8(n):
    def kernel(inp, out):
        def body(i, acc):
            for k in range(8):
                acc = acc + inp[pl.ds(8 * ((i * 8 + k) % 512), 8), :]
            return acc
        acc = jax.lax.fori_loop(0, n // 8, body, jnp.zeros((8, 256), DT))
        out[:, :] = acc[0:1, 0:128]
    return _pallas(kernel, (_x11(),))


# ---- tools/probe_loop2.py:138-150 (mk_vecrow) ----
def loop2_vecrow(n):
    def kernel(inp, out):
        def body(i, acc):
            x = inp[pl.ds(8 * (i % 512), 8), :]
            for _ in range(5):
                x = jnp.maximum(x, acc) + 1
                acc = jnp.where(x > acc, x - 3, acc)
            return acc
        acc = jax.lax.fori_loop(0, n, body, jnp.zeros((8, 256), DT))
        out[:, :] = acc[0:1, 0:128]
    return _pallas(kernel, (_x11(),))


# ---- tools/probe_smem2.py:48-71 (mk_cap) ----
def smem2_cap(n):
    VW = 4096

    def kernel(out, bpp, ring, nxt, npred, nsucc, preds, tgt, path):
        def init(i, _):
            bpp[i] = i
            ring[i] = i
            nxt[i] = i + 1
            npred[i] = 1
            nsucc[i] = 1
            preds[i] = i
            return 0
        jax.lax.fori_loop(0, VW, init, 0)

        def body(i, v):
            j = v & (VW - 1)
            w = bpp[j] + ring[j] + nxt[j] + npred[j] + preds[j]
            nsucc[j] = w & 0xFF
            return (v * 5 + w) & 0xFFFF
        acc = jax.lax.fori_loop(0, n, body, jnp.int32(1))
        out[:, :] = jnp.full((1, 128), acc + nsucc[0], DT)
    return _pallas(kernel, scratch=[pltpu.SMEM((VW,), DT)] * 5
                   + [pltpu.SMEM((VW * 8,), DT), pltpu.SMEM((2048,), DT),
                      pltpu.SMEM((2048,), DT)])


# ---- tools/probe_smem2.py:76-92 (mk_rmw) ----
def smem2_rmw(n):
    SZ = 4096

    def kernel(out, sm):
        def init(i, _):
            sm[i] = i % 7
            return 0
        jax.lax.fori_loop(0, SZ, init, 0)

        def body(i, acc):
            j = i & (SZ - 1)
            v = sm[j]
            sm[j] = v + 1
            return acc + v
        acc = jax.lax.fori_loop(0, n, body, jnp.int32(0))
        out[:, :] = jnp.full((1, 128), acc, DT)
    return _pallas(kernel, scratch=[pltpu.SMEM((4096,), DT)])


# ---- tools/probe_smem2.py:117-143 (mk_fillrow) ----
def smem2_fillrow(n):
    def kernel(inp, out, sm, hh):
        def init(i, _):
            sm[i] = (i * 97 + 13) & 4095
            return 0
        jax.lax.fori_loop(0, 4096, init, 0)

        def body(i, st):
            v, acc = st
            a = sm[v]
            b = sm[(v + 1) & 4095]
            c = sm[(v + 2) & 4095]
            sm[(v + 3) & 4095] = a + 1
            x = inp[pl.ds(8 * (a % 512), 8), :]
            y = hh[pl.ds(8 * (b & 255), 8), :]
            for _ in range(6):
                x = jnp.maximum(x, acc) + 1
                acc = jnp.where(x > acc, x - 3, acc + y)
            hh[pl.ds(8 * (c & 255), 8), :] = acc
            return (sm[v], acc)
        _, acc = jax.lax.fori_loop(
            0, n, body, (jnp.int32(0), jnp.zeros((8, 256), DT)))
        out[:, :] = acc[0:1, 0:128]
    return _pallas(kernel, (_x11(),), [pltpu.SMEM((4096,), DT),
                                       pltpu.VMEM((2048, 256), DT)])


# ---- tools/probe_stack.py:27-47 (mk_step) ----
def stack_step(K, n):
    ROWS, LANES = 8 * K, 256

    def kernel(out, pl_buf):
        lanef = jax.lax.broadcasted_iota(DT, (ROWS, LANES), 1)
        pl_buf[:, :] = lanef

        def body(i, v):
            x = pl_buf[:, :]
            k = 1 + (i & 7)
            r = pltpu.roll(x, 1, axis=1)
            x = jnp.maximum(x, jnp.where(lanef >= k, r, -16000))
            pl_buf[:, :] = x
            return v + 1
        acc = jax.lax.fori_loop(0, n, body, jnp.int32(0))
        out[:, :] = jnp.full((1, 128), acc, DT) + pl_buf[0:1, 0:128]
    return _pallas(kernel, scratch=[pltpu.VMEM((ROWS, LANES), DT)])


# (TPU body, its N) -> the port's case (family, kind, table size or K)
TPU = {
    "probe_scalar_latency:chase": (lambda n: scalar_latency("chase", n),
                                   ("row", "chase")),
    "probe_scalar_latency:indep": (lambda n: scalar_latency("indep", n),
                                   ("row", "indep")),
    "probe_scalar_latency:indep4": (lambda n: scalar_latency("indep4", n),
                                    ("row", "indep4")),
    "probe_smem:chase": (lambda n: smem("chase", n, 4096),
                         ("scalar", "chase")),
    "probe_smem:indep": (lambda n: smem("indep", n, 4096),
                         ("scalar", "indep")),
    "probe_smem:rmw": (lambda n: smem("rmw", n, 4096), ("scalar", "rmw")),
    "probe_smem:rmw[SZ=1024]": (lambda n: smem("rmw", n, 1024),
                                ("scalar", "rmw", 1024)),
    "probe_loop:empty": (lambda n: loop_empty(1, n), ("scalar", "empty")),
    "probe_loop:empty_u8": (lambda n: loop_empty(8, n),
                            ("scalar", "empty_u8")),
    "probe_loop:smem_chase": (lambda n: loop_smem(4096, 1, n),
                              ("scalar", "chase")),
    "probe_loop:smem_u8": (lambda n: loop_smem(4096, 8, n),
                           ("scalar", "chase_u8")),
    "probe_loop:smem_32k": (lambda n: loop_smem(32768, 1, n),
                            ("scalar", "chase", 32768)),
    "probe_loop:slab": (lambda n: loop_slab(1, n), ("tile", "slab")),
    "probe_loop:slab_u8": (lambda n: loop_slab(8, n), ("tile", "slab_u8")),
    "probe_loop:mwrite": (lambda n: loop_mwrite(n, False), ("row", "mwrite")),
    "probe_loop:mread_u8": (lambda n: loop_mread(8, n), ("row", "mread_u8")),
    "probe_loop2:empty": (lambda n: loop_empty(1, n), ("scalar", "empty")),
    "probe_loop2:smem_chase": (lambda n: loop_smem(4096, 1, n),
                               ("scalar", "chase")),
    "probe_loop2:smem_chase_u8": (loop2_smem_u8, ("scalar", "chase_u8")),
    "probe_loop2:mread": (lambda n: loop_mread(1, n), ("row", "mread")),
    "probe_loop2:mread_u8": (loop2_mread_u8, ("row", "mread_u8")),
    "probe_loop2:mchase": (loop2_chase, ("row", "chase")),
    "probe_loop2:slab_u8": (loop2_slab_u8, ("tile", "slab_u8")),
    "probe_loop2:vecrow": (loop2_vecrow, ("tile", "vecrow")),
    "probe_smem2:cap_224KB": (smem2_cap, ("scalar", "cap")),
    "probe_smem2:smem_rmw": (smem2_rmw, ("scalar", "rmw7")),
    "probe_smem2:mwrite": (lambda n: loop_mwrite(n, True), ("row", "mwrite")),
    "probe_smem2:fillrow": (smem2_fillrow, ("tile", "fillrow")),
    "probe_stack:step K=1": (lambda n: stack_step(1, n), ("step", 1)),
    "probe_stack:step K=2": (lambda n: stack_step(2, n), ("step", 2)),
    "probe_stack:step K=4": (lambda n: stack_step(4, n), ("step", 4)),
    "probe_stack:step K=8": (lambda n: stack_step(8, n), ("step", 8)),
}


def _plain(case: tuple, n: int) -> torch.Tensor:
    family, kind = case[:2]
    if family == "scalar":
        return P.scalar_reference(kind, n, *case[2:])
    if family == "row":
        return P.row_reference(kind, n, P.plane7())
    if family == "tile":
        return P.tile_reference(kind, n, P.plane11())
    return P.step_reference(kind, n, P.stack_plane(kind))


@pytest.mark.parametrize("name", sorted(TPU))
def test_plain_version_matches_the_tpu_probe(name):
    body, case = TPU[name]
    n = N_WRITE if case[1] == "mwrite" else N
    assert np.array_equal(body(n), _plain(case, n).numpy())


def test_every_tpu_probe_builder_is_covered():
    """Each builder that reaches pl.pallas_call in the six probe files has
    a case here (probe_loop2's builders by their printed names)."""
    want = {"probe_scalar_latency": {"chase", "indep", "indep4"},
            "probe_smem": {"chase", "indep", "rmw"},
            "probe_loop": {"empty", "empty_u8", "smem_chase", "smem_u8",
                           "smem_32k", "slab", "slab_u8", "mwrite",
                           "mread_u8"},
            "probe_loop2": {"empty", "smem_chase", "smem_chase_u8", "mread",
                            "mread_u8", "mchase", "slab_u8", "vecrow"},
            "probe_smem2": {"cap_224KB", "smem_rmw", "mwrite", "fillrow"},
            "probe_stack": {"step K=1", "step K=2", "step K=4", "step K=8"}}
    have: dict = {}
    for key in TPU:
        f, c = key.split(":")
        have.setdefault(f, set()).add(c.split("[")[0])
    assert have == want


def test_fill_row_table_index_stays_in_the_table():
    """The TPU fill row indexes its table with an unmasked v; the port
    masks it. Over the slope files' largest N the two agree because v
    never leaves [0, 4096)."""
    sm = [(i * 97 + 13) & 4095 for i in range(4096)]
    v = 0
    for _ in range(524288):
        a = sm[v]
        sm[(v + 3) & 4095] = a + 1
        v = sm[v]
        assert v < 4096


# ---- the kernel source on the CPU emulation ----

@pytest.fixture(scope="module")
def exe(tmp_path_factory):
    return cuda_emu.build("probes", str(tmp_path_factory.mktemp("probes")))


def _emu_cases():
    out = []
    for kind in P.SCALAR:
        for mem in P.MEMS:
            out.append(("scalar", kind, mem, 4096))
        if kind.startswith("chase"):
            out.append(("scalar", kind, "shared", 32768))
    for kind in P.ROW:
        for mem in P.MEMS:
            for lanes in (1, 32):
                out.append(("row", kind, mem, lanes))
    out += [("tile", kind) for kind in P.TILE]
    out += [("step", lay, K) for lay in P.LAYOUTS for K in P.STEP_KS]
    return out


@pytest.mark.parametrize("case", _emu_cases(), ids=lambda c: "-".join(
    map(str, c)))
def test_kernel_source_matches_plain_version(exe, case):
    fam = case[0]
    if fam == "scalar":
        _, kind, mem, sz = case
        n = 5000
        got = cuda_emu.run_probe(exe, "scalar", (P.SCALAR.index(kind),
                                                 P.MEMS.index(mem)), n, sz)
        want = P.scalar_reference(kind, n, sz)
    elif fam == "row":
        _, kind, mem, lanes = case
        # a warp's shuffles are barrier waits on the emulation: fewer steps
        n = N_WRITE if kind == "mwrite" else (5000 if lanes == 1 else 300)
        got = cuda_emu.run_probe(exe, "row", (P.ROW.index(kind),
                                              P.MEMS.index(mem), lanes), n,
                                 inp=P.plane7())
        want = P.row_reference(kind, n, P.plane7())
    elif fam == "tile":
        n = 300
        got = cuda_emu.run_probe(exe, "tile", (P.TILE.index(case[1]),), n,
                                 inp=P.plane11())
        want = P.tile_reference(case[1], n, P.plane11())
    else:
        _, lay, K = case
        n = 24 if lay == "block" else 300
        got = cuda_emu.run_probe(exe, "step", (P.LAYOUTS.index(lay), K), n,
                                 inp=P.stack_plane(K))
        want = P.step_reference(K, n, P.stack_plane(K))
    assert torch.equal(got, want)


def test_wrappers_run_plain_versions_on_the_cpu_and_check_arguments():
    before = {k: w.launches for k, w in P.WRAPPERS.items()}
    assert torch.equal(P.probe_scalar("chase", "global", 100, 4096, "cpu"),
                       P.scalar_reference("chase", 100))
    assert torch.equal(P.probe_row("mread", "shared", 32, 100, P.plane7()),
                       P.row_reference("mread", 100, P.plane7()))
    assert torch.equal(P.probe_tile("slab", 10, P.plane11()),
                       P.tile_reference("slab", 10, P.plane11()))
    assert torch.equal(P.probe_step("warp", 2, 10, P.stack_plane(2)),
                       P.step_reference(2, 10, P.stack_plane(2)))
    assert {k: w.launches for k, w in P.WRAPPERS.items()} == before
    with pytest.raises(ValueError):
        P.probe_scalar("chase", "shared", 10, 1000, "cpu")   # not 2^k
    with pytest.raises(ValueError):
        P.probe_row("chase", "shared", 8, 10, P.plane7())
    with pytest.raises(ValueError):
        P.probe_step("block", 3, 10, P.stack_plane(1))


def test_bounds_count_the_function():
    """One step of the one-thread chase is one load at one op a clock;
    the 256-thread cases share an SM's 128 issue lanes; the stack step is
    a select and a max per element and the lane mask per column."""
    assert P.bound_ms("scalar", "chase", 1000, 1000.0) == pytest.approx(
        (1000 + 4 * 4096) / 1e6)
    assert P.bound_ms("tile", "slab", 1000, 1000.0) == pytest.approx(
        1000 * 4098 / 128 / 1e6)
    assert P.step_ops("step", "", 8) == 2 * 64 * 256 + 256 + 3
