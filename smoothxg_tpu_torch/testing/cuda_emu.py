"""Run a kernel source of the port (csrc/poa_win.cu, poa_code.cu,
poa_stacked.cu, poa_round.cu, poa_batch.cu, probes.cu, sgd.cu, minhash.cu,
ident.cu, autocorr.cu) on
the CPU, for testing its logic where there is no GPU and no nvcc.

`build(name, workdir)` rewrites csrc/<name>.cu for the CUDA emulation in
testing/cuda_emu.h (dynamic shared memory becomes a host buffer, a
`kernel<<<grid, block, smem, stream>>>(args)` launch becomes
`emu::launch(...)`), appends a main program and compiles it with g++ -std=c++20.
`run(exe, ...)` launches a whole-block kernel's C entry point
`<name>_launch` on the port's (seqs, slen, nseq, params) CPU tensors at a
profiling `stage` and returns (meta, exp, paths), which must equal the
plain PyTorch version's; `run_geometry` also returns the launch geometry
the kernel chose (`<name>_geometry`: POA blocks per thread block, grid,
dynamic shared bytes, tables in shared or device memory).
`run_round(exe, ...)` launches poa_round.cu's `poa_round_launch` on the
round inputs and returns (codes, meta) and its geometry (threads a block,
one-tile rows with the ring, sequence and row tables in shared memory,
shared bytes, blocks an SM).  `run_batch(exe, ...)` launches
poa_batch.cu's `poa_batch_launch` on ops/poa_batch.py's inputs and returns
(out, outpos, bv); `run_batch_geometry` also returns its geometry
(`poa_batch_geometry`: threads a block, ring or tiled rows, row tables in
shared or device memory, shared bytes, blocks an SM).
`run_probe(exe, family, ...)` launches `probe_<family>_launch` of probes.cu
and returns its 128 outputs.  `run_sgd` (sgd.cu's plan and chain, or the
chain alone on a given plan), `run_minhash_hash` (either route),
`run_minhash_inter` (tiles of given rows, or the long route),
`run_ident` (ident.cu's warp or block kernel, by the band) and
`run_autocorr` (autocorr.cu's memset, pack and count kernels, its units
staged in shared memory or read from device memory by the emulated shared
memory, with the geometry and the plan) launch the entries of sgd.cu,
minhash.cu, ident.cu and autocorr.cu on the inputs their wrappers take.  A race between threads shows as a hang, so
callers run it under a timeout.  The emulated device has an H100's SM
count and shared memory limits unless `sms`, `smem_block` and `smem_sm`
say otherwise; a launch the card would refuse for its shared memory fails.
"""
from __future__ import annotations

import os
import re
import subprocess

import numpy as np
import torch

from ..ops._build import SANITIZE_FLAGS

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
# build() sanitizes by default where this variable is 1
SANITIZE_ENV = "SMOOTHXG_TORCH_EMU_SANITIZE"
# the head of a failed launch's standard error kept in its message
_STDERR_KEEP = 16000

_MAIN = r"""
#include <cstdio>
#include <cstdlib>
int main(int argc, char** argv) {
    FILE* f = std::fopen(argv[1], "rb");
    int hd[14];
    if (std::fread(hd, 4, 14, f) != 14) return 2;
    const int B = hd[0], RW = hd[1], LW = hd[2], VW = hd[3], pcap = hd[4],
              local = hd[5], banded = hd[6], words = hd[7], W = hd[8],
              stage = hd[9], LS = hd[10];
    emu::sms = hd[11]; emu::smem_block = hd[12]; emu::smem_sm = hd[13];
    std::vector<int8_t> seqs((size_t)B * RW * LW);
    std::vector<int32_t> slen((size_t)B * RW), nseq(B), par((size_t)B * 8);
    if (std::fread(seqs.data(), 1, seqs.size(), f) != seqs.size() ||
        std::fread(slen.data(), 4, slen.size(), f) != slen.size() ||
        std::fread(nseq.data(), 4, nseq.size(), f) != nseq.size() ||
        std::fread(par.data(), 4, par.size(), f) != par.size()) return 2;
    std::fclose(f);
    std::vector<int32_t> meta((size_t)B * 4, 7), exp_((size_t)B * 3 * VW, 7),
        paths((size_t)B * RW * LW, 7), scratch((size_t)B * words, 0x5a5a5a5a);
    const int rc = LAUNCH(seqs.data(), slen.data(), nseq.data(), par.data(),
                          meta.data(), exp_.data(), paths.data(),
                          scratch.data(), B, RW, LW, VW, EXTRA local,
                          banded, nullptr);
    int geo[6] = {0, 0, 0, 0, 1, 0};
    GEOMETRY
    f = std::fopen(argv[2], "wb");
    std::fwrite(meta.data(), 4, meta.size(), f);
    std::fwrite(exp_.data(), 4, exp_.size(), f);
    std::fwrite(paths.data(), 4, paths.size(), f);
    std::fwrite(geo, 4, 6, f);
    std::fclose(f);
    return rc;
}
"""
# an H100's SMs and shared memory a block may opt in to / an SM holds
SMS, SMEM_BLOCK, SMEM_SM = 132, 232448, 233472

# the probes' entry points: header (family, a, b, c, n, sz, input words),
# then the input; scratch starts as garbage, as on the card
_PROBE_MAIN = r"""
#include <cstdio>
#include <cstdlib>
int main(int argc, char** argv) {
    FILE* f = std::fopen(argv[1], "rb");
    int hd[7];
    if (std::fread(hd, 4, 7, f) != 7) return 2;
    const int fam = hd[0], a = hd[1], b = hd[2], c = hd[3], n = hd[4],
              sz = hd[5];
    std::vector<int32_t> in((size_t)hd[6] + 1);
    if (std::fread(in.data(), 4, hd[6], f) != (size_t)hd[6]) return 2;
    std::fclose(f);
    std::vector<int32_t> out(128, 7), scratch(2048 * 256 + 65536, 0x5a5a5a5a);
    int rc = 1;
    if (fam == 0)
        rc = probe_scalar_launch(a, b, n, sz, scratch.data(), out.data(),
                                 nullptr);
    else if (fam == 1)
        rc = probe_row_launch(a, b, c, n, in.data(), scratch.data(),
                              out.data(), nullptr);
    else if (fam == 2)
        rc = probe_tile_launch(a, n, in.data(), scratch.data(), out.data(),
                               nullptr);
    else if (fam == 3)
        rc = probe_step_launch(a, b, n, in.data(), scratch.data(),
                               out.data(), nullptr);
    f = std::fopen(argv[2], "wb");
    std::fwrite(out.data(), 4, out.size(), f);
    std::fclose(f);
    return rc;
}
"""
PROBE_FAMILIES = ("scalar", "row", "tile", "step")

# poa_round.cu's entry: header (B, VW, LS, P, local, sms, smem_block,
# smem_sm), then the seven inputs; writes codes, meta and the geometry
_ROUND_MAIN = r"""
#include <cstdio>
#include <cstdlib>
int main(int argc, char** argv) {
    FILE* f = std::fopen(argv[1], "rb");
    int hd[8];
    if (std::fread(hd, 4, 8, f) != 8) return 2;
    const int B = hd[0], VW = hd[1], LS = hd[2], P = hd[3], local = hd[4];
    emu::sms = hd[5]; emu::smem_block = hd[6]; emu::smem_sm = hd[7];
    std::vector<int32_t> nv(B), slen(B), par((size_t)B * 6),
        preds((size_t)B * VW * P);
    std::vector<uint8_t> base((size_t)B * VW), sink((size_t)B * VW),
        seq((size_t)B * LS);
    if (std::fread(nv.data(), 4, B, f) != (size_t)B ||
        std::fread(slen.data(), 4, B, f) != (size_t)B ||
        std::fread(par.data(), 4, par.size(), f) != par.size() ||
        std::fread(base.data(), 1, base.size(), f) != base.size() ||
        std::fread(sink.data(), 1, sink.size(), f) != sink.size() ||
        std::fread(preds.data(), 4, preds.size(), f) != preds.size() ||
        std::fread(seq.data(), 1, seq.size(), f) != seq.size()) return 2;
    std::fclose(f);
    std::vector<int64_t> codes((size_t)B * (VW + LS + 1), 0);
    std::vector<int32_t> meta((size_t)B * 4, 7),
        scratch((size_t)B * task_words(VW, LS), 0x5a5a5a5a);
    const int rc = poa_round_launch(
        nv.data(), slen.data(), par.data(), base.data(), sink.data(),
        preds.data(), seq.data(), codes.data(), meta.data(), scratch.data(),
        B, VW, LS, P, local, nullptr);
    int geo[6] = {0, 0, 0, 0, 0, 0};
    poa_round_geometry(VW, LS, P, geo);
    f = std::fopen(argv[2], "wb");
    std::fwrite(codes.data(), 8, codes.size(), f);
    std::fwrite(meta.data(), 4, meta.size(), f);
    std::fwrite(geo, 4, 6, f);
    std::fclose(f);
    return rc;
}
"""
ROUND_GEOMETRY = ("threads", "ring", "seq_smem", "tables", "smem", "per_sm")

# poa_batch.cu's entry: header (B, Vp, Lp, P, local, sms, smem_block,
# smem_sm), then the seven inputs (sink as bytes); writes out, outpos, bv
# and the geometry, then the scratch words a task
_BATCH_MAIN = r"""
#include <cstdio>
#include <cstdlib>
int main(int argc, char** argv) {
    FILE* f = std::fopen(argv[1], "rb");
    int hd[8];
    if (std::fread(hd, 4, 8, f) != 8) return 2;
    const int B = hd[0], V = hd[1], L = hd[2], P = hd[3], local = hd[4];
    emu::sms = hd[5]; emu::smem_block = hd[6]; emu::smem_sm = hd[7];
    std::vector<int32_t> base((size_t)V * B + 1), pred((size_t)V * B * P + 1),
        seq((size_t)B * L + 1), slen(B), nvalid(B), par((size_t)B * 6);
    std::vector<uint8_t> sink((size_t)B * (V + 1));
    if (std::fread(base.data(), 4, (size_t)V * B, f) != (size_t)V * B ||
        std::fread(pred.data(), 4, (size_t)V * B * P, f) !=
            (size_t)V * B * P ||
        std::fread(seq.data(), 4, (size_t)B * L, f) != (size_t)B * L ||
        std::fread(slen.data(), 4, B, f) != (size_t)B ||
        std::fread(nvalid.data(), 4, B, f) != (size_t)B ||
        std::fread(sink.data(), 1, sink.size(), f) != sink.size() ||
        std::fread(par.data(), 4, par.size(), f) != par.size()) return 2;
    std::fclose(f);
    const size_t S = (size_t)V + L + 5;
    std::vector<int32_t> out((size_t)B * S * 2, 7), outpos(B, 7), bv(B, 7),
        scratch((size_t)B * poa_batch_task_words(V, L), 0x5a5a5a5a);
    const int rc = poa_batch_launch(
        base.data(), pred.data(), seq.data(), slen.data(), nvalid.data(),
        sink.data(), par.data(), out.data(), outpos.data(), bv.data(),
        scratch.data(), B, V, L, P, local, nullptr);
    int geo[5] = {0, 0, 0, 0, 0};
    poa_batch_geometry(B, V, L, P, geo);
    f = std::fopen(argv[2], "wb");
    std::fwrite(out.data(), 4, out.size(), f);
    std::fwrite(outpos.data(), 4, B, f);
    std::fwrite(bv.data(), 4, B, f);
    std::fwrite(geo, 4, 5, f);
    const long long words = poa_batch_task_words(V, L);
    std::fwrite(&words, 8, 1, f);
    std::fclose(f);
    return rc;
}
"""
BATCH_GEOMETRY = ("threads", "ring", "tables", "smem", "per_sm")

# the split-stage and SGD kernels' entries: a header of ints, the inputs
# in order, the outputs written back in order
_READ = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
template <typename T>
static std::vector<T> rd(FILE* f, size_t n) {
    std::vector<T> v(n + 1);
    if (std::fread(v.data(), sizeof(T), n, f) != n) std::exit(2);
    return v;
}
template <typename T>
static void wr(FILE* f, const std::vector<T>& v, size_t n) {
    std::fwrite(v.data(), sizeof(T), n, f);
}
"""
_SGD_MAIN = _READ + r"""
int main(int argc, char** argv) {
    FILE* f = std::fopen(argv[1], "rb");
    auto hd = rd<int32_t>(f, 5);
    const size_t T = hd[0], n = hd[1], B = hd[2];
    float eta;
    std::memcpy(&eta, &hd[3], 4);
    const int given = hd[4];        // 1: apply the plan read, 0: make it
    auto x = rd<float>(f, n);
    auto node = rd<int32_t>(f, T);
    auto pos = rd<float>(f, T);
    auto start = rd<int32_t>(f, T);
    auto count = rd<int32_t>(f, T);
    auto i1 = rd<int32_t>(f, B);
    auto z = rd<int32_t>(f, B);
    auto sgn = rd<int8_t>(f, B);
    auto plan = rd<int32_t>(f, 6 * B);
    std::fclose(f);
    int rc = 0;
    if (!given)
        rc = sgd_plan_launch(node.data(), pos.data(), start.data(),
                             count.data(), i1.data(), z.data(), sgn.data(),
                             eta, (int)B, plan.data(), nullptr);
    if (rc == 0)
        rc = sgd_chain_launch(x.data(), plan.data(), (int)B, nullptr);
    f = std::fopen(argv[2], "wb");
    wr(f, x, n);
    wr(f, plan, 6 * B);
    std::fclose(f);
    return rc;
}
"""
_MINHASH_MAIN = _READ + r"""
int main(int argc, char** argv) {
    FILE* f = std::fopen(argv[1], "rb");
    auto hd = rd<int32_t>(f, 5);
    // mode 0: hash (x = device_keys), 1: intersections (x = tile rows R)
    const int mode = hd[0], B = hd[1], L = hd[2], k = hd[3], x = hd[4];
    int rc = 1;
    if (mode == 0) {
        auto codes = rd<int8_t>(f, (size_t)B * L);
        auto lens = rd<int32_t>(f, B);
        std::fclose(f);
        std::vector<int32_t> hs((size_t)B * L, 7), counts(B, 7);
        rc = minhash_hash_launch(codes.data(), lens.data(), hs.data(),
                                 counts.data(), B, L, k, x, nullptr);
        f = std::fopen(argv[2], "wb");
        wr(f, hs, hs.size());
        wr(f, counts, counts.size());
    } else {
        auto hs = rd<int32_t>(f, (size_t)B * L);
        auto counts = rd<int32_t>(f, B);
        std::fclose(f);
        std::vector<int32_t> inter((size_t)B * (B - 1) / 2 + 1, 7);
        rc = minhash_inter_launch(hs.data(), counts.data(), inter.data(), B,
                                  L, x, nullptr);
        f = std::fopen(argv[2], "wb");
        wr(f, inter, inter.size() - 1);
    }
    std::fclose(f);
    return rc;
}
"""
_IDENT_MAIN = _READ + r"""
int main(int argc, char** argv) {
    FILE* f = std::fopen(argv[1], "rb");
    auto hd = rd<int32_t>(f, 8);
    const int P = hd[0], na = hd[1], nb = hd[2], band = hd[3], X = hd[4],
              O = hd[5], E = hd[6];
    auto a = rd<uint8_t>(f, na);
    auto aoff = rd<long long>(f, P);
    auto la = rd<int32_t>(f, P);
    auto b = rd<uint8_t>(f, nb);
    auto boff = rd<long long>(f, P);
    auto lb = rd<int32_t>(f, P);
    std::fclose(f);
    std::vector<int32_t> out((size_t)P * 4, 7);
    const int rc = ident_launch(a.data(), aoff.data(), la.data(), b.data(),
                                boff.data(), lb.data(), out.data(), P, band,
                                X, O, E, nullptr);
    f = std::fopen(argv[2], "wb");
    wr(f, out, out.size());
    std::fclose(f);
    return rc;
}
"""
_AUTOCORR_MAIN = _READ + r"""
int main(int argc, char** argv) {
    FILE* f = std::fopen(argv[1], "rb");
    auto hd = rd<int32_t>(f, 6);
    const int B = hd[0], Lpad = hd[1], G = hd[2];
    emu::sms = hd[3]; emu::smem_block = hd[4]; emu::smem_sm = hd[5];
    auto rows = rd<uint8_t>(f, (size_t)B * Lpad);
    auto lens = rd<int32_t>(f, B);
    auto lags = rd<int32_t>(f, G);
    std::fclose(f);
    std::vector<int32_t> out((size_t)B * G + 1, 7), geo(8, 0);
    // the rows 4-byte aligned and the scratch 16-byte aligned, as torch
    // allocations are; the scratch starts as garbage
    std::vector<uint32_t> words(((size_t)B * Lpad + 3) / 4 + 1);
    std::memcpy(words.data(), rows.data(), (size_t)B * Lpad);
    const long long sb = autocorr_scratch_bytes(B, Lpad, G);
    std::vector<int4> scratch((size_t)(sb + 15) / 16 + 1);
    std::memset(scratch.data(), 0x5a, scratch.size() * 16);
    const int rc = autocorr_launch(
        reinterpret_cast<const uint8_t*>(words.data()), lens.data(),
        lags.data(), out.data(), scratch.data(), B, Lpad, G, nullptr);
    autocorr_geometry(B, Lpad, G, geo.data());
    const int* hdr = reinterpret_cast<const int*>(scratch.data());
    std::vector<int32_t> plan(16, 0);
    if (rc == 0 && B > 0 && G > 0)
        plan.assign(hdr, hdr + hdr[7] + 4 * (size_t)hdr[0]);
    f = std::fopen(argv[2], "wb");
    wr(f, out, (size_t)B * G);
    wr(f, geo, 8);
    wr(f, plan, plan.size());
    std::fclose(f);
    return rc;
}
"""
_MAINS = {"sgd": _SGD_MAIN, "minhash": _MINHASH_MAIN, "ident": _IDENT_MAIN,
          "autocorr": _AUTOCORR_MAIN}


def _rewrite(src: str) -> str:
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = (\1*)emu::block_smem();", src)
    src = re.sub(r"(\w+(?:<[^<>;]*>)?)<<<(.+?)>>>\(",
                 r"emu::launch(\2, \1, ", src, flags=re.S)
    return src


def build(name: str, workdir: str, defines=(), sanitize=None,
          source: str | None = None) -> str:
    """Compile csrc/<name>.cu (or `source`, a kernel file that carries its
    own main) with the emulation, each of `defines` ("NAME=value") as a -D
    switch; returns the executable.  With `sanitize` (by default: the
    environment's SMOOTHXG_TORCH_EMU_SANITIZE is 1) it is built under
    AddressSanitizer and UBSan (ops/_build.SANITIZE_FLAGS), so an access
    past a buffer, the emulated shared memory included (exactly the
    launch's bytes), a leak or undefined behaviour ends the launch with
    the sanitizer's report."""
    if sanitize is None:
        sanitize = os.environ.get(SANITIZE_ENV) == "1"
    os.makedirs(workdir, exist_ok=True)
    for header in ("cuda_runtime.h", "cuda_pipeline.h",
                   "cooperative_groups.h"):
        with open(os.path.join(workdir, header), "w") as f:
            f.write(f'#include "{os.path.join(_HERE, "cuda_emu.h")}"\n')
    with open(source or os.path.join(CSRC, f"{name}.cu")) as f:
        src = _rewrite(f.read())
    if source:
        main = ""
    elif name in _MAINS:
        main = _MAINS[name]
    elif name == "probes":
        main = _PROBE_MAIN
    elif name == "poa_round":
        main = _ROUND_MAIN
    elif name == "poa_batch":
        main = _BATCH_MAIN
    else:
        # poa_win_launch takes the stored window width before pcap; the
        # code-chase kernels take a profiling stage after it; all take the
        # row stride and report their geometry
        extra = "W, pcap, LS," if name == "poa_win" else "pcap, stage, LS,"
        shape = "VW, W," if name == "poa_win" else "VW,"
        geo = (f"if (B > 0) {name}_geometry(B, {shape} pcap, LS, banded, "
               f"geo);")
        main = (f"\n#define LAUNCH {name}_launch\n#define EXTRA {extra}\n"
                f"#define GEOMETRY {geo}\n" + _MAIN)
    cpp = os.path.join(workdir, f"{name}_emu.cpp")
    with open(cpp, "w") as f:
        f.write(src + main)
    exe = os.path.join(workdir, f"{name}_emu")
    # sanitized at -O0: it builds in a seventh of -O1's time, and no
    # access is optimised away from the checks
    subprocess.run([os.environ.get("CXX", "g++"), "-std=c++20",
                    *(["-O0", *SANITIZE_FLAGS] if sanitize else ["-O1"]),
                    "-fno-strict-aliasing", "-ffp-contract=off", "-pthread",
                    "-w", "-I", workdir, "-I", CSRC,
                    *(f"-D{d}" for d in defines), "-o", exe, cpp],
                   check=True, capture_output=True, text=True, timeout=300)
    return exe


def build_many(names, workdir: str, sanitize=None) -> dict:
    """build() of each of `names` into workdir/<name>, several g++
    processes at once; {name: executable}."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(4) as pool:
        exes = {n: pool.submit(build, n, os.path.join(workdir, n),
                               sanitize=sanitize) for n in names}
        return {n: f.result() for n, f in exes.items()}


def _launch(exe: str, header: list, inputs, timeout: float) -> np.ndarray:
    return np.frombuffer(_run_raw(exe, header, inputs, timeout),
                         np.int32).copy()


def run_geometry(exe: str, seqs, slen, nseq, params, caps, words: int,
                 stage: int = 0, timeout: float = 120.0, LS: int = 0,
                 sms: int = SMS, smem_block: int = SMEM_BLOCK,
                 smem_sm: int = SMEM_SM):
    """Launch the emulated kernel on CPU tensors with `words` int32 of
    scratch per block at row stride LS; returns ((meta, exp, paths) as
    int32 tensors, the launch geometry as a dict)."""
    B, RW, LW = seqs.shape
    raw = _launch(exe, [B, RW, LW, caps.VW, caps.pcap, int(caps.local),
                        int(caps.banded), words, caps.W, stage, LS, sms,
                        smem_block, smem_sm],
                  (seqs, slen, nseq, params), timeout)
    n1, n2, n3 = B * 4, B * 3 * caps.VW, B * RW * LW
    out = (torch.from_numpy(raw[:n1].reshape(B, 4).copy()),
           torch.from_numpy(raw[n1:n1 + n2].reshape(B, 3, caps.VW).copy()),
           torch.from_numpy(raw[n1 + n2:n1 + n2 + n3]
                            .reshape(B, RW, LW).copy()))
    g = raw[n1 + n2 + n3:].tolist()
    return out, {"per_block": g[0], "grid": g[1], "smem": g[2],
                 "tables": "shared" if g[3] else "device", "cluster": g[4],
                 "meta": "shared" if g[5] else "device"}


def run(exe: str, seqs, slen, nseq, params, caps, words: int,
        stage: int = 0, timeout: float = 120.0, LS: int = 0, **device):
    """run_geometry without the geometry."""
    return run_geometry(exe, seqs, slen, nseq, params, caps, words, stage,
                        timeout, LS, **device)[0]


def run_round(exe: str, nv, slen, par, base, sink, preds, seq,
              local: bool, timeout: float = 120.0, sms: int = SMS,
              smem_block: int = SMEM_BLOCK, smem_sm: int = SMEM_SM):
    """Launch the emulated poa_round_launch on the port's round inputs (CPU
    tensors, ops/poa_round.py's layout); returns ((codes, meta), the
    launch geometry as a dict)."""
    B, VW = base.shape
    LS, P = seq.shape[1], preds.shape[2]
    raw = _run_raw(exe, [B, VW, LS, P, int(local), sms, smem_block, smem_sm],
                   (nv, slen, par, base, sink, preds, seq), timeout)
    nc = B * (VW + LS + 1) * 8
    codes = np.frombuffer(raw[:nc], np.int64).reshape(B, VW + LS + 1)
    rest = np.frombuffer(raw[nc:], np.int32)
    meta = rest[:B * 4].reshape(B, 4)
    geo = dict(zip(ROUND_GEOMETRY, rest[B * 4:B * 4 + 6].tolist()))
    return (torch.from_numpy(codes.copy()), torch.from_numpy(meta.copy())), geo


def run_batch_geometry(exe: str, base, pred, seq, slen, nvalid, sink, par,
                       local: bool, timeout: float = 120.0, sms: int = SMS,
                       smem_block: int = SMEM_BLOCK,
                       smem_sm: int = SMEM_SM):
    """Launch the emulated poa_batch_launch on ops/poa_batch.py's inputs
    (CPU tensors, the XLA function's layout); returns ((out, outpos, bv),
    the launch geometry as a dict: threads a block, one-tile rows with the
    ring, row tables in shared memory, shared bytes, blocks an SM, and
    the kernel's scratch words a task, `task_words`)."""
    V, B = base.shape
    L, P = seq.shape[1], pred.shape[2]
    raw = _run_raw(exe, [B, V, L, P, int(local), sms, smem_block, smem_sm],
                   (base, pred, seq, slen, nvalid, sink.to(torch.uint8),
                    par), timeout)
    a = np.frombuffer(raw, np.int32)
    S = V + L + 5
    n = B * S * 2
    geo = dict(zip(BATCH_GEOMETRY, a[n + 2 * B:n + 2 * B + 5].tolist()))
    geo["task_words"] = int(np.frombuffer(raw[4 * (n + 2 * B + 5):],
                                          np.int64)[0])
    return (torch.from_numpy(a[:n].reshape(B, S, 2).copy()),
            torch.from_numpy(a[n:n + B].copy()),
            torch.from_numpy(a[n + B:n + 2 * B].copy())), geo


def run_batch(exe: str, *args, **kw):
    """run_batch_geometry without the geometry: (out, outpos, bv)."""
    return run_batch_geometry(exe, *args, **kw)[0]


def run_probe(exe: str, family: str, args: tuple, n: int, sz: int = 1,
              inp: torch.Tensor | None = None,
              timeout: float = 120.0) -> torch.Tensor:
    """Launch probe_<family>_launch of the emulated probes.cu with its
    case arguments `args` (up to three ints, as the entry takes them) and
    the input tensor `inp` (int32); returns the (128,) output."""
    a = list(args) + [0] * (3 - len(args))
    x = (inp if inp is not None else torch.zeros(0, dtype=torch.int32))
    raw = _launch(exe, [PROBE_FAMILIES.index(family), *a, n, sz, x.numel()],
                  (x.to(torch.int32),), timeout)
    return torch.from_numpy(raw.copy())


class LaunchError(RuntimeError):
    """An emulated launch that exited non-zero; the message carries the
    child's standard error, so a sanitizer's report is the failure's."""


def run_exe(exe: str, args, timeout: float) -> None:
    """Run an emulation executable with `args`; a nonzero exit raises
    LaunchError with the child's standard error."""
    # a sanitized build checks for leaks too: unlike the reference's lane,
    # which preloads the runtime into Python, nothing else runs here
    env = dict(os.environ, ASAN_OPTIONS="detect_leaks=1",
               UBSAN_OPTIONS="print_stacktrace=1")
    res = subprocess.run([exe, *args], capture_output=True, text=True,
                         timeout=timeout, env=env)
    if res.returncode != 0:
        raise LaunchError(f"emulated launch failed: rc {res.returncode} "
                          f"({os.path.basename(exe)})\n"
                          f"{res.stderr[:_STDERR_KEEP]}")


def _run_raw(exe: str, header: list, inputs, timeout: float) -> bytes:
    d = os.path.dirname(exe)
    inp, out = os.path.join(d, "in.bin"), os.path.join(d, "out.bin")
    with open(inp, "wb") as f:
        f.write(np.array(header, np.int32).tobytes())
        for t in inputs:
            f.write(t.contiguous().numpy().tobytes())
    run_exe(exe, [inp, out], timeout)
    with open(out, "rb") as f:
        return f.read()


def run_sgd(exe: str, x, i1, z, sgn, node, pos, start, count, eta: float,
            plan=None, timeout: float = 300.0):
    """sgd.cu's sgd_plan_launch and sgd_chain_launch on ops/sgd.py:
    sgd_iter's CPU inputs, or the chain alone on a given `plan` (ops/sgd.py:
    sgd_plan's layout); returns (the updated x, the plan), new tensors."""
    B = i1.numel()
    eta_bits = int(np.array([eta], np.float32).view(np.int32)[0])
    given = plan is not None
    if not given:
        plan = torch.zeros(6 * B, dtype=torch.int32)
    raw = _run_raw(exe, [node.numel(), x.numel(), B, eta_bits, int(given)],
                   (x, node, pos, start, count, i1, z, sgn, plan), timeout)
    n = x.numel()
    return (torch.from_numpy(np.frombuffer(raw[:4 * n], np.float32).copy()),
            torch.from_numpy(np.frombuffer(raw[4 * n:], np.int32).copy()))


def run_minhash_hash(exe: str, codes, lens, k: int, device_keys=False,
                     timeout: float = 120.0):
    """minhash.cu's minhash_hash_launch (the shared-memory route, or the
    device-memory one); returns (hs (B, L), counts (B,)) int32."""
    B, L = codes.shape
    raw = np.frombuffer(_run_raw(exe, [0, B, L, k, int(device_keys)],
                                 (codes, lens), timeout), np.int32)
    return (torch.from_numpy(raw[:B * L].reshape(B, L).copy()),
            torch.from_numpy(raw[B * L:].copy()))


def run_minhash_inter(exe: str, hs, counts, rows: int,
                      timeout: float = 120.0) -> torch.Tensor:
    """minhash.cu's minhash_inter_launch with tiles of `rows` rows (0: a
    block a pair, in segments); returns the (B (B - 1) / 2,) int32
    intersections in np.triu_indices order."""
    B, H = hs.shape
    raw = _run_raw(exe, [1, B, H, 0, rows], (hs, counts), timeout)
    return torch.from_numpy(np.frombuffer(raw, np.int32).copy())


def run_ident(exe: str, a, aoff, la, b, boff, lb, band: int = 128,
              mismatch: int = 7, gap_open: int = 11, gap_ext: int = 1,
              timeout: float = 300.0) -> torch.Tensor:
    """ident.cu's ident_launch on ops/ident_cuda.pack_pairs' tensors;
    returns (P, 4) int32."""
    P = la.numel()
    raw = _run_raw(exe, [P, a.numel(), b.numel(), band, mismatch, gap_open,
                         gap_ext, 0], (a, aoff, la, b, boff, lb), timeout)
    return torch.from_numpy(np.frombuffer(raw, np.int32).reshape(P, 4).copy())


def run_autocorr(exe: str, rows, lens, lags, timeout: float = 120.0,
                 sms: int = SMS, smem_block: int = SMEM_BLOCK,
                 smem_sm: int = SMEM_SM):
    """autocorr.cu's autocorr_launch on ops/autocorr.autocorr_counts' CPU
    tensors (rows (B, Lpad) uint8 with Lpad % 4 == 0, lens (B,) and lags
    (G,) int32); returns ((B, G) int32 counts, the launch geometry as a
    dict (ops/autocorr.GEOMETRY), the plan: ops/autocorr.plan_stats of the
    scratch's header and unit list)."""
    from ..ops.autocorr import GEOMETRY, plan_stats
    B, Lpad = rows.shape
    G = lags.numel()
    raw = np.frombuffer(_run_raw(exe, [B, Lpad, G, sms, smem_block,
                                       smem_sm], (rows, lens, lags),
                                 timeout), np.int32)
    geo = dict(zip(GEOMETRY, raw[B * G:B * G + 8].tolist()))
    plan = torch.from_numpy(raw[B * G + 8:].copy())
    return (torch.from_numpy(raw[:B * G].reshape(B, G).copy()), geo,
            plan_stats(plan))
