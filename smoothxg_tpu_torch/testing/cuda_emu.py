"""Run a whole-block POA kernel source (csrc/poa_win.cu, poa_code.cu,
poa_stacked.cu) on the CPU, for testing its logic where there is no GPU and
no nvcc.

`build(name, workdir)` rewrites csrc/<name>.cu for the CUDA emulation in
testing/cuda_emu.h (dynamic shared memory becomes a host buffer, a
`kernel<<<grid, block, smem, stream>>>(args)` launch becomes
`emu::launch(...)`), appends a main program and compiles it with g++ -std=c++20.
`run(exe, ...)` launches the kernel's C entry point `<name>_launch` on the
port's (seqs, slen, nseq, params) CPU tensors and returns (meta, exp,
paths), which must equal the plain PyTorch version's.  A race between
threads shows as a hang, so callers run it under a timeout.  `sms` stands
in for the card's SM count where a launch sizes its grid from it.
"""
from __future__ import annotations

import os
import re
import subprocess

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")

_MAIN = r"""
#include <cstdio>
#include <cstdlib>
int main(int argc, char** argv) {
    FILE* f = std::fopen(argv[1], "rb");
    int hd[9];
    if (std::fread(hd, 4, 9, f) != 9) return 2;
    const int B = hd[0], RW = hd[1], LW = hd[2], VW = hd[3], pcap = hd[4],
              local = hd[5], banded = hd[6], words = hd[7], W = hd[8];
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
                          scratch.data(), B, RW, LW, VW, WINDOW pcap, local,
                          banded, nullptr);
    f = std::fopen(argv[2], "wb");
    std::fwrite(meta.data(), 4, meta.size(), f);
    std::fwrite(exp_.data(), 4, exp_.size(), f);
    std::fwrite(paths.data(), 4, paths.size(), f);
    std::fclose(f);
    return rc;
}
"""


def _rewrite(src: str, sms: int | None) -> str:
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = (\1*)emu::dyn_smem.data();", src)
    src = re.sub(r"(\w+)<<<(.+?)>>>\(", r"emu::launch(\2, \1, ", src,
                 flags=re.S)
    if sms is not None:
        src = re.sub(r"constexpr int SMS = \d+;",
                     f"constexpr int SMS = {sms};", src)
    return src


def build(name: str, workdir: str, sms: int | None = None) -> str:
    """Compile csrc/<name>.cu with the emulation; returns the executable."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "cuda_runtime.h"), "w") as f:
        f.write(f'#include "{os.path.join(_HERE, "cuda_emu.h")}"\n')
    with open(os.path.join(CSRC, f"{name}.cu")) as f:
        src = _rewrite(f.read(), sms)
    cpp = os.path.join(workdir, f"{name}_emu.cpp")
    with open(cpp, "w") as f:
        # poa_win_launch takes the stored window width before pcap
        f.write(src + f"\n#define LAUNCH {name}_launch\n#define WINDOW "
                f"{'W,' if name == 'poa_win' else ''}\n" + _MAIN)
    exe = os.path.join(workdir, f"{name}_emu")
    subprocess.run([os.environ.get("CXX", "g++"), "-std=c++20", "-O1",
                    "-pthread", "-w", "-I", workdir, "-I", CSRC, "-o", exe,
                    cpp], check=True, capture_output=True, text=True,
                   timeout=300)
    return exe


def run(exe: str, seqs, slen, nseq, params, caps, words: int,
        timeout: float = 120.0):
    """Launch the emulated kernel on CPU tensors; returns (meta, exp,
    paths) as int32 tensors."""
    B, RW, LW = seqs.shape
    d = os.path.dirname(exe)
    inp, out = os.path.join(d, "in.bin"), os.path.join(d, "out.bin")
    with open(inp, "wb") as f:
        f.write(np.array([B, RW, LW, caps.VW, caps.pcap, int(caps.local),
                          int(caps.banded), words, caps.W],
                         np.int32).tobytes())
        for t in (seqs, slen, nseq, params):
            f.write(t.contiguous().numpy().tobytes())
    res = subprocess.run([exe, inp, out], capture_output=True, text=True,
                         timeout=timeout)
    if res.returncode != 0:
        raise RuntimeError(f"emulated launch failed: rc {res.returncode} "
                           f"{res.stderr[-400:]}")
    raw = np.fromfile(out, np.int32)
    n1, n2 = B * 4, B * 3 * caps.VW
    return (torch.from_numpy(raw[:n1].reshape(B, 4).copy()),
            torch.from_numpy(raw[n1:n1 + n2].reshape(B, 3, caps.VW).copy()),
            torch.from_numpy(raw[n1 + n2:].reshape(B, RW, LW).copy()))
