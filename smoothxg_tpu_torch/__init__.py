"""smoothxg_tpu_torch — the PyTorch + CUDA port of smoothxg_tpu.

The default smoothing path runs its per-block partial order alignment on an
NVIDIA GPU through one hand-written CUDA kernel (csrc/poa_win.cu, the port of
smoothxg_tpu/ops/poa_pallas_win.py:_win_core).  Every host stage — graph
load, prep, block finding, breaks, smoothing, lace with byte-exact path
validation, merge, MAF — is reused from smoothxg_tpu by import; none of them
imports JAX, and neither does this package.
"""

__version__ = "0.1.0"
