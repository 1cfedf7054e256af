"""smoothxg_tpu_torch — the PyTorch + CUDA port of smoothxg_tpu.

Three POA engines run on an NVIDIA GPU through hand-written CUDA kernels:
the default whole-block engine (csrc/poa_win.cu, the port of
smoothxg_tpu/ops/poa_pallas_win.py:_win_core), the per-round engine of
`--engine pallas` (csrc/poa_round.cu, the port of
smoothxg_tpu/ops/poa_pallas.py:_pallas_fn) and the batched round engine of
`--engine jax` (csrc/poa_batch.cu, the port of
smoothxg_tpu/ops/poa_jax.py:_make_fn).  A run may be split over processes
(parallel/multiproc.py, torch.distributed) and a launch over cards
(parallel/mesh.py).  Every host stage — graph load,
prep, block finding, breaks, smoothing, lace with byte-exact path
validation, merge, MAF — is the port's own copy of the JAX package's, with
its C++ libraries built from csrc/host/ by g++ at first use.  The package
imports neither JAX nor anything of smoothxg_tpu.
"""

__version__ = "0.1.0"
