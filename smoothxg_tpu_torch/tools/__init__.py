"""Hopper counterparts of the JAX package's TPU measurement tools (the
repository's tools/ directory), under the same file names: the
micro-probes of csrc/probes.cu and the stage profile of the code-chase
POA kernels.  Each runs as `python -m smoothxg_tpu_torch.tools.<name>` and
needs CUDA."""
