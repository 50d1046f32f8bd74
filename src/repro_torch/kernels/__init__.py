"""Hand-written CUDA kernels for Hopper (sm_90a), one per Pallas TPU
kernel on the port's path, decode attention (``decode_attn``) and the
Mamba-2 chain around the SSD scan (``ssm_chain``), which replace plain
jnp of the reference; each beside its plain PyTorch version.

A wrapper takes the plain version for CPU tensors and launches its
kernel for CUDA tensors (or raises); kernels build at first use (see
``_build``), so importing this package needs no nvcc and no GPU."""
