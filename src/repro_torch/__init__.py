"""PyTorch/CUDA port of the streaming fast SPSD model (paper Algorithm 1).

The JAX package ``repro`` is the reference; this package is its counterpart
for NVIDIA Hopper.  Module names mirror the reference, so
``repro.core.spsd`` has its port in ``repro_torch.core.spsd`` and
``repro.kernels.pairwise.kernel`` (the Pallas TPU kernels) in
``repro_torch.kernels.pairwise.kernel`` (hand-written CUDA kernels with their
plain PyTorch versions beside them).

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``), where every kernel wrapper runs its plain PyTorch
version.  Nothing here imports ``jax`` or ``repro``.
"""
from repro_torch.device import default_device  # noqa: F401
