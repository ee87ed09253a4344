"""PyTorch/CUDA port of the AGFT serving stack for an NVIDIA H100.

The JAX package ``repro`` beside this one is the reference. This package
imports neither JAX nor ``repro``: it keeps its own copies of the numpy
serving, tuning and energy modules, a PyTorch dense decoder LM, and
hand-written Hopper kernels (``repro_torch.kernels``) for the three Pallas
kernels on the serving path (RMSNorm, causal flash prefill, flash decode).
"""

__all__: list = []
