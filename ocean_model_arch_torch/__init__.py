"""PyTorch + CUDA port of the shallow-water ocean framework (H100).

A second package beside ``ocean_model_arch_tpu`` (the JAX/Pallas
reference it is tested against). The numpy-only host modules (configs,
masks, metrics, constants, mask I/O) are shared with the JAX package
through :mod:`ocean_model_arch_torch.host`; nothing here imports jax.

Layout:
  host.py    the shared numpy host modules + the numpy->torch dtype map
  core/      Grid and SWState as dataclasses of tensors
  ops/       stencil access, the eager physics kernels, the fused-step
             layout helpers, the fused step (CUDA kernel + plain version)
  model/     initial state, the eager step composition, the fused driver
"""

__version__ = "0.1.0"
