"""PyTorch + CUDA port of the shallow-water ocean framework (H100).

A second package beside ``ocean_model_arch_tpu`` (the JAX/Pallas
reference it is tested against). The numpy-only host modules (configs,
masks, metrics, constants, mask I/O) are shared with the JAX package
through :mod:`ocean_model_arch_torch.host`; nothing here imports jax.

Layout:
  __main__.py  ``python -m ocean_model_arch_torch <config_dir>``
  host.py    the shared numpy host modules + the numpy->torch dtype map
  config/    the four .par files and the presets (numpy only)
  io/        masks, GrADS records, the native I/O helper, checkpoints
  parallel/  cut lines and their accounting (numpy only)
  utils/     calendar, phase timers
  core/      Grid and SWState as dataclasses of tensors
  ops/       stencil access, the eager physics kernels, the fused-step
             layout helpers, the fused step (CUDA kernel + plain version)
  model/     initial state, the eager step composition, the fused step on
             a single block and on a mesh of shards, OceanModel
"""

__version__ = "0.1.0"
