"""Diagnostics of the port (counterpart of ``ocean_model_arch_tpu/diag``):
the margin exchange's bytes, its share of a step, and the weak-scaling
harness (``scaling``)."""
