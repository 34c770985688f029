"""Mesh decomposition of the port (counterpart of
``ocean_model_arch_tpu/parallel``): so far the cut lines and their
accounting."""
