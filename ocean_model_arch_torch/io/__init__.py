"""File formats of the model (counterpart of ``ocean_model_arch_tpu/io``):
so far the ASCII land/sea mask reader."""
