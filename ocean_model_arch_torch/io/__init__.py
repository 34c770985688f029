"""File formats of the model (counterpart of ``ocean_model_arch_tpu/io``):
the ASCII land/sea mask, GrADS records and .ctl files, the native C++
helper that speeds both up, and the .npz checkpoint."""
