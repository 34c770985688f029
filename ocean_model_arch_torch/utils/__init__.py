"""Calendar and phase timers (counterpart of
``ocean_model_arch_tpu/utils``)."""
