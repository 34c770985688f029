"""Mesh decomposition of the port (counterpart of
``ocean_model_arch_tpu/parallel``): the cut lines and their accounting
(``decomposition``), the shard mesh and its stacked layout (``mesh``),
mesh-divisible padding (``domain``) and the halo exchange between shards
with its self-test (``halo``)."""
