"""Scaling of the port (counterparts of ``mingraph_unet_tpu/parallel``): the process mesh, the
halo exchange, tiled and spatially sharded inference, data-parallel training."""
