"""Spatial scaling of the port (counterparts of ``mingraph_unet_tpu/parallel``)."""
