"""Data loading of the port (counterparts of ``mingraph_unet_tpu/data``)."""
