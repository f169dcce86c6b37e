"""Evaluation of the port (counterparts of ``mingraph_unet_tpu/experiments``)."""
