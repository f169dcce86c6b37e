"""Hand-written CUDA kernels (sources in ``csrc/``) and their wrappers.
Counterpart of ``mingraph_unet_tpu/ops/pallas``."""
