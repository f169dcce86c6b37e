"""Command-line entry points, each the counterpart of the JAX repo's
``scripts/<name>.py`` and run as ``python -m
mingraph_unet_tpu_torch.scripts.<name>``; every ``main(argv=None)`` runs on
the CUDA card unless ``--cpu`` is given."""
