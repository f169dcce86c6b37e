"""The benchmark of the PyTorch / CUDA port (``mingraph_unet_tpu_torch``).

``python -m port_bench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line. Every piece that belongs to one configuration, traffic mix,
per-layer metric or kernel sits in a file of its own that the harness finds
by name: ``configs/<config>.json``, ``traffic/<mix>.json``,
``limits/<workload>.json``, ``metrics/<metric>.py``,
``roofline/<kernel>.py``; ``drivers/<entry>.py`` are the loops a traffic
file names. ``reference/`` is the plain PyTorch reference that decides
``correct``; it imports nothing of the port.
"""
