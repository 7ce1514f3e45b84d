"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``bench/run.py`` runs one cell of ``BENCHMARK.json``: it builds the port's
serving engine through the launcher, drives it from a closed-loop client
pool on one card, times it on the host clock, optionally traces it, and
checks what the timed path served against the plain reference in
``bench/reference/``. Everything a cell names (configuration, traffic mix,
metric, reference) is a file of its own that the harness finds by name.
"""
