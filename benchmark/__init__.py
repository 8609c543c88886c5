"""The benchmark of ``dino_tpu_torch`` (the PyTorch and CUDA port).

``run.py`` runs one cell of ``BENCHMARK.json``; everything it needs for a
cell is found by name: the configuration under ``configs/``, the traffic
mix under ``workloads/``, the driver under ``drivers/``, the limits of the
correctness check under ``limits/`` and each per-layer metric's reader
under ``metrics/``.  ``reference/`` is the plain float32 model the check
compares with; it imports nothing of the port.  See ``README.md``.
"""
