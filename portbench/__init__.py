"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything that
belongs to one configuration, traffic mix, cell or per-layer metric is a
file of its own under this directory, found by the name that
``BENCHMARK.json`` gives it (see ``README.md``).
"""
