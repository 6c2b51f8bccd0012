"""The benchmark harness of the PyTorch / CUDA port (``repro_torch``).

``perfbench/run.py`` is its command; ``main.run_cell`` runs one cell once.
Everything a cell, configuration, traffic mix or per-layer metric needs is
found by name in ``BENCHMARK.json`` and the data files under
``perfbench/`` (``perfbench/README.md``).
"""
