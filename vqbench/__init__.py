"""The benchmark of the PyTorch/CUDA port (``repro_torch``): ``run.py``
runs one cell of ``BENCHMARK.json``; see ``README.md``."""
