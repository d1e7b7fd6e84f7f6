"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on an
NVIDIA H100: ``python3 -m perfbench.run`` runs one cell of
``BENCHMARK.json`` (see ``perfbench/README.md``)."""
