"""The benchmark of the PyTorch/CUDA port: ``python3 -m benchmark.run``
runs one cell of ``BENCHMARK.json`` (see ``run.py``)."""
