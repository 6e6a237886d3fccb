"""The benchmark of the PyTorch/CUDA port (``vibertgrid_tpu_torch``):
``BENCHMARK.json`` at the root names its cells and metrics, ``run.py`` runs
one cell once."""
