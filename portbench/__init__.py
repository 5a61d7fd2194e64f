"""The benchmark of ``bliss_tpu_torch`` on NVIDIA GPUs: one command runs one
cell of ``BENCHMARK.json``. See ``run.py``."""
