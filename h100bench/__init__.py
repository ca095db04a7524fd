"""The benchmark of ``tpu_composer_torch`` on an NVIDIA H100: run one cell
with ``python3 -m h100bench.run`` (see ``run.py``); ``BENCHMARK.json`` at
the root of the repo lists the cells and metrics."""
