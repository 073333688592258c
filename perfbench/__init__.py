"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one cell
of ``BENCHMARK.json`` a run, ``python3 perfbench/run.py --workload NAME
--seed N --seconds S --trace 0|1`` from the root of a checkout."""
