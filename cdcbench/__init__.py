"""cdcbench: the benchmark of the PyTorch and CUDA port ``tpucdc_torch`` on
the H100. ``python3 cdcbench/run.py --workload <name> --seed <n> --seconds
<s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once."""
