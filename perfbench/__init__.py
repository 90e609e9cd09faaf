"""Benchmark of the PyTorch and CUDA port (``repro_torch``): TopK-SGD
train steps, run as ``python3 perfbench/run.py --workload <name> --seed
<n> --seconds <s> --trace <0|1>`` from the root of a checkout."""
