"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one
NVIDIA H100: ``python3 kbench/run.py --workload <cell> ...``."""
