"""The benchmark of the PyTorch and CUDA port, ``repro_torch``, on one
NVIDIA H100: ``python3 bench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``.  Imports nothing of the JAX package."""
