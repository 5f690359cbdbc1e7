"""The benchmark of the PyTorch/CUDA port ``qamreconciliation_tpu_torch``.

``python3 -m rrbench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json``; see ``rrbench/run.py``.
"""
