"""The benchmark of gym_multigrid_tpu_torch on one NVIDIA H100.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; README.md says how
cells, configurations, traffic mixes and per-layer metrics are found.
"""
