"""splatbench: the benchmark of ``tinysplat_torch`` on one NVIDIA H100.

``python3 -m splatbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see README.md.
"""
