"""The benchmark of the PyTorch and CUDA port of FedPFT (``repro_torch``).

``python3 pftbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once (``run.py``); ``BENCHMARK.json`` at the
root of the repository names the cells, their configurations, traffic mixes
and metrics, and ``bench.py`` says where each piece lives.
"""
