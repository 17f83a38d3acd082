"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one card.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix or
metric lives in a file of its own under ``configs/``, ``traffic/``,
``limits/`` and ``metrics/``, found by the name ``BENCHMARK.json`` gives.
"""
