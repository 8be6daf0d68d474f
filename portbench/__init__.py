"""The benchmark of ``hebbax_torch``, the PyTorch and CUDA port, on NVIDIA
cards: one cell (a configuration under a traffic mix) per run of
``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the repository root.  ``BENCHMARK.json`` names the
cells; ``configs/``, ``traffic/``, ``metrics/`` and ``limits/`` hold one
file per configuration, mix, per-layer metric and cell."""
