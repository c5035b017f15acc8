"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on one H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell needs is found by name: its configuration in
``configs/``, its traffic in ``workloads/``, its driver in ``drivers/`` and
each metric's reader in ``metrics/``.  The yardstick (weights, traffic,
operation counts, profiler reduction, the plain reference and the
comparison) lives here and imports nothing of the program.
"""
