"""slambench: the benchmark of dpg_slam_tpu_torch on an NVIDIA card.

Run one cell: ``python3 -m slambench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout (BENCHMARK.json
lists the cells). The check's readings: ``python3 -m slambench.calibrate``.
Tests: ``python -m pytest slambench/tests`` (CPU; the card test skips
without a card)."""
