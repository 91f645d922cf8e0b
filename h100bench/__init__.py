"""The benchmark of ``emg_tpu_torch`` on one NVIDIA H100.

``python3 h100bench/run.py --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` once and prints its result as the last
line of standard output. Everything a cell needs is found by name: its
configuration under ``configs/``, its traffic mix under ``traffic/``, the
module of the traffic's ``kind`` under ``cells/`` and each per-layer metric's
reader under ``metrics/``. The plain reference that decides ``correct`` is
under ``reference/`` and imports nothing of the program.
"""
