"""The benchmark of ``lightgbm_tpu_torch`` on one NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything a cell
needs is found by the names in that file: its configuration in
``configs/``, its traffic mix in ``traffic/``, the limits of its
correctness check in ``checks/``, each per-layer metric's reader in
``metrics/``. The plain reference that decides ``correct`` is in
``reference/`` and imports nothing of the program.
"""
