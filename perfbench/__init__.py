"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON result line. Everything a cell needs is found by name:
``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<traffic>.json``, ``drivers/<driver>.py`` and one reader per
metric in ``metrics/<metric>.py``. The plain reference that decides
``correct`` is in ``reference/`` and imports nothing of the program.
"""
