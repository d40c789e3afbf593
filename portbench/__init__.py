"""The benchmark of ``barcoder_tpu_torch`` on one or more CUDA cards.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Everything a cell is made of is found by name: its configuration in
``configs/<name>.json``, its traffic mix in ``traffic/<name>.json``, the
driver of the mix's kind in ``drivers/<kind>.py``, each metric's reader in
``metrics/<name>.py``. The plain reference that decides
``correct`` is in ``reference/``; the CPU tests are in ``checks/``.
"""
