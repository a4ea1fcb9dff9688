"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON result line.  Everything a cell needs is found by name:
``cells/<cell>.json`` (its configuration, traffic, driver and limits),
``configs/<config>.json``, ``traffic/<traffic>.json``,
``drivers/<driver>.py`` and ``metrics/<metric>.py``.  ``counts/`` holds
the operation and byte counts and the card's peaks, ``reference/`` the
plain float32 model and the comparison that decides ``correct``.
"""
