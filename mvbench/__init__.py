"""The benchmark of the PyTorch and CUDA port of MV4PG (``repro_torch``).

``python3 mvbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON result line.  Everything a cell needs is found by name: its
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``, read by the loop it names in ``loops/``), its
data generator (``generators/<name>.py``) and each per-layer metric's
reader (``metrics/<metric>.py``).  ``reference/`` is the plain reference
that decides ``correct``; it imports nothing of the port.
"""
