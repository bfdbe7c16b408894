"""The benchmark of swarm_simulator_tpu_torch on the card.

``python3 -m swarmbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Everything that
belongs to one configuration, traffic mix or per-layer metric is a file
of its own, found by the name the manifest gives it: ``configs/<config>.json``,
``traffic/<mix>.json`` and ``metrics/<metric>.py``.  ``reference/`` is the
plain reference that decides ``correct``; it imports nothing of the
program.
"""
