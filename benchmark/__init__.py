"""The benchmark of fedicra_torch, the PyTorch and CUDA port of FedICRA.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once, on the CUDA card
of the machine it runs on, and prints one JSON line last. Everything a cell
is made of is found by name: ``configs/<config>.json``, the precision it
names (``precisions/<precision>.json``), the reference module of the
model it names (``reference/models/<model>.py``), ``traffic/<traffic>.json``, the
driver of the traffic's kind (``drivers/<kind>.py``), ``limits/<cell>.json``
and, for each per-layer metric, ``metrics/<metric>.py``. ``reference/`` is
the plain PyTorch reference the port is held to; it imports nothing of the
port. ``tools/`` holds what sets the bounds and limits, and a probe of the
federated rounds.
"""
