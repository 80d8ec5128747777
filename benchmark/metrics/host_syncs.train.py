"""Round layer: synchronising CUDA operations a step, as the port counts them
over its traced round (``host_syncs``: from ``round_fn``'s entry to its
return, the backward's threads included, the caller's ``on_step`` left out)."""

from benchmark.harness.spans import count_per_step

UNIT = "count"


def read(record):
    return count_per_step(record, "host_syncs")
