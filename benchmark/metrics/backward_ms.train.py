"""Round layer: device ms a step in the whole backward (the port's span
``fedicra.step.backward``), over the traced round's steps."""

from benchmark.harness.spans import span_ms_per_step

UNIT = "ms"


def read(record):
    return span_ms_per_step(record, ("fedicra.step.backward",))
