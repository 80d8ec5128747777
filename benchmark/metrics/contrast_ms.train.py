"""Objective layer: device ms a step in the K - 1 no-grad contrast forwards
(the port's span ``fedicra.step.contrast``), over the traced round's steps."""

from benchmark.harness.spans import span_ms_per_step

UNIT = "ms"


def read(record):
    return span_ms_per_step(record, ("fedicra.step.contrast",))
