"""Model layer: device ms a step in the step's own train-mode forward (the
port's span ``fedicra.step.forward``), over the traced round's steps."""

from benchmark.harness.spans import span_ms_per_step

UNIT = "ms"


def read(record):
    return span_ms_per_step(record, ("fedicra.step.forward",))
