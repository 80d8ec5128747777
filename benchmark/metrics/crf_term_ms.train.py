"""Gated CRF layer: device ms a step in the gated-CRF term (the port's span
``fedicra.step.crf_term``: the features, the fused kernel, the loss), over
the traced round's steps."""

from benchmark.harness.spans import span_ms_per_step

UNIT = "ms"


def read(record):
    return span_ms_per_step(record, ("fedicra.step.crf_term",))
