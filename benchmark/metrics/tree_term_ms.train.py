"""Tree chain layer: device ms a step in the tree term, forward and backward:
the port's spans ``fedicra.step.tree_term`` (edge weights, the MST, the
rooting, the four filter forwards, the resizes, the loss) and
``fedicra.tree.filter_backward`` (each filter's backward), over the traced
round's steps."""

from benchmark.harness.spans import span_ms_per_step

UNIT = "ms"


def read(record):
    return span_ms_per_step(record, ("fedicra.step.tree_term", "fedicra.tree.filter_backward"))
