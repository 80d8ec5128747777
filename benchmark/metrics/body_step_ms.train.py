"""Round layer: the median body-phase step of the window (ms), timed by the
benchmark's host clock between synchronised ``on_step`` calls."""

import statistics

UNIT = "ms"


def read(record):
    steps = record.get("step_s", {}).get("body")
    return statistics.median(steps) * 1e3 if steps else None
