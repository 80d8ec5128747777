"""Federation layer: device ms a round in each client's local round (``round_fn``), the port's span
``fedicra.fed.local_round``, in the traced round; the largest over the ranks."""

UNIT = "ms"


def read(record):
    return record.get("fed_span_ms", {}).get("fedicra.fed.local_round")
