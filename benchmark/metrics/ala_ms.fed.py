"""Federation layer: device ms a round in each client's ALA merge (one gate-learning epoch), the port's span
``fedicra.fed.ala``, in the traced round; the largest over the ranks."""

UNIT = "ms"


def read(record):
    return record.get("fed_span_ms", {}).get("fedicra.fed.ala")
