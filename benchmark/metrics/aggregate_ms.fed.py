"""Federation layer: device ms a round in the FedAvg of the weights and the
BatchNorm statistics, the port's span ``fedicra.fed.aggregate``, in the
traced round; the largest over the ranks. Its all-reduces are inside, so
each rank's wait for its slowest peer is too."""

UNIT = "ms"


def read(record):
    return record.get("fed_span_ms", {}).get("fedicra.fed.aggregate")
