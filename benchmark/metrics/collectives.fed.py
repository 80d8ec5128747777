"""Federation layer: all-reduces a round on rank 0, as the port counts them
(``collectives``, one per ``dist.all_reduce`` of the sharded round's FedAvg)
in the traced round."""

UNIT = "count"


def read(record):
    return record.get("fed_collectives")
