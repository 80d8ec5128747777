"""Device layer: the share of the traced round's wall time in which no
operation ran on the card (%): 1 - the union of device intervals / wall."""

UNIT = "%"


def read(record):
    tr = record.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
