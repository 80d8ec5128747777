"""Model layer: the window's steps' model FLOPs (``harness.work.step_flops``,
counted from the configuration's widths) over their time, as a share of the
card's peak in the configuration's precision (%)."""

UNIT = "%"


def read(record):
    steps, flops = record.get("step_s"), record.get("flops")
    if not steps or not flops:
        return None
    total = sum(len(steps[k]) * flops[k] for k in ("head", "body"))
    seconds = sum(sum(steps[k]) for k in ("head", "body"))
    return 100.0 * total / seconds / record["peak_flops"] if seconds > 0 else None
