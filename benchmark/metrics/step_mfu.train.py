"""Model layer: the window's steps' model FLOPs (``harness.work.step_flops``,
counted from the configuration's model module and widths, a step of each
phase) over their time, as a share of the card's peak in the
configuration's precision (%)."""

UNIT = "%"


def read(record):
    steps, flops = record.get("step_s"), record.get("flops")
    if not steps or not flops:
        return None
    total = sum(len(times) * flops[phase] for phase, times in steps.items())
    seconds = sum(sum(times) for times in steps.values())
    return 100.0 * total / seconds / record["peak_flops"] if seconds > 0 else None
