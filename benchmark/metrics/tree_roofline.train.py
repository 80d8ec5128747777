"""Tree chain layer: a step's tree-chain bound over its measured kernel time
(%). The bound (``harness.work.tree_step_bound_ms``) is one MST, one
rooting, four filter forwards and four backwards at the step's shapes, at
the BFS depth the reference finds for the checked round's first step's
four trees; each is bound by its bytes."""

from benchmark.harness import work
from benchmark.harness.readers import load

UNIT = "%"
GUIDE_CHANNELS = 3  # the low guide's: an RGB image, or a gray one repeated


def read(record):
    measured = load("tree_kernels_ms.train").read(record)
    levels = record.get("tree_levels")
    if not measured or not levels:
        return None
    bound = work.tree_step_bound_ms(record["batch"], record["img_size"], record["num_classes"],
                                    GUIDE_CHANNELS, levels)
    return 100.0 * bound / measured
