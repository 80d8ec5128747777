"""Tree chain layer: device ms a step in the tree chain's kernels
(``fedicra_torch/csrc/tree_filter.cu``: the MST, the BFS rooting, the
filter's two passes and their gathers and scatters, d embed), over the
traced round's steps. A kernel that replaces one of these is added here."""

from benchmark.harness.readers import kernel_ms_per_step

UNIT = "ms"
KERNELS = ("mst_tile_kernel", "mst_cross_kernel", "mst_contract_kernel", "tree_mask_kernel",
           "tree_bfs_kernel", "root_weights_kernel", "fwd_gather_kernel", "tree_pass_kernel",
           "fwd_scatter_kernel", "bwd_gather_kernel", "bwd_scatter_kernel", "dembed_kernel")


def read(record):
    return kernel_ms_per_step(record, KERNELS)
