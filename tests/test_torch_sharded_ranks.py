"""The sharded round over two gloo ranks on the CPU against JAX's (2, 1)
mesh, and a failing rank's launch.

Every rank is a spawned process with one torch thread (``OMP_NUM_THREADS=1``,
as in this process), in a process group over gloo on a free local port. The
data axis is in ``tests/test_torch_sharded_data.py``.
"""

import jax
import numpy as np
import pytest

from fedicra_torch.parallel import spawn_ranks
from torch_port_helpers import (  # noqa: F401 (fixtures: autouse)
    assert_sharded_rounds_agree, barrier_or_exit, jax_sharded_round, one_thread_per_rank,
    one_torch_thread, port_sharded_round_rank, sharded_inputs, sleeping_rank, spawned,
)


@pytest.mark.parametrize("case", ["pce-FedAvg", "ours-FedICRA"])
def test_sharded_round_equals_jax_on_two_ranks(tmp_path, case):
    """Two gloo ranks, one client each, against JAX's round on a (2, 1)
    virtual mesh, at the tolerances of the (1, 1) case
    (tests/test_torch_sharded.py)."""
    inputs = sharded_inputs(case)
    ranks = spawned(tmp_path, port_sharded_round_rank, (case, inputs), 2)
    (c0, params, stats), (c1, params1, stats1) = ranks
    assert sorted(c0) == [0] and sorted(c1) == [1]
    # the all-reduce leaves one global payload on both ranks
    for a, b in ((params, params1), (stats, stats1)):
        assert all(np.array_equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    port = ({**c0, **c1}, params, stats)
    assert_sharded_rounds_agree(case, port, jax_sharded_round(case, inputs, n_devices=2))


def test_a_failing_rank_makes_the_launch_raise(tmp_path):
    """Rank 1 exits with code 3; rank 0, waiting for it in a barrier, is
    stopped, and the launch raises naming both. Ranks still running at the
    launch's timeout are stopped too, and it raises."""
    with pytest.raises(RuntimeError, match=r"rank 1 exited with code 3; stopped rank 0"):
        spawn_ranks(barrier_or_exit, (1, 3), "gloo", ["cpu", "cpu"], timeout=120)
    with pytest.raises(RuntimeError, match=r"ranks still running after 5 s; stopped rank 0, 1"):
        spawn_ranks(sleeping_rank, (60,), "gloo", ["cpu", "cpu"], timeout=5)
