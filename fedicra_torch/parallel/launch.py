"""One process per rank: the process group the SPMD federation runs over.

JAX runs its SPMD round as one program over every visible device; here each
device is one process. ``spawn_ranks`` starts them with the ``spawn`` start
method, gives each ``torch.distributed.init_process_group`` over
``tcp://127.0.0.1:<port>`` (a free local port) with its rank and the world
size, and waits. NCCL needs a card per rank; gloo takes CPU tensors, or
several ranks on one card.
"""

from __future__ import annotations

import multiprocessing as mp
import socket
import time
from datetime import timedelta
from multiprocessing.connection import wait
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_main(rank: int, world_size: int, backend: str, port: int, device: str,
               target: Callable, args: tuple) -> None:
    if torch.device(device).index is not None and device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world_size, rank=rank,
        timeout=timedelta(minutes=10),
    )
    try:
        target(rank, device, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(target: Callable, args: tuple, backend: str, devices: Sequence[str],
                timeout: Optional[float] = None) -> None:
    """Run ``target(rank, device, *args)`` in one process per entry of
    ``devices``, in one process group over ``backend``.

    ``target`` must be importable by name (the processes are spawned).
    Raises RuntimeError naming each rank that exited non-zero; the ranks
    still running then are stopped, since they would wait on the dead one
    in their next collective. With ``timeout`` (seconds), ranks still
    running after it are stopped and the launch raises."""
    deadline = None if timeout is None else time.monotonic() + timeout
    world_size = len(devices)
    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=_rank_main,
                    args=(rank, world_size, backend, port, str(device), target, args))
        for rank, device in enumerate(devices)
    ]
    stopped = []
    try:
        for pr in procs:
            pr.start()
        while True:
            alive = [pr for pr in procs if pr.is_alive()]
            if not alive or any(pr.exitcode not in (None, 0) for pr in procs):
                break
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                break
            wait([pr.sentinel for pr in alive], timeout=left)  # until one exits
    finally:
        for rank, pr in enumerate(procs):
            if pr.is_alive():
                pr.terminate()
                stopped.append(rank)
        for pr in procs:
            if pr.pid is not None:  # started
                pr.join()
    failed = [f"rank {rank} exited with code {pr.exitcode}" for rank, pr in enumerate(procs)
              if pr.exitcode != 0 and rank not in stopped]
    if stopped and not failed:
        failed = [f"ranks still running after {timeout} s"]
    if failed:
        raise RuntimeError(
            "sharded run failed: " + "; ".join(failed)
            + ("; stopped rank " + ", ".join(map(str, stopped)) if stopped else "")
        )
