"""The (client, data) layout of the SPMD federation over process ranks.

Counterpart of ``fedicra_tpu/parallel/mesh.py``. JAX lays its devices out
as a ``Mesh`` and one program runs on all of them; here each device is one
process rank of a ``torch.distributed`` group, and the two mesh axes are
process subgroups:

- rank ``r`` sits at ``(r // data, r % data)``, as JAX reshapes its device
  list to the mesh shape;
- the ranks with the same data index form a **client group**: the FedAvg
  sum over the client axis (JAX's ``psum`` over ``client``) runs in it;
- the ranks with the same client index form a **data group**: they split
  their clients' batches between them (``parallel/data_axis.py``).

What JAX's three sharding helpers become:

- ``client_sharding`` (``P("client")``, the leading client axis split in
  contiguous blocks): ``Mesh.clients``, the ids this rank holds;
- ``batch_sharding`` (``P("client", None, "data")``): ``Mesh.data_shard``,
  this rank's rows of each of its clients' batches;
- ``replicated`` (``P()``): the global payload, which every rank holds whole.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch.distributed as dist

from .data_axis import DataShard


def mesh_shape(n_devices: int, num_clients: int) -> Tuple[int, int]:
    """(client, data): the client axis is the largest divisor of
    ``n_devices`` that also divides ``num_clients``, so every client-axis
    slice holds as many clients; the rest goes to the data axis."""
    c = 1
    for d in range(min(num_clients, n_devices), 0, -1):
        if n_devices % d == 0 and num_clients % d == 0:
            c = d
            break
    return c, n_devices // c


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the mesh. Groups of one rank are None."""

    shape: Tuple[int, int]
    rank: int
    num_clients: int
    client_group: Optional[Any] = None
    data_group: Optional[Any] = None

    @property
    def coords(self) -> Tuple[int, int]:
        return divmod(self.rank, self.shape[1])

    @property
    def clients(self) -> range:
        """The client ids this rank holds: its block of the client axis."""
        per = self.num_clients // self.shape[0]
        c = self.coords[0]
        return range(c * per, (c + 1) * per)

    def data_shard(self, batch: int) -> Optional[DataShard]:
        """This rank's share of a client batch of ``batch`` samples; None
        when the data axis has one rank."""
        if self.shape[1] == 1:
            return None
        return DataShard(self.data_group, self.coords[1], self.shape[1], batch)


def make_mesh(n_devices: Optional[int] = None, num_clients: Optional[int] = None) -> Mesh:
    """This rank's mesh over the ranks of the default process group.

    With no process group the mesh is (1, 1). ``n_devices``, when given,
    must be the group's size. Every rank must call this together: each
    subgroup is created by all ranks, in the same order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices over {world} ranks")
    num_clients = world if num_clients is None else num_clients
    shape = mesh_shape(world, num_clients)
    if world == 1:
        return Mesh(shape, 0, num_clients)
    rank = dist.get_rank()
    n_client, n_data = shape
    client_group = data_group = None
    for d in range(n_data):
        group = dist.new_group([c * n_data + d for c in range(n_client)])
        if rank % n_data == d and n_client > 1:
            client_group = group
    for c in range(n_client):
        group = dist.new_group([c * n_data + d for d in range(n_data)])
        if rank // n_data == c and n_data > 1:
            data_group = group
    return Mesh(shape, rank, num_clients, client_group, data_group)
