from .data_axis import DataShard
from .launch import spawn_ranks
from .mesh import Mesh, make_mesh, mesh_shape

__all__ = ["DataShard", "Mesh", "make_mesh", "mesh_shape", "spawn_ranks"]
