"""Runs over many ranks: ``torch.distributed`` in place of the reference's
MPI layer (reference: SURVEY.md section 5.8; the JAX package's
``artis_tpu/parallel``). Packets are sharded over the ranks as the
reference gives each rank its own packets (input.cc:1599-1607), the
estimator MPI_Allreduce (sn3d.cc:263-348) is one all-reduce, and the grid
update is split by cell ownership and all-gathered (sn3d.cc:197-261).
"""

from .distributed import maybe_init_distributed
from .mesh import make_mesh, transport_timestep_sharded

__all__ = ["make_mesh", "transport_timestep_sharded", "maybe_init_distributed"]
