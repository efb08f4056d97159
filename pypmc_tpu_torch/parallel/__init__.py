"""Data parallelism over the particle axis: a particle mesh of
``torch.distributed`` ranks, each drawing its own shard of particles, with
the PMC and VB sufficient statistics summed over the ranks (O(K D^2)
communication where the reference gathers O(N D) samples to rank 0)."""

from .mesh import distributed_initialize, particle_mesh
from .sampler import ParallelSampler, pmc_run_sharded, run_is_step_sharded
