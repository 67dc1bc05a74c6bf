"""Mesh and multi-process scale-out (``mesh``, ``distributed``)."""

from .distributed import (init_distributed, merge_caller_parts,
                          partition_files, partition_genome,
                          partition_intervals, run_caller_distributed,
                          run_mapper_distributed)
from .mesh import (Mesh, make_mesh, shard_units, sharded_call_step,
                   sharded_fused_step2, sharded_map_step)

__all__ = ["Mesh", "init_distributed", "make_mesh", "merge_caller_parts",
           "partition_files", "partition_genome", "partition_intervals",
           "run_caller_distributed", "run_mapper_distributed",
           "shard_units", "sharded_call_step", "sharded_fused_step2",
           "sharded_map_step"]
