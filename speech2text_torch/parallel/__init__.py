"""Multi-GPU data parallelism and FSDP over torchrun ranks (port of
speech2text_tpu/parallel/): see mesh.py."""

from .mesh import (Mesh, MeshConfig, active, all_gather_object,
                   all_reduce_max, all_reduce_sum, barrier, broadcast_object,
                   full, full_state, gather_rows, gathered, global_count,
                   grad_norm, is_main, is_sharded, load_full_state, local,
                   make_mesh, prepare_restart, rank, setup, shard_rows,
                   shutdown, world_size, wrap_model)

__all__ = ["Mesh", "MeshConfig", "active", "all_gather_object",
           "all_reduce_max", "all_reduce_sum", "barrier", "broadcast_object",
           "full", "full_state", "gather_rows", "gathered", "global_count",
           "grad_norm", "is_main", "is_sharded", "load_full_state", "local",
           "make_mesh", "prepare_restart", "rank", "setup", "shard_rows",
           "shutdown", "world_size", "wrap_model"]
