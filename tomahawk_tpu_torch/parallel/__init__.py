from .distributed import (all_reduce_parts, allgather_records,
                          init_distributed, make_dcn_mesh,
                          merge_shards, mesh_is_multiprocess, partition_tiles,
                          process_devices, resolve_mesh,
                          shard_output_path, shard_paths, shutdown,
                          sync_shards)
from .mesh import Mesh, SamplesGroup, make_mesh
