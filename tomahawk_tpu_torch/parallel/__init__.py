from .distributed import (all_reduce_parts, init_distributed, merge_shards,
                          partition_tiles, rank_device, shard_output_path,
                          shard_paths, shutdown, sync_shards)
