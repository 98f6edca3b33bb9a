"""Parallelism: device meshes, sharded index, multi-host DP, ordered merge.

The reference's only parallelism is pthreads over read chunks with a
shared read-only index (SURVEY.md §2d); this package holds its JAX
replacements: data parallelism along a mesh `data` axis, block-sharded
FM-index lookups with psum over an `idx` axis (the tensor-parallel
analogue for human-scale genomes), jax.distributed multi-host wiring, and
deterministic ordered SAM merging.
"""

from .dp import make_data_mesh, make_mapping_step
from .distributed import (
    fastq_record_offsets,
    init_distributed,
    paired_record_ranges,
    shard_libraries,
)
from .merge import OrderedChunkWriter, merge_sam_shards
from .sharded_index import (
    ShardedFM,
    build_sharded_fm,
    sharded_occ4_batch,
    sharded_sa_gather,
    sharded_seed_scan,
)

__all__ = [
    "OrderedChunkWriter",
    "ShardedFM",
    "build_sharded_fm",
    "fastq_record_offsets",
    "init_distributed",
    "make_data_mesh",
    "make_mapping_step",
    "merge_sam_shards",
    "paired_record_ranges",
    "shard_libraries",
    "sharded_occ4_batch",
    "sharded_sa_gather",
    "sharded_seed_scan",
]
