"""Multi-device scale-out: device meshes, sharded count tables, collectives.

The reference is single-threaded (SURVEY.md §2: no parallelism of any kind);
this subpackage is the from-scratch mesh design mandated by BASELINE.json:
read batches stream data-parallel over the ``data`` mesh axis, the k-mer
count table is sharded by key range over the ``table`` axis, and per-shard
tables merge with ``psum`` collectives.
"""

from .exact import ShardedSpectrumAccumulator, sharded_count_file
from .multik import ShardedMultiKAccumulator, sharded_multi_k_count_file
from .mesh import make_mesh, mesh_shape_for
from .sharded import (
    CountState,
    HashCountState,
    init_count_state,
    make_hash_update_step,
    sharded_hash_count_file,
    sharded_spectrum,
    update_count_state,
)

__all__ = [
    "make_mesh",
    "mesh_shape_for",
    "CountState",
    "init_count_state",
    "update_count_state",
    "sharded_spectrum",
    "HashCountState",
    "make_hash_update_step",
    "sharded_hash_count_file",
    "ShardedSpectrumAccumulator",
    "sharded_count_file",
    "ShardedMultiKAccumulator",
    "sharded_multi_k_count_file",
]
