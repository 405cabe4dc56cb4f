"""Mesh scale-out package.

Only the per-device shard pipeline (``shardpipe``) is here so far: the
race explorer's ``ShardedMockBackend`` and its ``shard`` mutant run it
with host-computed entries.  Like the dispatch pipeline it builds on, it
imports no torch.
"""

from hbbft_tpu_torch.parallel.shardpipe import (
    ShardedDispatchPipeline,
    placement_policy,
    shardpipe_enabled,
)

__all__ = ["ShardedDispatchPipeline", "placement_policy", "shardpipe_enabled"]
