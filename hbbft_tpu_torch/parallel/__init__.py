"""Mesh scale-out package.

Lazy exports (PEP 562): ``shardpipe`` is import-light by design — the
race explorer drives :class:`ShardedDispatchPipeline` with MockBackend
entries on paths that import no torch — so importing
``hbbft_tpu_torch.parallel.shardpipe`` must not drag ``backend``/``mesh``
(and therefore torch) in through this package init.
"""

import importlib

_LAZY = {
    "MeshBackend": "hbbft_tpu_torch.parallel.backend",
    "BATCH_AXIS": "hbbft_tpu_torch.parallel.mesh",
    "device_mesh": "hbbft_tpu_torch.parallel.mesh",
    "shard_batch": "hbbft_tpu_torch.parallel.mesh",
    "sharded_combine_g2": "hbbft_tpu_torch.parallel.mesh",
    "sharded_product2": "hbbft_tpu_torch.parallel.mesh",
    "ShardedDispatchPipeline": "hbbft_tpu_torch.parallel.shardpipe",
    "placement_policy": "hbbft_tpu_torch.parallel.shardpipe",
    "shardpipe_enabled": "hbbft_tpu_torch.parallel.shardpipe",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
