"""Vectorized simulation engine (the "array engine").

See :mod:`hbbft_tpu_torch.engine.array_engine` — the whole-network
lockstep executor that replaces per-message Python dispatch with
per-round batched array/crypto operations.
"""

from hbbft_tpu_torch.engine.array_engine import (
    ArrayHoneyBadgerNet,
    EngineInvariantError,
)

__all__ = ["ArrayHoneyBadgerNet", "EngineInvariantError"]
