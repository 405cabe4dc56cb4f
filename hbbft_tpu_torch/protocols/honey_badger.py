"""HoneyBadger's epoch output, the ``Batch`` (the JAX package's
``protocols/honey_badger.py``, which also holds the object-runtime
protocol).  The port carries only the dataclass: its array engine
(``engine/array_engine.py``) emits one ``Batch`` per node per epoch, a map
proposer → contribution.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple


@dataclass(slots=True)
class Batch:
    epoch: int
    contributions: Dict[Any, Any]

    def iter_all(self) -> List[Tuple[Any, Any]]:
        return sorted(self.contributions.items(), key=lambda kv: repr(kv[0]))

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Batch)
            and self.epoch == other.epoch
            and self.contributions == other.contributions
        )
