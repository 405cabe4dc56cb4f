"""The epoch critical-path stamp hook.

The protocols stamp lightweight completion events at their output seams
— RBC decode (``broadcast.py``), BA decision + coin reveal
(``binary_agreement.py``), decrypt combine + batch commit
(``honey_badger.py``) — through the module-level :func:`stamp`.  A
recorder installed with :func:`activate` (any object with the same
``stamp`` signature) receives them; with none active each call costs one
module-global ``is None`` check.

The port's copy of the JAX package's ``obs/critpath.py`` keeps only this
seam.  The recorder that rebuilds each epoch's gating chain from the
stamps, and the path reports over it, come with the harnesses that read
them.
"""

from __future__ import annotations

from typing import Any, Optional

_ACTIVE: Optional[Any] = None


def activate(recorder: Any) -> Any:
    """Install ``recorder`` as the process-wide stamp sink (single
    runtime at a time — harnesses activate around a run and deactivate
    in a ``finally``)."""
    global _ACTIVE
    _ACTIVE = recorder
    return recorder


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def stamp(
    phase: str,
    node: Any = None,
    instance: Optional[int] = None,
    rnd: Optional[int] = None,
    epoch: Optional[int] = None,
    value: Any = None,
) -> None:
    """Record a completion event on the active recorder (no-op when none
    is active).  Called from the protocol output seams."""
    r = _ACTIVE
    if r is not None:
        r.stamp(phase, node=node, instance=instance, rnd=rnd, epoch=epoch, value=value)
