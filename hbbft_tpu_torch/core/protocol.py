"""The universal consensus-protocol interface.

Device-native analogue of hbbft's `DistAlgorithm`/`ConsensusProtocol` trait
(src/traits.rs §, unverified — SURVEY.md): every protocol is a deterministic
state machine with two entry points (`handle_input`, `handle_message`) that
each return a :class:`~hbbft_tpu_torch.core.types.Step`.
"""

from __future__ import annotations

import abc
from typing import Any

from hbbft_tpu_torch.core.types import Step


class ConsensusProtocol(abc.ABC):
    """Deterministic sans-I/O consensus state machine.

    Concrete protocols also expose protocol-specific typed entry points
    (e.g. ``Broadcast.broadcast(value)``); ``handle_input`` is the generic
    form used by the harness.
    """

    @abc.abstractmethod
    def handle_input(self, input: Any, rng=None) -> Step:
        """Feed a local input (proposal/contribution) into the machine."""

    @abc.abstractmethod
    def handle_message(self, sender_id: Any, message: Any, rng=None) -> Step:
        """Feed a message received from ``sender_id`` into the machine."""

    @abc.abstractmethod
    def terminated(self) -> bool:
        """True once the machine will never produce further output."""

    @abc.abstractmethod
    def our_id(self) -> Any:
        """This node's id."""
