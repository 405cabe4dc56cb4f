"""Legacy ``TestNetwork`` harness — the pre-VirtualNet test API.

Rebuild of the reference's OLD integration harness (`tests/network/mod.rs`
§, SURVEY.md §2.1 "Legacy test harness": ``TestNetwork``, ``Adversary``,
``MessageScheduler::{Random, First}``), which predates the `tests/net/`
VirtualNet and survived in the vintage as a second, simpler driver.  Here
it is a THIN COMPAT LAYER over :mod:`hbbft_tpu_torch.net.virtual_net` — same
semantics, one implementation: the scheduler enum maps onto VirtualNet's
scheduler modes, the legacy crash-silence adversary is VirtualNet's
``SilentAdversary``, and the legacy bool-flip adversary is provided here
(it predates the generator-based ``RandomAdversary``).

Use VirtualNet/NetBuilder for new code — this module exists so a user of
the reference's legacy tests finds the surface they expect.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Optional, Tuple

from hbbft_tpu_torch.core.types import Step
from hbbft_tpu_torch.crypto.backend import CryptoBackend
from hbbft_tpu_torch.net.adversary import Adversary, NullAdversary, SilentAdversary
from hbbft_tpu_torch.net.virtual_net import NetBuilder, NetMessage, VirtualNet

__all__ = [
    "MessageScheduler",
    "TestNetwork",
    "SilentAdversary",
    "FlipBoolAdversary",
]


class MessageScheduler(enum.Enum):
    """Legacy delivery-order policy (reference ``MessageScheduler`` §)."""

    #: deliver a uniformly random pending message each step
    RANDOM = "random"
    #: always deliver the oldest pending message (FIFO)
    FIRST = "first"


class FlipBoolAdversary(Adversary):
    """Legacy bool-flip fault: faulty senders' boolean message fields are
    inverted (the classic BinaryAgreement equivocation-style corruption).

    Flips every ``bool``-typed dataclass field of the payload, recursing
    through nested dataclasses (the protocol message wrappers);
    non-dataclass payloads pass through unchanged.  A custom ``flip``
    callable overrides the behavior entirely."""

    def __init__(self, flip: Optional[Callable[[Any], Any]] = None) -> None:
        self._flip = flip

    def _flip_payload(self, payload: Any) -> Any:
        if self._flip is not None:
            return self._flip(payload)
        if not dataclasses.is_dataclass(payload):
            return payload
        changes: Dict[str, Any] = {}
        for f in dataclasses.fields(payload):
            v = getattr(payload, f.name)
            if isinstance(v, bool):
                changes[f.name] = not v
            elif dataclasses.is_dataclass(v) and not isinstance(v, type):
                inner = self._flip_payload(v)
                if inner is not v:
                    changes[f.name] = inner
        return dataclasses.replace(payload, **changes) if changes else payload

    def tamper(self, net: "VirtualNet", msg: "NetMessage") -> List["NetMessage"]:
        flipped = self._flip_payload(msg.payload)
        if flipped is msg.payload:
            return [msg]
        return [NetMessage(msg.sender, msg.to, flipped)]


class TestNetwork:
    """N-node deterministic harness with the legacy step-wise API.

    ``good_num`` correct + ``adv_num`` faulty nodes (ids ``0..N-1``;
    which ids are faulty is drawn by the seeded RNG — the VirtualNet
    convention; inspect ``nodes[i].faulty``);
    ``new_algorithm(netinfo, backend)`` constructs each node's protocol
    instance (same signature as ``NetBuilder.using``)."""

    __test__ = False  # "Test"-prefixed API name; not a pytest class

    def __init__(
        self,
        good_num: int,
        adv_num: int,
        new_algorithm: Callable[..., Any],
        *,
        backend: Optional[CryptoBackend] = None,
        scheduler: MessageScheduler = MessageScheduler.RANDOM,
        adversary: Optional[Adversary] = None,
        seed: int = 0,
    ) -> None:
        n = good_num + adv_num
        builder = (
            NetBuilder(range(n))
            .num_faulty(adv_num)
            .scheduler(scheduler.value)
            .adversary(adversary or NullAdversary())
        )
        if backend is not None:
            builder = builder.backend(backend)
        self.net: VirtualNet = builder.using(new_algorithm).build(seed=seed)
        self.scheduler = scheduler

    # -- legacy surface ------------------------------------------------------

    @property
    def nodes(self):
        return self.net.nodes

    def input(self, node_id: Any, value: Any) -> Step:
        """Feed one node's input (legacy ``input``)."""
        return self.net.send_input(node_id, value)

    def input_all(self, value: Any) -> None:
        """Same input to every node (legacy ``input_all``)."""
        self.net.broadcast_input(value)

    def step(self) -> Optional[Tuple[Any, Step]]:
        """Deliver ONE message per the scheduler; returns (node_id, step)
        or None when the network is quiescent."""
        return self.net.crank()

    def run(self, max_steps: int = 1_000_000) -> Dict[Any, List[Any]]:
        """Crank to quiescence; returns {node_id: outputs} for CORRECT
        nodes (the legacy harness asserted agreement over these)."""
        self.net.crank_to_quiescence(max_cranks=max_steps)
        return {node.id: list(node.outputs) for node in self.net.correct_nodes()}

    def outputs(self, node_id: Any) -> List[Any]:
        return list(self.net.nodes[node_id].outputs)
