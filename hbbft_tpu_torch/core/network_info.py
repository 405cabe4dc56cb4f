"""Static per-era view of the validator set (hbbft `src/network_info.rs` §).

Holds the sorted validator ids, this node's threshold-crypto key material, and
the per-node public keys used for signing votes/key-gen messages.  Immutable
for the duration of an era; `DynamicHoneyBadger` swaps in a fresh instance on
era change.  The port's copy of the JAX package's ``core/network_info.py``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence


class NetworkInfo:
    """Validator-set metadata + our key shares for one era.

    Parameters mirror the reference constructor
    ``NetworkInfo::new(our_id, secret_key_share, public_key_set, secret_key,
    public_keys)`` (src/network_info.rs §, unverified).
    """

    def __init__(
        self,
        our_id,
        secret_key_share,
        public_key_set,
        secret_key,
        public_keys: Dict[Any, Any],
    ) -> None:
        self._our_id = our_id
        self._secret_key_share = secret_key_share
        self._public_key_set = public_key_set
        self._secret_key = secret_key
        self._public_keys = dict(public_keys)
        self._ids: List = sorted(self._public_keys.keys())
        self._index = {n: i for i, n in enumerate(self._ids)}
        self._is_validator = our_id in self._index
        if self._is_validator and secret_key_share is None:
            raise ValueError("validator NetworkInfo requires a secret key share")

    # -- identity -----------------------------------------------------------

    @property
    def our_id(self):
        return self._our_id

    def is_our_id(self, node_id) -> bool:
        return node_id == self._our_id

    def is_validator(self) -> bool:
        return self._is_validator

    def is_node_validator(self, node_id) -> bool:
        return node_id in self._index

    # -- membership ---------------------------------------------------------

    def all_ids(self) -> List:
        return list(self._ids)

    def other_ids(self) -> List:
        return [n for n in self._ids if n != self._our_id]

    def num_nodes(self) -> int:
        return len(self._ids)

    def num_faulty(self) -> int:
        """Max tolerated Byzantine nodes: f = ⌊(N−1)/3⌋."""
        return (len(self._ids) - 1) // 3

    def num_correct(self) -> int:
        return len(self._ids) - self.num_faulty()

    def node_index(self, node_id) -> Optional[int]:
        return self._index.get(node_id)

    def node_id(self, index: int):
        return self._ids[index]

    # -- keys ---------------------------------------------------------------

    @property
    def secret_key_share(self):
        return self._secret_key_share

    @property
    def secret_key(self):
        return self._secret_key

    @property
    def public_key_set(self):
        return self._public_key_set

    def public_key_share(self, node_id):
        idx = self.node_index(node_id)
        if idx is None:
            return None
        return self._public_key_set.public_key_share(idx)

    def public_key(self, node_id):
        return self._public_keys.get(node_id)

    def public_key_map(self) -> Dict[Any, Any]:
        return dict(self._public_keys)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"NetworkInfo(our_id={self._our_id!r}, N={self.num_nodes()},"
            f" f={self.num_faulty()}, validator={self._is_validator})"
        )

    @staticmethod
    def generate_map(ids: Sequence, rng, backend) -> Dict[Any, "NetworkInfo"]:
        """Trusted-dealer key setup for tests/benchmarks.

        Builds a full ``{id: NetworkInfo}`` map with a fresh master key set of
        threshold f = ⌊(N−1)/3⌋ (mirrors the reference test utilities §).
        ``backend`` is a :class:`~hbbft_tpu_torch.crypto.backend.CryptoBackend`.
        """
        ids = sorted(ids)
        n = len(ids)
        f = (n - 1) // 3
        sk_set = backend.generate_key_set(threshold=f, rng=rng)
        pk_set = sk_set.public_keys()
        secret_keys = {node: backend.generate_secret_key(rng) for node in ids}
        public_keys = {node: sk.public_key() for node, sk in secret_keys.items()}
        return {
            node: NetworkInfo(
                our_id=node,
                secret_key_share=sk_set.secret_key_share(i),
                public_key_set=pk_set,
                secret_key=secret_keys[node],
                public_keys=public_keys,
            )
            for i, node in enumerate(ids)
        }
