"""Carry key material and device operands from the JAX package into the port.

The JAX package keeps its keys as plain Python ints and tuples inside
``hbbft_tpu.crypto.keys`` objects, and its field operands as numpy
residue or limb arrays.  These helpers rebuild the port's counterparts from
those values alone — ints, bytes (the canonical compressed encodings,
re-checked on the way in) and numpy — so the port never imports the JAX
package; the caller hands the objects over.

Both sides then verify the same shares under the same keys.
"""

from __future__ import annotations

import numpy as np
import torch

from hbbft_tpu_torch.crypto.bls381 import BLS381Group
from hbbft_tpu_torch.crypto.keys import (
    Ciphertext,
    DecryptionShare,
    PublicKeySet,
    PublicKeyShare,
    SecretKeySet,
    SecretKeyShare,
    Signature,
    SignatureShare,
)
from hbbft_tpu_torch.crypto.poly import Poly
from hbbft_tpu_torch.ops import fq_limb, fq_rns
from hbbft_tpu_torch.utils.device import resolve

_GROUP = BLS381Group()


def group() -> BLS381Group:
    """The port's BLS12-381 group (stateless; one shared instance)."""
    return _GROUP


def secret_key_set(sks) -> SecretKeySet:
    """A dealer's secret polynomial, coefficient for coefficient."""
    return SecretKeySet(Poly(_GROUP, [int(c) for c in sks.poly.coeffs]))


def secret_key_share(sk) -> SecretKeyShare:
    return SecretKeyShare(_GROUP, int(sk.x))


def public_key_set(pks) -> PublicKeySet:
    return PublicKeySet.from_bytes(_GROUP, pks.to_bytes())


def public_key_share(pk) -> PublicKeyShare:
    return PublicKeyShare(_GROUP, _GROUP.g1_from_bytes(pk.to_bytes()))


def ciphertext(ct) -> Ciphertext:
    return Ciphertext.from_bytes(_GROUP, ct.to_bytes())


def decryption_share(share) -> DecryptionShare:
    return DecryptionShare.from_bytes(_GROUP, share.to_bytes())


def signature_share(share) -> SignatureShare:
    """A signature share, through its compressed G2 encoding."""
    return SignatureShare(_GROUP, _GROUP.g2_from_bytes(share.to_bytes()))


def signature(sig) -> Signature:
    return Signature.from_bytes(_GROUP, sig.to_bytes())


def residues(arr, device=None) -> torch.Tensor:
    """A ``(..., 79)`` residue array of the JAX package's RNS field as a
    float32 tensor on ``device`` (default: the card).  The two packages
    share the prime bases, so the rows mean the same field elements."""
    a = np.array(arr, dtype=np.float32)
    if a.shape[-1] != fq_rns.NLIMBS:
        raise ValueError(f"expected (..., {fq_rns.NLIMBS}) residues, got {a.shape}")
    return torch.as_tensor(a, device=resolve(device))


def limbs(arr, device=None) -> torch.Tensor:
    """A ``(..., 50)`` limb array of the JAX package's limb field (8-bit
    limbs in float32) as a float32 tensor on ``device`` (default: the
    card).  Both packages read limb i as the digit of 2^(8i)."""
    a = np.array(arr, dtype=np.float32)
    if a.shape[-1] != fq_limb.NLIMBS:
        raise ValueError(f"expected (..., {fq_limb.NLIMBS}) limbs, got {a.shape}")
    return torch.as_tensor(a, device=resolve(device))
