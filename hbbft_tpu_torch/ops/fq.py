"""Fq — the BLS12-381 base field: the facade the tower, curve and pairing
layers bind to (the JAX package's ``ops/fq.py``).

The port carries the RNS implementation only (``ops/fq_rns.py``,
``(..., 79)`` float32 residue rows); the limb arm is still to be ported.
"""

from __future__ import annotations

from hbbft_tpu_torch.ops import fq_rns as _impl

NLIMBS = _impl.NLIMBS
DTYPE = _impl.DTYPE
NP_DTYPE = _impl.NP_DTYPE
ZERO = _impl.ZERO
ONE = _impl.ONE
from_int = _impl.from_int
from_ints = _impl.from_ints
to_int = _impl.to_int
to_ints = _impl.to_ints
to_numpy = _impl.to_numpy
carry3 = _impl.carry3
add = _impl.add
sub = _impl.sub
neg = _impl.neg
mul = _impl.mul
sqr = _impl.sqr
mul_n = _impl.mul_n
mul_small = _impl.mul_small
reduce_small = _impl.reduce_small
select = _impl.select
pow_fixed = _impl.pow_fixed
inv = _impl.inv
batch_inv = _impl.batch_inv
is_zero_host = _impl.is_zero_host
is_zero = _impl.is_zero
const = _impl.const
