"""GF(n) for secp256k1 (the group order), on PyTorch tensors.

Thin instance of :class:`ops.limb.Mod`, counterpart of the JAX package's
``ops/scalar.py``.  ``inv`` is the ``inv_n`` kernel on a card (safegcd)
and its plain version on the CPU, where the JAX package powers by n - 2:
the same canonical values.
"""

from __future__ import annotations

from . import cuda_scalar
from .limb import (LB, LIMBS, MASK16, Mod, _const, _ks_carry, from_rows,
                   kernel_rows, lb_from_int)

N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141

FN = Mod(N, name="fn")

N_HALF = (N - 1) // 2  # boundary for "high" scalars (low-S rule)


def sc(x: int, device="cpu") -> LB:
    return lb_from_int(x % N, device=device)


def zero(batch_shape=(), device="cpu"):
    return FN.zero(batch_shape, device)


def one(batch_shape=(), device="cpu"):
    return FN.one(batch_shape, device)


add = FN.add
sub = FN.sub
neg = FN.neg
mul = FN.mul
sqr = FN.sqr
normalize = FN.normalize
is_zero = FN.is_zero
eq = FN.eq
select = Mod.select
from_bytes_be = FN.from_bytes_be


def is_high(a: LB):
    """True where a > (n-1)/2: a + (2^256 - 1 - h) carries out."""
    x = FN.normalize(a)
    c = (1 << 256) - 1 - N_HALF
    comp = _const([(c >> (16 * i)) & MASK16 for i in range(LIMBS)], x.v)
    _, carry = _ks_carry(x.v + comp)
    return carry > 0


def inv(a: LB) -> LB:
    """a^-1 mod n, canonical; inv(0) = 0.  Through ``cuda_scalar.inv_n``:
    the kernel on CUDA tensors, its plain version on CPU tensors."""
    out = cuda_scalar.inv_n(kernel_rows(FN.normalize(a)))
    return from_rows(out, a.batch_shape)


def cond_negate(a: LB, mask) -> LB:
    """n - a where mask (weak), a elsewhere."""
    a = FN.norm_if_needed(a)
    return select(mask, FN.norm_weak(neg(a)), a)


def to_bytes_be(a: LB):
    return Mod.to_bytes_be(a, FN)
