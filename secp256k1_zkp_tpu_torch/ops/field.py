"""GF(p) for secp256k1, p = 2^256 - 2^32 - 977, on PyTorch tensors.

Thin instance of :class:`ops.limb.Mod`, counterpart of the JAX package's
``ops/field.py``.  ``sqrt``, ``is_square`` and ``inv`` are fixed-window
powers (``Mod.pow_const``): portable eager code on both devices, as they
are jnp and not Pallas in the JAX package.  Each is one chain of 64
windows — 334 multiplies and squarings of ``Mod``, about 400 eager
operations each, so about 10^5 kernel launches a call on a card, whatever
the batch.
"""

from __future__ import annotations

from .limb import LB, Mod, lb_from_int

P = 2 ** 256 - 2 ** 32 - 977

FP = Mod(P, name="fp")

# Curve constants (y^2 = x^3 + 7; generator per SEC2).
B_COEFF = 7
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

_SQRT_EXP = (P + 1) // 4
_IS_SQUARE_EXP = (P - 1) // 2


def fe(x: int, device="cpu") -> LB:
    return lb_from_int(x % P, device=device)


def fe_zero(batch_shape=(), device="cpu"):
    return FP.zero(batch_shape, device)


add = FP.add
sub = FP.sub
neg = FP.neg
mul = FP.mul
sqr = FP.sqr
mul_int = FP.mul_int
half = FP.half
normalize = FP.normalize
norm_weak = FP.norm_weak
is_zero = FP.is_zero
eq = FP.eq
is_odd = FP.is_odd
select = Mod.select
from_bytes_be = FP.from_bytes_be
inv = FP.inv


def sqrt(a: LB):
    """(r, ok): r = a^((p+1)/4), the principal root (a square itself), and
    ok where r^2 == a (a is a square)."""
    r = FP.pow_const(a, _SQRT_EXP)
    return r, eq(sqr(r), a)


def is_square(a: LB):
    """Euler's criterion, counting 0 as a square (as the JAX version
    does)."""
    t = FP.pow_const(a, _IS_SQUARE_EXP)
    return is_zero(a) | eq(t, FP.one((), a.device))


def to_bytes_be(a: LB):
    return Mod.to_bytes_be(a, FP)
