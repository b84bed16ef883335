"""secp256k1 point containers on PyTorch tensors.

Counterpart of the containers and constructors of the JAX package's
``ops/group.py``, and of the formulas batch verify, Pedersen commitments
and generators need there: ``gej_from_ge``, ``gej_add``, ``gej_add_ge``,
``gej_eq`` and ``ge_from_gej``.  Points are structure-of-arrays
dataclasses: each coordinate is a batched limb tensor and infinity is an
explicit lane mask.  ``gej_add`` (and ``gej_add_ge``, with z = 1) is the
``gej_add`` kernel on a card, ``ge_from_gej`` the ``affine_xy`` kernel —
their plain versions on the CPU; ``gej_eq`` is plain PyTorch on either
device, as the JAX package computes it outside any Pallas kernel.  The
other portable formulas (``gej_double``, ``gej_add_zinv``, ...) and
``ops/ecmult.py`` are not ported yet; the complete formulas the kernels
use live in ``ops/cuda_group.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from . import cuda_gen, cuda_group
from . import field as F
from .cuda_field import canon_p, mul_limbs, sqr_limbs
from .limb import LB, LIMBS, from_rows, kernel_rows


@dataclasses.dataclass
class GE:
    """Affine point (structure-of-arrays). ``inf``: [...] bool mask."""

    x: LB
    y: LB
    inf: torch.Tensor

    @property
    def batch_shape(self):
        return self.x.batch_shape

    @property
    def device(self):
        return self.x.v.device

    def to(self, device) -> "GE":
        return GE(self.x.to(device), self.y.to(device), self.inf.to(device))


@dataclasses.dataclass
class GEJ:
    """Jacobian point: (X/Z^2, Y/Z^3). ``inf``: [...] bool mask."""

    x: LB
    y: LB
    z: LB
    inf: torch.Tensor

    @property
    def batch_shape(self):
        return self.x.batch_shape

    @property
    def device(self):
        return self.x.v.device

    def to(self, device) -> "GEJ":
        return GEJ(self.x.to(device), self.y.to(device), self.z.to(device),
                   self.inf.to(device))


def ge_from_ints(x: int, y: int, batch_shape=(), device="cpu") -> GE:
    xx, yy = F.fe(x, device), F.fe(y, device)
    if batch_shape:
        xx = LB(xx.v.expand(*batch_shape, LIMBS).contiguous(), xx.bound)
        yy = LB(yy.v.expand(*batch_shape, LIMBS).contiguous(), yy.bound)
    return GE(xx, yy, torch.zeros(batch_shape, dtype=torch.bool,
                                  device=device))


def generator(batch_shape=(), device="cpu") -> GE:
    return ge_from_ints(F.GX, F.GY, batch_shape, device)


def ge_is_on_curve(a: GE):
    """y^2 == x^3 + 7, or the point is infinity."""
    y2 = F.sqr(a.y)
    x3 = F.mul(F.sqr(a.x), a.x)
    rhs = F.add(x3, F.fe(F.B_COEFF, a.device))
    return a.inf | F.eq(y2, rhs)


def gej_infinity(batch_shape=(), device="cpu") -> GEJ:
    one = F.FP.one(batch_shape, device)
    return GEJ(F.fe_zero(batch_shape, device), one, one,
               torch.ones(batch_shape, dtype=torch.bool, device=device))


def gej_from_ge(a: GE) -> GEJ:
    """(x, y) -> (x, y, 1), the infinity mask kept."""
    return GEJ(a.x, a.y, F.FP.one(a.batch_shape, a.device), a.inf)


def gej_add(a: GEJ, b: GEJ) -> GEJ:
    """Complete general addition a + b (any batch shape, both alike):
    P + P, P + (-P) and infinity operands included.  Through
    ``cuda_group.gej_add``: the kernel on CUDA tensors, its plain version
    on CPU tensors; canonical coordinates out."""
    shape = a.batch_shape
    x, y, z, inf = cuda_group.gej_add(
        tuple(kernel_rows(F.norm_weak(c)) for c in (a.x, a.y, a.z))
        + (a.inf.reshape(-1),),
        tuple(kernel_rows(F.norm_weak(c)) for c in (b.x, b.y, b.z))
        + (b.inf.reshape(-1),))
    return GEJ(*(from_rows(t, shape) for t in (x, y, z)), inf.reshape(shape))


def gej_add_ge(a: GEJ, b: GE) -> GEJ:
    """a + b for an affine b: :func:`gej_add` with b's z = 1 (the same
    kernel; complete, infinity operands included)."""
    return gej_add(a, gej_from_ge(b))


def gej_eq(a: GEJ, b: GEJ):
    """Projective equality, infinity-aware: both infinite, or neither and
    X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3.  Computed on the limb rows
    of ``cuda_field`` with both sides side by side as lanes — one squaring
    and three multiplies, a tenth of the eager ops of the ``Mod`` route
    (batch verify ends with it)."""
    shape = torch.broadcast_shapes(a.batch_shape, b.batch_shape)

    def rows(*cs):
        return torch.cat([F.norm_weak(c).v.expand(*shape, LIMBS)
                          .reshape(-1, LIMBS).T for c in cs], 1)

    n = rows(a.z).shape[1]
    z = rows(a.z, b.z)
    zz = sqr_limbs(z)
    swap = [*range(n, 2 * n), *range(n)]
    c = canon_p(torch.cat([
        mul_limbs(rows(a.x, b.x), zz[:, swap]),        # X1 Z2^2 | X2 Z1^2
        mul_limbs(rows(a.y, b.y),
                  mul_limbs(zz, z)[:, swap])], 1))     # Y1 Z2^3 | Y2 Z1^3
    eq = ((c[:, :n] == c[:, n:2 * n]).all(0)
          & (c[:, 2 * n:3 * n] == c[:, 3 * n:]).all(0)).reshape(shape)
    return (a.inf & b.inf) | (~a.inf & ~b.inf & eq)


def ge_from_gej(a: GEJ) -> GE:
    """Affine conversion through ``cuda_gen.affine_xy``: the kernel on CUDA
    tensors, its plain version on CPU tensors (one safegcd inverse a
    lane; inv(0) = 0, so lanes with z = 0 give zeros beside their
    flag)."""
    shape = a.batch_shape
    x, y = cuda_gen.affine_xy(*(kernel_rows(F.norm_weak(c))
                                for c in (a.x, a.y, a.z)))
    return GE(from_rows(x, shape), from_rows(y, shape), a.inf)
