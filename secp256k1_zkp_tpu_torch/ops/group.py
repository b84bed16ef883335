"""secp256k1 point containers on PyTorch tensors.

Counterpart of the containers and constructors of the JAX package's
``ops/group.py``.  Points are structure-of-arrays dataclasses: each
coordinate is a batched limb tensor and infinity is an explicit lane
mask.  The portable group formulas (``gej_double``, ``gej_add_ge``, ...)
and ``ops/ecmult.py`` are not ported yet; the complete formulas the
verify kernels use live in ``ops/cuda_group.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from . import field as F
from .limb import LB, LIMBS


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
