"""State carried across from the JAX package.

This system has no weights; its state is precomputed tables and the
containers callers hold.  These functions take the JAX package's arrays
**as numpy** (the port never imports that package) and return the port's
layouts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda_gen import Blind
from ..ops.group import GE
from ..ops.limb import DTYPE, LB, LIMBS, MASK16

_JAX_TAB_STRIDE = 128      # the reference pads each 64-entry window to 128
_NW7 = 37
_COMB_ENTRIES = 64


def lb_from_numpy(v, bound: int = MASK16, device="cpu") -> LB:
    """``[..., 16]`` uint32 limb array (an ``LB.v`` of the JAX package) ->
    the port's ``LB`` (int64 limbs, same static bound)."""
    arr = np.asarray(v).astype(np.int64)
    if arr.shape[-1] != LIMBS:
        raise ValueError(f"expected [..., {LIMBS}] limbs, got {arr.shape}")
    return LB(torch.from_numpy(arr).to(device=device, dtype=DTYPE), bound)


def ge_from_jax_limbs(x, y, inf, device="cpu") -> GE:
    """Affine point arrays (``GE.x.v``, ``GE.y.v``, ``GE.inf`` as numpy)
    -> the port's ``GE``."""
    return GE(lb_from_numpy(x, device=device), lb_from_numpy(y, device=device),
              torch.from_numpy(np.asarray(inf).astype(bool)).to(device))


def comb_table_from_jax(tab) -> torch.Tensor:
    """The reference's fixed-base comb table — ``[32, 37*128]`` uint32,
    column ``128*v + (d-1)`` holding the x||y limbs of d * 2^(7v) * G, each
    window padded to a 128-column stride — -> the port's ``[37, 64, 2, 16]``
    int64 layout (``ops.cuda_gen.comb_tables``)."""
    arr = np.asarray(tab).astype(np.int64)
    if arr.shape != (2 * LIMBS, _NW7 * _JAX_TAB_STRIDE):
        raise ValueError(f"unexpected comb table shape {arr.shape}")
    arr = arr.T.reshape(_NW7, _JAX_TAB_STRIDE, 2, LIMBS)
    if arr[:, _COMB_ENTRIES:].any():
        raise ValueError("padding columns of the comb table must be zero")
    return torch.from_numpy(arr[:, :_COMB_ENTRIES].copy())


def blind_from_jax(blind):
    """The JAX package's ``Context.blind`` — (b as 16 int limbs, -b*G's x
    and y as ``[16]`` uint32 limb arrays), or None — -> the port's
    ``Blind`` of Python ints (or None)."""
    if blind is None:
        return None

    def val(limbs):
        arr = np.asarray(limbs).astype(np.int64).reshape(-1)
        if arr.shape != (LIMBS,) or (arr > MASK16).any() or (arr < 0).any():
            raise ValueError(f"expected {LIMBS} limbs of 16 bits, got {arr}")
        return sum(int(v) << (16 * i) for i, v in enumerate(arr))

    b_limbs, gbx, gby = blind
    return Blind(val(b_limbs), val(gbx), val(gby))
