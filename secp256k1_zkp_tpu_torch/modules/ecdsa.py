"""Batched ECDSA verify over secp256k1 on PyTorch tensors.

Counterpart of the JAX package's ``modules/ecdsa.py``: ``sig_parse_compact``
and ``verify``, the kernel pipeline of ``verify_tpu``.  ``sign``,
``recover`` and the RFC6979 nonces wait for the slice that ports SHA256
and the signing kernels.

Batched-first: byte tensors are ``[B, 32]`` / ``[B, 64]`` uint8; the result
is a per-lane ``ok`` mask instead of an int return code.
"""

from __future__ import annotations

import torch

from ..config import resolve_device
from ..ops import cuda_gen, cuda_group, cuda_scalar
from ..ops import field as F
from ..ops import scalar as S
from ..ops.group import GE
from ..ops.limb import LB


def sig_parse_compact(sig64: torch.Tensor):
    """``[..., 64]`` uint8 -> (r, s, ok).  ok is false where r or s
    overflowed the group order."""
    r, rovf = S.from_bytes_be(sig64[..., :32])
    s, sovf = S.from_bytes_be(sig64[..., 32:])
    return r, s, ~rovf & ~sovf


def kernel_rows(a: LB) -> torch.Tensor:
    """``[B, 16]`` int64 limbs -> the kernels' ``[16, B]`` int32 operand."""
    return a.v.T.to(torch.int32).contiguous()


def verify(msg32, sig64, pub: GE, device="cuda"):
    """Batched ECDSA verify on compact signatures; low-S enforced.

    msg32 ``[B, 32]``, sig64 ``[B, 64]`` uint8, pub a ``GE`` of B points;
    returns ``[B]`` bool on ``device``.  The inputs are moved to ``device``
    (default ``"cuda"``, which raises when there is no card).  On a CUDA
    device the three hand-written kernels run — scalar prep, fixed-base
    comb, GLV Strauss with the fused x(R) === r check; on the CPU their
    plain versions.  No 256-bit multiply runs outside them."""
    dev = resolve_device(device)
    msg32 = torch.as_tensor(msg32).to(dev)
    sig64 = torch.as_tensor(sig64).to(dev)
    pub = pub.to(dev)
    if msg32.dim() != 2:
        raise ValueError("verify expects a 1-D batch: msg32 [B, 32]")
    if msg32.shape[0] == 0:                  # nothing to launch
        return torch.zeros(0, dtype=torch.bool, device=dev)

    m, _ = S.from_bytes_be(msg32)
    r, s, sig_ok = sig_parse_compact(sig64)
    nonzero = ~S.is_zero(r) & ~S.is_zero(s)

    r_t = kernel_rows(r)
    digs, gdigs, flags = cuda_scalar.ecdsa_prep(kernel_rows(m), r_t,
                                                 kernel_rows(s))
    gjac = cuda_gen.fixedbase_digits(gdigs)
    px = kernel_rows(F.normalize(pub.x))
    py = kernel_rows(F.normalize(pub.y))
    _, _, _, _, ok = cuda_group.ecmult_glv(digs, flags, px, py, pub.inf,
                                           gjac, rx=r_t)
    return ok & nonzero & ~pub.inf & ~S.is_high(s) & sig_ok
