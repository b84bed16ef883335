"""Batched BIP-340 Schnorr verify over secp256k1 on PyTorch tensors.

Counterpart of the JAX package's ``modules/schnorrsig.py``: ``lift_x`` and
``verify``, the kernel pipeline of ``verify_tpu`` with the semantics of
``verify`` (modules/schnorrsig/main_impl.h:215 in the reference).
``sign``, ``keypair_xonly`` and ``batch_verify`` wait for the signing
and MSM slices.

Batched-first: byte tensors are ``[B, 32]`` / ``[B, 64]`` uint8; the result
is a per-lane ``ok`` mask.
"""

from __future__ import annotations

import torch

from ..config import resolve_device
from ..ops import cuda_field, cuda_gen, cuda_group, cuda_scalar
from ..ops import field as F
from ..ops import scalar as S
from ..ops import sha256 as H
from ..ops.group import GE
from ..ops.limb import LB, MASK16
from .ecdsa import kernel_rows


def _from_rows(t: torch.Tensor) -> LB:
    """The kernels' ``[16, B]`` int32 limbs -> ``[B, 16]`` int64 ``LB``."""
    return LB(t.T.to(torch.int64).contiguous(), MASK16)


def lift_x(px32, device="cuda"):
    """BIP-340 lift_x: x bytes ``[B, 32]`` -> (GE with even y, ok ``[B]``).

    ok is false where x >= p or x^3 + 7 is no square; those lanes are
    marked infinite.  On a CUDA device the ``lift_x`` kernel runs, on the
    CPU its plain version."""
    dev = resolve_device(device)
    px32 = torch.as_tensor(px32).to(dev)
    x, xovf = F.from_bytes_be(px32)
    y, on_curve = cuda_field.lift_x(kernel_rows(x))
    ok = on_curve & ~xovf
    return GE(x, _from_rows(y), ~ok), ok


def challenge(rx32, px32, msg32):
    """e = H_tag("BIP0340/challenge", r || px || msg) mod n, as a canonical
    ``LB`` (reduced, never rejected)."""
    ch = torch.cat([rx32, px32, msg32], -1)
    e_b = H.words_to_bytes32(H.tagged_hash_bytes("BIP0340/challenge", ch))
    e, _ = S.from_bytes_be(e_b)
    return e


def verify(msg32, sig64, px32, device="cuda"):
    """Batched BIP-340 verify: R = s*G - e*P; accept iff R is not
    infinity, y(R) is even and x(R) == r.

    msg32 ``[B, 32]``, sig64 ``[B, 64]``, px32 ``[B, 32]`` uint8 (x-only
    keys); returns ``[B]`` bool on ``device``.  The inputs are moved to
    ``device`` (default ``"cuda"``, which raises when there is no card).
    On a CUDA device the hand-written kernels run — SHA-256 for the
    challenge, lift_x, the GLV split of e, the fixed-base comb for s*G,
    GLV Strauss for s*G - e*P and the acceptance check; on the CPU their
    plain versions.  r >= p, s >= n and px >= p reject the lane through
    the final mask only: the kernels run on those lanes too."""
    dev = resolve_device(device)
    msg32 = torch.as_tensor(msg32).to(dev)
    sig64 = torch.as_tensor(sig64).to(dev)
    px32 = torch.as_tensor(px32).to(dev)
    if msg32.dim() != 2:
        raise ValueError("verify expects a 1-D batch: msg32 [B, 32]")
    lanes = msg32.shape[0]
    if lanes == 0:                           # nothing to launch
        return torch.zeros(0, dtype=torch.bool, device=dev)

    rx, rx_ovf = F.from_bytes_be(sig64[:, :32])
    s, s_ovf = S.from_bytes_be(sig64[:, 32:])
    pkx, pkx_ovf = F.from_bytes_be(px32)
    e = challenge(sig64[:, :32], px32, msg32)

    px_t = kernel_rows(pkx)
    py_t, on_curve = cuda_field.lift_x(px_t)
    edigs, eflags = cuda_scalar.glv_only(kernel_rows(S.normalize(e)))
    eflags = eflags ^ 1                      # R = s*G + (-e)*P
    gjac = cuda_gen.fixedbase_digits(cuda_gen.gen_digits(kernel_rows(s)))
    # P off the curve is not masked here: the lane is rejected below
    pinf = torch.zeros(lanes, dtype=torch.bool, device=dev)
    x, y, z, inf, _ = cuda_group.ecmult_glv(edigs, eflags, px_t, py_t,
                                            pinf, gjac, rx=None)
    ok = cuda_field.schnorr_check(x, y, z, inf,
                                  kernel_rows(F.normalize(rx)))
    return ok & on_curve & ~pkx_ovf & ~rx_ovf & ~s_ovf
