"""Batched BIP-340 Schnorr signatures over secp256k1 on PyTorch tensors.

Counterpart of the JAX package's ``modules/schnorrsig.py``: ``lift_x``,
``verify`` (the kernel pipeline of ``verify_tpu``, with the semantics of
``verify``, modules/schnorrsig/main_impl.h:215 in the reference),
``keypair_xonly`` and ``sign`` (the kernel pipelines of
``keypair_xonly_tpu`` and ``sign_tpu``: the BIP-340 default nonce
function with its tagged hashes, main_impl.h:16-92 and :122).
``batch_verify`` waits for the MSM slice.

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
from .ecdsa import from_rows, kernel_rows


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
    return GE(x, from_rows(y), ~ok), ok


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


def _batch_of(t, dev):
    t = torch.as_tensor(t).to(dev)
    if t.dim() != 2:
        raise ValueError("expected a 1-D batch of byte strings [B, 32]")
    return t


def keypair_xonly(sec32, blind=None, device="cuda"):
    """BIP-340 keypairs: sec32 ``[B, 32]`` uint8 -> (d_even ``LB``, px32
    ``[B, 32]`` uint8 x-only key, parity ``[B]`` bool, ok ``[B]`` bool).

    d_even is d, negated where d*G has odd y (parity), so d_even*G has
    even y; ok is false where d is 0 or >= n.  On a CUDA device the comb
    kernel (blinded with ``blind``, a ``Context.blind``, or not) and the
    ``affine_xy`` kernel run; on the CPU their plain versions."""
    dev = resolve_device(device)
    sec32 = _batch_of(sec32, dev)
    d, d_ovf = S.from_bytes_be(sec32)
    ok = ~d_ovf & ~S.is_zero(d)
    if sec32.shape[0] == 0:                  # nothing to launch
        return d, torch.zeros_like(sec32), ok.clone(), ok
    xa, ya = cuda_gen.affine_xy(*cuda_gen.ecmult_gen(kernel_rows(d), blind))
    parity = (ya[0] & 1) == 1
    d_even = S.select(parity, S.normalize(S.neg(d)), S.normalize(d))
    return d_even, F.to_bytes_be(from_rows(xa)), parity, ok


def sign(msg32, sec32, aux32=None, blind=None, device="cuda"):
    """Batched BIP-340 sign with the default nonce function.

    msg32, sec32, aux32 ``[B, 32]`` uint8 (aux32 None means zeros);
    returns (sig64 ``[B, 64]`` uint8, ok ``[B]`` bool) on ``device``
    (default ``"cuda"``, which raises when there is no card).  ok is false
    where the key is 0 or >= n, or the nonce is 0; the signature is zeroed
    there.  ``blind`` (a ``Context.blind`` or None) changes no byte.

    The steps of ``sign_tpu``: the keypair (comb, ``affine_xy``); t = d
    XOR H_aux(aux); k = H_nonce(t || px || msg) mod n; R = k*G (comb,
    ``affine_xy``); e = H_challenge(r || px || msg) mod n; s = (R odd ?
    n - k : k) + e*d by the ``muladd_n`` kernel.  On a card the three
    tagged hashes are one SHA-256 kernel launch each."""
    dev = resolve_device(device)
    msg32 = _batch_of(msg32, dev)
    sec32 = _batch_of(sec32, dev)
    aux32 = (torch.zeros_like(msg32) if aux32 is None
             else _batch_of(aux32, dev))
    if msg32.shape[0] == 0:                  # nothing to launch
        return (torch.zeros((0, 64), dtype=torch.uint8, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    d_even, px32, _, ok = keypair_xonly(sec32, blind, dev)

    aux_hash = H.words_to_bytes32(H.tagged_hash_bytes("BIP0340/aux", aux32))
    t = S.to_bytes_be(d_even) ^ aux_hash
    rand = H.words_to_bytes32(H.tagged_hash_bytes(
        "BIP0340/nonce", torch.cat([t, px32, msg32], -1)))
    k, _ = S.from_bytes_be(rand)
    ok = ok & ~S.is_zero(k)

    k_t = kernel_rows(k)
    xa, ya = cuda_gen.affine_xy(*cuda_gen.ecmult_gen(k_t, blind))
    rx32 = F.to_bytes_be(from_rows(xa))
    e = challenge(rx32, px32, msg32)
    s_t = cuda_gen.muladd_n(k_t, kernel_rows(S.normalize(e)),
                            kernel_rows(d_even), (ya[0] & 1) == 1)
    sig64 = torch.cat([rx32, S.to_bytes_be(from_rows(s_t))], -1)
    return sig64 * ok[:, None], ok
