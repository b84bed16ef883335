"""Batched ECDSA over secp256k1 on PyTorch tensors.

Counterpart of the JAX package's ``modules/ecdsa.py``: ``sig_parse_compact``,
``verify`` (the kernel pipeline of ``verify_tpu``), the RFC6979 nonces
(``rfc6979_nonce``, ``_pick_nonce``), ``sign`` (the kernel pipeline of
``sign_tpu``: deterministic nonces, low-S, recovery id),
``recover_scalars`` / ``recover`` (public-key recovery, on the same
kernels as verify — the JAX package runs it on its portable ``ecmult``;
the values are the same) and ``signature_normalize``.

Batched-first: byte tensors are ``[B, 32]`` / ``[B, 64]`` uint8; the result
is a per-lane ``ok`` mask instead of an int return code.
"""

from __future__ import annotations

import torch

from ..config import resolve_device
from ..ops import cuda_field, cuda_gen, cuda_group, cuda_scalar
from ..ops import field as F
from ..ops import scalar as S
from ..ops import sha256 as H
from ..ops.group import GE
from ..ops.limb import from_rows, kernel_rows


def sig_parse_compact(sig64: torch.Tensor):
    """``[..., 64]`` uint8 -> (r, s, ok).  ok is false where r or s
    overflowed the group order."""
    r, rovf = S.from_bytes_be(sig64[..., :32])
    s, sovf = S.from_bytes_be(sig64[..., 32:])
    return r, s, ~rovf & ~sovf


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
    gjac = cuda_gen.fixedbase_public(gdigs)     # u1 is public
    px = kernel_rows(F.normalize(pub.x))
    py = kernel_rows(F.normalize(pub.y))
    _, _, _, _, ok = cuda_group.ecmult_glv(digs, flags, px, py, pub.inf,
                                           gjac, rx=r_t)
    return ok & nonzero & ~pub.inf & ~S.is_high(s) & sig_ok


def rfc6979_nonce(msg32, sec32, counter_rounds: int = 2):
    """Batched RFC6979 candidates, ``[counter_rounds, B, 8]`` words: the
    reference's nonce_function_rfc6979 with no extra data
    (src/secp256k1.c:519-560), key material sec32 || msg32.  On a card
    one launch of the ``rfc6979`` kernel; on the CPU (or with a
    ``set_compress`` override) :func:`rfc6979_nonce_ref`."""
    return H.rfc6979(torch.cat([sec32, msg32], -1), counter_rounds)


def rfc6979_nonce_ref(msg32, sec32, counter_rounds: int = 2):
    """Plain version of :func:`rfc6979_nonce`: the eager HMAC chain (ten
    HMACs for two candidates; on a card each hash a kernel launch)."""
    return H.rfc6979_chain(torch.cat([sec32, msg32], -1), counter_rounds)


def _pick_nonce(nonces_words):
    """The first candidate that is nonzero and < n, as the reference's
    retry loop takes it (secp256k1.c:585-634); two candidates leave a
    failure probability of about 2^-127.  Returns (k ``LB``, ok)."""
    chosen = chosen_ok = None
    for cand in nonces_words.unbind(0):
        k, ovf = S.from_bytes_be(H.words_to_bytes32(cand))
        ok = ~ovf & ~S.is_zero(k)
        if chosen is None:
            chosen, chosen_ok = k, ok
        else:
            chosen = S.select(~chosen_ok & ok, k, chosen)
            chosen_ok = chosen_ok | ok
    return chosen, chosen_ok


def sign(msg32, sec32, blind=None, device="cuda"):
    """Batched deterministic ECDSA sign (RFC6979 nonces, low-S).

    msg32, sec32 ``[B, 32]`` uint8; returns (sig64 ``[B, 64]`` uint8
    compact r || s, recid ``[B]`` int32, ok ``[B]`` bool) on ``device``
    (default ``"cuda"``, which raises when there is no card).  ok is false
    where the key is 0 or >= n (or, unreachably, r or s is 0); the
    signature is zeroed there.  ``blind`` is a ``Context.blind`` (or None):
    it changes the addition chain of k*G, never a byte of the result.

    The steps of ``sign_tpu``: parse d, the RFC6979 nonces (on a card one
    launch of the ``rfc6979`` kernel), k*G by the comb kernel (blinded or
    not), then the finish kernel for r, s, recid."""
    dev = resolve_device(device)
    msg32 = torch.as_tensor(msg32).to(dev)
    sec32 = torch.as_tensor(sec32).to(dev)
    if msg32.dim() != 2:
        raise ValueError("sign expects a 1-D batch: msg32 [B, 32]")
    lanes = msg32.shape[0]
    if lanes == 0:                           # nothing to launch
        return (torch.zeros((0, 64), dtype=torch.uint8, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))

    d, d_ovf = S.from_bytes_be(sec32)
    d_ok = ~d_ovf & ~S.is_zero(d)
    k, k_ok = _pick_nonce(rfc6979_nonce(msg32, sec32))
    m, _ = S.from_bytes_be(msg32)

    k_t = kernel_rows(k)
    x, y, z = cuda_gen.ecmult_gen(k_t, blind)
    r_t, s_t, recid, fin_ok = cuda_gen.ecdsa_sign_finish(
        x, y, z, k_t, kernel_rows(m), kernel_rows(d))
    ok = d_ok & k_ok & fin_ok
    sig64 = torch.cat([S.to_bytes_be(from_rows(r_t)),
                       S.to_bytes_be(from_rows(s_t))], -1)
    return sig64 * ok[:, None], recid, ok


def recover_scalars(m, r, s, recid):
    """Public-key recovery on parsed scalars ``LB`` ``[B, 16]`` and recovery
    ids ``[B]`` (ecdsa_sig_recover, modules/recovery/main_impl.h:87-121):
    Q = r^-1 (s R - m G), R the point with x = r (+ n where recid bit 1 is
    set) and y of recid bit 0's parity.  Returns (Q ``GE``, ok ``[B]``) on
    the scalars' device.

    ok is false where r = 0 or s = 0, where bit 1 is set but r + n is not
    below p, where x is not on the curve (R enters GLV Strauss as an
    infinite point, so the kernel runs with G in its place and masks it),
    and where Q is infinity.  The kernels: ``inv_n`` for r^-1, ``lift_x``
    for R's y, ``muladd_n`` for u2 = r^-1 s and u1 = -r^-1 m (both halves in
    one launch), ``glv_only`` for u2's split, the comb for u1*G, GLV
    Strauss for u1*G + u2*R and ``affine_xy`` for Q: seven launches on a
    card, their plain versions on the CPU."""
    lanes = r.v.shape[0]
    recid = torch.as_tensor(recid).to(r.device).to(torch.int64)
    i64 = torch.int64
    r_t = kernel_rows(S.normalize(r))
    m_t = kernel_rows(S.normalize(m)).to(i64)
    s_t = kernel_rows(S.normalize(s))
    # x = r, or (r + n) mod p where bit 1 is set, which must stay below p
    add_n = (recid & 2) == 2
    xr = r_t.to(i64)
    x_hi = cuda_field.canon_p(cuda_field.weak_p(
        xr + cuda_field.const_rows(S.N, xr)))
    x_t = torch.where(add_n[None, :], x_hi, xr).to(torch.int32)
    fits = ~add_n | ~cuda_scalar._is_gt_const(xr, F.P - S.N - 1)
    # R's y: the even root, negated where recid asks for an odd one
    ye, y_ok = cuda_field.lift_x(x_t)
    want_odd = (recid & 1) == 1
    y_t = torch.where(want_odd[None, :],
                      cuda_field._neg_canon(ye.to(i64)).to(torch.int32), ye)
    rinv = cuda_scalar.inv_n(r_t)
    us = cuda_gen.muladd_n(
        torch.zeros((16, 2 * lanes), dtype=torch.int32, device=r.device),
        torch.cat([rinv, rinv], 1),
        torch.cat([s_t, cuda_scalar._neg_mod_n(m_t).to(torch.int32)], 1),
        torch.zeros(2 * lanes, dtype=torch.bool, device=r.device))
    u2, u1 = us[:, :lanes].contiguous(), us[:, lanes:].contiguous()
    digs, flags = cuda_scalar.glv_only(u2)
    gjac = cuda_gen.fixedbase_public(cuda_gen.gen_digits(u1))  # public
    x, y, z, inf, _ = cuda_group.ecmult_glv(digs, flags, x_t, y_t, ~y_ok,
                                            gjac, rx=None)
    qx, qy = cuda_gen.affine_xy(x, y, z)
    ok = y_ok & fits & ~inf & ~S.is_zero(r) & ~S.is_zero(s)
    return GE(from_rows(qx), from_rows(qy), inf), ok


def recover(msg32, sig64, recid, device="cuda"):
    """Recover the signing public keys from compact signatures ``[B, 64]``,
    messages ``[B, 32]`` and recovery ids ``[B]`` -> (Q ``GE``, ok ``[B]``)
    on ``device`` (default ``"cuda"``, which raises when there is no
    card).  ok is also false where r or s overflowed n.  See
    :func:`recover_scalars` for the kernels."""
    dev = resolve_device(device)
    msg32 = torch.as_tensor(msg32).to(dev)
    sig64 = torch.as_tensor(sig64).to(dev)
    if msg32.dim() != 2:
        raise ValueError("recover expects a 1-D batch: msg32 [B, 32]")
    r, s, sig_ok = sig_parse_compact(sig64)
    m, _ = S.from_bytes_be(msg32)
    if msg32.shape[0] == 0:                  # nothing to launch
        return GE(r, r, sig_ok.clone()), sig_ok
    q, ok = recover_scalars(m, r, s, recid)
    return q, ok & sig_ok


def signature_normalize(sig64, device="cuda"):
    """Lower-S form of compact signatures ``[..., 64]``
    (ecdsa_signature_normalize) -> (sig64, was_high ``[...]`` bool)."""
    sig64 = torch.as_tensor(sig64).to(resolve_device(device))
    s, _ = S.from_bytes_be(sig64[..., 32:])
    high = S.is_high(s)
    s = S.select(high, S.normalize(S.neg(s)), S.normalize(s))
    return torch.cat([sig64[..., :32], S.to_bytes_be(s)], -1), high
