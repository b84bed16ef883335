"""Batched BIP-340 Schnorr signatures over secp256k1 on PyTorch tensors.

Counterpart of the JAX package's ``modules/schnorrsig.py``: ``lift_x``,
``verify`` (the kernel pipeline of ``verify_tpu``, with the semantics of
``verify``, modules/schnorrsig/main_impl.h:215 in the reference),
``keypair_xonly`` and ``sign`` (the kernel pipelines of
``keypair_xonly_tpu`` and ``sign_tpu``: the BIP-340 default nonce
function with its tagged hashes, main_impl.h:16-92 and :122), and
``batch_verify`` (the kernel pipeline of ``batch_verify_tpu``: one
randomized equation over the whole batch, its two multi-scalar
multiplications on the MSM engine of ``ops/cuda_msm.py``).

Batched-first: byte tensors are ``[B, 32]`` / ``[B, 64]`` uint8; the result
is a per-lane ``ok`` mask (one bool for the whole batch in
``batch_verify``).
"""

from __future__ import annotations

import torch

from ..config import resolve_device
from ..ops import cuda_field, cuda_gen, cuda_group, cuda_scalar
from ..ops import field as F
from ..ops import group as G
from ..ops import scalar as S
from ..ops import sha256 as H
from ..ops.cuda_msm import msm_windowed
from ..ops.group import GE, GEJ
from ..ops.limb import LB, MASK16, from_rows, kernel_rows


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
    e, _ = S.from_bytes_be(H.tagged_digest("BIP0340/challenge", ch))
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
    gjac = cuda_gen.fixedbase_public(cuda_gen.gen_digits(kernel_rows(s)))
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
    tagged hashes are one ``sha256_msg`` launch each."""
    dev = resolve_device(device)
    msg32 = _batch_of(msg32, dev)
    sec32 = _batch_of(sec32, dev)
    aux32 = (torch.zeros_like(msg32) if aux32 is None
             else _batch_of(aux32, dev))
    if msg32.shape[0] == 0:                  # nothing to launch
        return (torch.zeros((0, 64), dtype=torch.uint8, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    d_even, px32, _, ok = keypair_xonly(sec32, blind, dev)

    t = S.to_bytes_be(d_even) ^ H.tagged_digest("BIP0340/aux", aux32)
    k, _ = S.from_bytes_be(H.tagged_digest(
        "BIP0340/nonce", torch.cat([t, px32, msg32], -1)))
    ok = ok & ~S.is_zero(k)

    k_t = kernel_rows(k)
    xa, ya = cuda_gen.affine_xy(*cuda_gen.ecmult_gen(k_t, blind))
    rx32 = F.to_bytes_be(from_rows(xa))
    e = challenge(rx32, px32, msg32)
    s_t = cuda_gen.muladd_n(k_t, kernel_rows(S.normalize(e)),
                            kernel_rows(d_even), (ya[0] & 1) == 1)
    sig64 = torch.cat([rx32, S.to_bytes_be(from_rows(s_t))], -1)
    return sig64 * ok[:, None], ok


# ---------------------------------------------------------------------------
# Batch verification
# ---------------------------------------------------------------------------


def _batch_digest(msgs32, sigs64, pxs32, n):
    """One 32-byte digest binding every batch input (each pk_i, msg_i and
    the whole sig_i): tagged leaf hashes of pk || msg || sig, then a binary
    tree of ``BIP0340/batch/node`` hashes, a zero node padding each odd
    level (``ops/sha256.batch_digest``).  One ``batch_digest`` launch on a
    card, whatever n."""
    return H.batch_digest(pxs32[:n], msgs32[:n], sigs64[:n])


def _batch_randomizers(msgs32, sigs64, pxs32, seed32, n):
    """The 128-bit randomizers z_i = H_tag("BIP0340/batch", seed || root
    || i) mod 2^128, z_0 = 1, with root = :func:`_batch_digest` of the
    whole batch (so no z_i is known before every signature is fixed);
    ``seed32`` None means 32 zero bytes.  Returns a canonical ``LB``."""
    dev = msgs32.device
    seed32 = (torch.zeros(32, dtype=torch.uint8, device=dev) if seed32 is None
              else seed32)
    root = _batch_digest(msgs32, sigs64, pxs32, n)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    i_b = torch.stack([(idx >> sh) & 0xFF for sh in (24, 16, 8, 0)],
                      -1).to(torch.uint8)
    zmsg = torch.cat([seed32.expand(n, 32), root.expand(n, 32), i_b], -1)
    z, _ = S.from_bytes_be(H.tagged_digest("BIP0340/batch", zmsg))
    zv = z.v.clone()
    zv[:, 8:] = 0                            # truncate to 128 bits
    zv[0] = 0
    zv[0, 0] = 1                             # z_0 = 1
    return LB(zv, MASK16)


def batch_verify(msgs32, sigs64, pxs32, seed32=None, device="cuda"):
    """All-or-nothing BIP-340 batch verification by one random linear
    combination:

        (sum_i z_i s_i) * G  ==  sum_i z_i R_i + sum_i (z_i e_i) P_i

    with the 128-bit randomizers of :func:`_batch_randomizers`.  msgs32
    ``[n, 32]``, sigs64 ``[n, 64]``, pxs32 ``[n, 32]`` uint8, seed32 None or
    32 bytes; returns a 0-d bool tensor on ``device`` (default
    ``"cuda"``, which raises when there is no card): True iff every
    signature is valid, except with negligible probability.  Any r >= p,
    s >= n, px >= p or failed lift rejects the batch.  n = 0 is refused,
    as the JAX function refuses it (its digest indexes the empty tree).

    The steps of ``batch_verify_tpu``: ``lift_x`` of the P_i and R_i (one
    launch over both); the challenges and the randomizers (one
    ``sha256_msg`` launch each) and the batch digest (one ``batch_digest``
    launch: leaves, node levels, padding); z*e and z*s by ``muladd_n``; sum z*s
    mod n as one column sum (exact in int64 for any n up to 2^47); two
    MSMs — sum z R with 128-bit scalars, sum (z e) P with 256-bit — on the
    MSM engine (failed lifts are infinite lanes); their sum by
    ``gej_add``; (sum z s)*G by the comb; projective equality."""
    dev = resolve_device(device)
    msgs32 = _batch_of(msgs32, dev)
    sigs64 = _batch_of(sigs64, dev)
    pxs32 = _batch_of(pxs32, dev)
    n = msgs32.shape[0]
    if n == 0:
        raise ValueError("batch_verify needs at least one signature")
    if seed32 is not None:
        seed32 = torch.as_tensor(seed32, dtype=torch.uint8).to(dev) \
            .reshape(32)
    rx, rx_ovf = F.from_bytes_be(sigs64[:, :32])
    s, s_ovf = S.from_bytes_be(sigs64[:, 32:])
    pkx, pkx_ovf = F.from_bytes_be(pxs32)
    # P's and R's lifts in one launch of 2n lanes
    ys, ys_ok = cuda_field.lift_x(torch.cat([kernel_rows(pkx),
                                             kernel_rows(rx)], 1))
    py, ry = ys[:, :n], ys[:, n:]
    p_ok, r_ok = ys_ok[:n], ys_ok[n:]
    ok = (p_ok & r_ok & ~rx_ovf & ~s_ovf & ~pkx_ovf).all()

    e = challenge(sigs64[:, :32], pxs32, msgs32)
    z = _batch_randomizers(msgs32, sigs64, pxs32, seed32, n)
    z_t = kernel_rows(z)
    zeros = torch.zeros_like(z_t)
    no_neg = torch.zeros(n, dtype=torch.bool, device=dev)
    ze_t = cuda_gen.muladd_n(zeros, kernel_rows(S.normalize(e)), z_t, no_neg)
    zs_t = cuda_gen.muladd_n(zeros, kernel_rows(s), z_t, no_neg)
    ssum = cuda_scalar.canon_n(cuda_scalar.reduce_cols_n(
        zs_t.to(torch.int64).sum(1, keepdim=True)))

    rhs = G.gej_add(msm_windowed(z, GE(rx, from_rows(ry), ~r_ok), 128),
                    msm_windowed(from_rows(ze_t),
                                 GE(pkx, from_rows(py), ~p_ok), 256))
    # the sum of z*s is public: the comb's gather entry
    lx, ly, lz = cuda_gen.fixedbase_public(
        cuda_gen.gen_digits(ssum.to(torch.int32)))
    lhs = GEJ(*(from_rows(t, ()) for t in (lx, ly, lz)), (lz[:, 0] == 0).all())
    return ok & G.gej_eq(lhs, rhs)
