"""Recoverable ECDSA (a 65-byte signature r || s || recid) on PyTorch
tensors.

Counterpart of the JAX package's ``modules/recovery.py`` (the reference's
recovery module, modules/recovery/main_impl.h): the representation and
API around ``ecdsa.sign`` (which already returns the recovery id) and
``ecdsa.recover`` (Q = r^-1 (s R - m G) on the kernel pipeline).
"""

from __future__ import annotations

import torch

from ..config import resolve_device
from ..ops import field as F
from ..ops.group import GE
from . import ecdsa


def sign_recoverable(msg32, sec32, blind=None, device="cuda"):
    """Deterministic RFC6979 recoverable signatures -> (sig64 ``[B, 64]``
    uint8, recid ``[B]`` int32, ok ``[B]``) (ecdsa_sign_recoverable,
    main_impl.h:141): ``ecdsa.sign``."""
    return ecdsa.sign(msg32, sec32, blind=blind, device=device)


def serialize_compact(sig64, recid) -> torch.Tensor:
    """(sig64, recid) -> ``[..., 65]`` uint8 r || s || recid
    (recoverable_signature_serialize_compact, main_impl.h:56)."""
    sig64 = torch.as_tensor(sig64).to(torch.uint8)
    rid = torch.as_tensor(recid).to(device=sig64.device, dtype=torch.uint8)
    return torch.cat([sig64, rid[..., None]], -1)


def parse_compact(sig65, device="cuda"):
    """``[..., 65]`` uint8 -> (sig64, recid int32, ok): ok is false where r
    or s overflowed n or recid is outside 0..3 (parse_compact,
    main_impl.h:35)."""
    sig65 = torch.as_tensor(sig65).to(resolve_device(device))
    sig64 = sig65[..., :64]
    recid = sig65[..., 64].to(torch.int32)
    _, _, ok = ecdsa.sig_parse_compact(sig64)
    return sig64, recid, ok & (recid <= 3)


def to_standard(sig64, recid):
    """Drop the recovery id (recoverable_signature_convert,
    main_impl.h:69)."""
    del recid
    return sig64


def recover(msg32, sig64, recid, device="cuda"):
    """Recover the signing public keys -> (Q ``GE``, ok ``[B]``)
    (secp256k1_ecdsa_recover, main_impl.h:170); ok implies Q is finite."""
    q, ok = ecdsa.recover(msg32, sig64, recid, device=device)
    return q, ok & ~q.inf


def recover_verify_consistency(msg32, sig64, recid, pub: GE, device="cuda"):
    """True where the recovered key is ``pub`` (the round trip the
    reference's tests assert)."""
    q, ok = recover(msg32, sig64, recid, device=device)
    pub = pub.to(q.device)
    same = F.eq(q.x, pub.x) & F.eq(q.y, pub.y) & (q.inf == pub.inf)
    return ok & same
