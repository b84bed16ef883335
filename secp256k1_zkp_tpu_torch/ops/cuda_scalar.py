"""GF(n) (group-order) scalar arithmetic of the kernel library, the fused
ECDSA-verify *prep* kernel and the GLV-split kernel.

Counterpart of the JAX package's ``ops/pallas_scalar.py``: ``mul_limbs_n``,
``canon_n``, ``mul_shift384_round``, ``glv_split``, ``recode_signed`` as
plain PyTorch on limb-major ``[K, B]`` int64 rows, and ``ecdsa_prep`` —
s^-1 (safegcd), u1 = m/s, u2 = r/s, the GLV lambda split of u2 and the
signed digit rows the two point kernels consume — ``glv_only``, the
split and recoding alone (``glv_split_tpu``), and ``inv_n``, x^-1 mod n
(``inv_n_tpu``).  Every output is a canonical quantity (digits, flags,
canonical limbs), so kernel, plain version and the JAX helpers agree bit
for bit (the JAX inverse after canonicalisation: its result is weak).
"""

from __future__ import annotations

import torch

from . import _build
from .cuda_divsteps import inv_limbs16
from .cuda_field import (I64, LIMBS, MASK16, const_rows, group_arg,
                         lane_group, limbs16, mul_cols, ripple)

N_ORDER = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_RED = 2 ** 256 - N_ORDER                       # 129 bits: 9 limbs, top = 1

# GLV lambda-decomposition constants (public curve constants; the tests
# re-derive the lattice relations).
LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
_MINUS_B1 = 0xE4437ED6010E88286F547FA90ABFE4C3
_MINUS_B2 = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFE8A280AC50774346DD765CDA83DB1562C
_G1 = 0x3086D221A7D46BCDE86C90E49284EB153DAA8A1471E8CA7FE893209A45DBB031
_G2 = 0xE4437ED6010E88286F547FA90ABFE4C4221208AC9DF506C61571B4AE8AC47F71
_N_HALF = (N_ORDER - 1) // 2

NW5 = 26  # signed 5-bit windows covering a < 2^128 magnitude
NW7 = 37  # signed 7-bit windows covering a < 2^256 magnitude


def _fold_red(h: torch.Tensor) -> torch.Tensor:
    """h (``[K, B]`` limbs <= 0xFFFF) * red -> ``[K+8, B]`` columns."""
    return mul_cols(h, const_rows(_RED, h, 9))


def _add_low(cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """cols (at least 16 rows, zero-padded if shorter) + 16-row x."""
    if cols.shape[0] < LIMBS:
        cols = torch.cat([cols, cols.new_zeros(
            (LIMBS - cols.shape[0], cols.shape[1]))], 0)
    cols = cols.clone()
    cols[:LIMBS] += x
    return cols


def _ripple_ext(cols: torch.Tensor) -> torch.Tensor:
    """Exact ripple with the carry-out appended as one more row."""
    x, c = ripple(cols)
    return torch.cat([x, c[None]], 0)


def reduce_cols_n(cols: torch.Tensor) -> torch.Tensor:
    """Product columns (at most 32, value < 2^512) -> 16 weak limbs mod n.

    X = X_lo + 2^256*X_hi === X_lo + X_hi*red, applied three times:
    512 -> 385 -> 258 -> 257 bits, then one conditional fold."""
    if cols.shape[0] < 2 * LIMBS:
        cols = torch.cat([cols, cols.new_zeros(
            (2 * LIMBS - cols.shape[0], cols.shape[1]))], 0)
    x, _ = ripple(cols)                                   # 32 exact limbs
    y = _ripple_ext(_add_low(_fold_red(x[16:32]), x[:16]))  # < 2^385+2^256
    z = _ripple_ext(_add_low(_fold_red(y[16:25]), y[:16]))  # < 2^258+2^256
    w = _ripple_ext(_add_low(_fold_red(z[16:18]), z[:16]))  # < 2^256+2^146
    out, c = w[:LIMBS], w[LIMBS]                          # c is 0/1
    # if w reached 2^256 the remainder is < 2^146, so one fold and a
    # ripple are exact
    out, _ = ripple(out + c[None] * const_rows(_RED, out))
    return out


def mul_limbs_n(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod n on ``[16, B]`` limbs (weak output)."""
    return reduce_cols_n(mul_cols(a, b))


def canon_n(a: torch.Tensor) -> torch.Tensor:
    """Weak -> canonical mod n: x >= n  <=>  x + red carries out."""
    t, c = ripple(a + const_rows(_RED, a))
    return torch.where((c > 0)[None, :], t, a)


def _sub_from_const(c: int, b: torch.Tensor) -> torch.Tensor:
    """c - b with borrow ripple; requires c >= b (b canonical limbs)."""
    out = []
    borrow = None
    cl = limbs16(c)
    for i in range(LIMBS):
        d = (cl[i] + 0x10000) - b[i]
        d = d if borrow is None else d - borrow
        out.append(d & MASK16)
        borrow = 1 - (d >> 16)
    return torch.stack(out, 0)


def _is_gt_const(a: torch.Tensor, c: int) -> torch.Tensor:
    """a > c on canonical ``[16, B]`` limbs."""
    _, carry = ripple(a + const_rows((1 << 256) - 1 - c, a))
    return carry > 0


def _add_mod_n(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical a + b mod n (weak a, b < 2^256 also fine)."""
    t, c = ripple(a + b)
    t, _ = ripple(t + c[None] * const_rows(_RED, t))
    return canon_n(t)


def _neg_mod_n(a: torch.Tensor) -> torch.Tensor:
    """n - a for canonical a (a == 0 -> n -> canonical 0)."""
    return canon_n(_sub_from_const(N_ORDER, a))


def _is_zero16(a: torch.Tensor) -> torch.Tensor:
    """``[B]`` bool: all 16 limbs of the lane are zero."""
    return (a == 0).all(0)


def mul_shift384_round(k: torch.Tensor, g: int) -> torch.Tensor:
    """round(k * g / 2^384) -> ``[8, B]`` limbs (k canonical)."""
    cols, c = ripple(mul_cols(k, const_rows(g, k)))       # 31 exact limbs
    cols = torch.cat([cols, c[None]], 0)
    res = cols[24:32].clone()
    res[0] += cols[23] >> 15
    res, _ = ripple(res)
    return res


def glv_split(k: torch.Tensor):
    """k (canonical ``[16, B]``) -> (a1 ``[8, B]``, neg1 ``[B]``, a2, neg2)
    with k === s1*a1 + lambda*s2*a2 (mod n), s_i = (-1)^neg_i, a_i < 2^128.
    The algorithm of the reference's ``scalar_split_lambda``."""
    c1 = mul_shift384_round(k, _G1)
    c2 = mul_shift384_round(k, _G2)
    t1 = reduce_cols_n(mul_cols(c1, const_rows(_MINUS_B1, k, 8)))
    t2 = reduce_cols_n(mul_cols(c2, const_rows(_MINUS_B2, k)))
    r2 = _add_mod_n(t1, t2)
    # r1 = k - lambda*r2 (mod n)
    lr2 = canon_n(mul_limbs_n(r2, const_rows(LAMBDA, k)))
    r1 = _add_mod_n(k, _sub_from_const(N_ORDER, lr2))

    def mag(r):
        negf = _is_gt_const(r, _N_HALF)
        return torch.where(negf[None, :], _neg_mod_n(r), r)[:8], \
            negf.to(I64)

    a1, neg1 = mag(r1)
    a2, neg2 = mag(r2)
    return a1, neg1, a2, neg2


def recode_signed(limbs: torch.Tensor, nbits: int, w: int) -> torch.Tensor:
    """``[K, B]`` 16-bit limbs (value < 2^nbits) -> ``[nw, B]`` MSB-first
    signed w-bit digits encoded as ``mag | sign<<8``, digits in
    [-2^(w-1), 2^(w-1)], nw = ceil((nbits+1)/w).  Requires nbits % w != 0
    so the top digit absorbs the last carry."""
    nl = limbs.shape[0]
    assert nbits <= 16 * nl and nbits % w != 0 and w <= 8
    assert (1 << (nbits % w)) <= (1 << (w - 1))
    nw = (nbits + 1 + w - 1) // w
    half, full = 1 << (w - 1), 1 << w
    out = []
    carry = None
    for i in range(nw):
        idx, off = (w * i) // 16, (w * i) % 16
        if idx >= nl:
            raw = torch.zeros_like(limbs[0])
        else:
            raw = limbs[idx] >> off
            if off + w > 16 and idx + 1 < nl:
                raw = raw | (limbs[idx + 1] << (16 - off))
            raw = raw & (full - 1)
        d = raw if carry is None else raw + carry
        neg = d > half
        carry = neg.to(I64)
        out.append(torch.where(neg, full - d, d) | (carry << 8))
    return torch.stack(out[::-1], 0)


def recode_w5(l8: torch.Tensor) -> torch.Tensor:
    """``[8, B]`` limbs (value < 2^128) -> 26 MSB-first signed-w5 rows."""
    return recode_signed(l8, 128, 5)


def recode_w7_256(l16: torch.Tensor) -> torch.Tensor:
    """``[16, B]`` limbs -> 37 MSB-first signed-w7 rows (mag <= 64): the
    fixed-base comb stream, one table per digit position."""
    return recode_signed(l16, 256, 7)


# ---------------------------------------------------------------------------
# Fused ECDSA verify prep
# ---------------------------------------------------------------------------


def ecdsa_prep_ref(m: torch.Tensor, r: torch.Tensor, s: torch.Tensor):
    """Plain version of :func:`ecdsa_prep` (any device)."""
    m, r, s = m.to(I64), r.to(I64), s.to(I64)
    sinv = inv_limbs16(s, N_ORDER)
    u1 = canon_n(mul_limbs_n(m, sinv))
    u2 = canon_n(mul_limbs_n(r, sinv))
    a1, neg1, a2, neg2 = glv_split(u2)
    digs = torch.cat([recode_w5(a1), recode_w5(a2)], 0)
    gdigs = recode_w7_256(u1)
    flags = torch.stack([neg1, neg2], 0)
    i32 = torch.int32
    return digs.to(i32), gdigs.to(i32), flags.to(i32)


# the warps an SM the rule of ecdsa_prep's lanes a thread aims for: its K
# sweep (chip_smoke.py, PERF.md) is fastest at K = 1 for 16,384 lanes (3.9
# warps an SM) and at K = 8 for 262,144 (7.8), not at K = 16 (3.9)
PREP_WARPS = 6


def prep_group(lanes: int, sms: int) -> int:
    """K of ``ecdsa_prep``: :func:`cuda_field.lane_group` at
    ``PREP_WARPS``."""
    return lane_group(lanes, sms, PREP_WARPS)


def ecdsa_prep(m: torch.Tensor, r: torch.Tensor, s: torch.Tensor,
               group: int | None = None):
    """Fused ECDSA verify prep on ``[16, B]`` int32 limb-major canonical
    scalars.

    Returns (digits ``[52, B]``, gdigits ``[37, B]``, flags ``[2, B]``),
    all int32: digit rows 0-25 = a1, 26-51 = a2 (signed-w5, MSB-first,
    ``mag | sign<<8``) with u2 = (-1)^neg1 * a1 + lambda * (-1)^neg2 * a2
    (mod n); gdigits are u1's signed-w7 comb rows; flags = (neg1, neg2).
    s = 0 gives s^-1 = 0 (all-zero digits).

    CUDA tensors go through the hand-written kernel
    (``csrc/ecdsa_prep.cu``: ``group`` lanes a thread with one inverse of
    s for them, None taking :func:`prep_group`'s K); CPU tensors through
    the plain version."""
    if not m.is_cuda:
        return ecdsa_prep_ref(m, r, s)
    lanes = _build.check_rows(m, LIMBS, "ecdsa_prep m")
    _build.check_rows(r, LIMBS, "ecdsa_prep r", lanes)
    _build.check_rows(s, LIMBS, "ecdsa_prep s", lanes)
    group = group_arg("ecdsa_prep", lanes, m.device, PREP_WARPS, group)
    digs = torch.empty((2 * NW5, lanes), dtype=torch.int32, device=m.device)
    gdigs = torch.empty((NW7, lanes), dtype=torch.int32, device=m.device)
    flags = torch.empty((2, lanes), dtype=torch.int32, device=m.device)
    lib = _build.lib()
    _build.count_launch("ecdsa_prep")
    _build.check(lib.secp_ecdsa_prep(
        m.data_ptr(), r.data_ptr(), s.data_ptr(), digs.data_ptr(),
        gdigs.data_ptr(), flags.data_ptr(), lanes, group,
        _build.stream_ptr()), "ecdsa_prep")
    return digs, gdigs, flags


# ---------------------------------------------------------------------------
# GLV split alone (the Schnorr challenge)
# ---------------------------------------------------------------------------


def glv_only_ref(k: torch.Tensor):
    """Plain version of :func:`glv_only` (any device)."""
    a1, neg1, a2, neg2 = glv_split(k.to(I64))
    digs = torch.cat([recode_w5(a1), recode_w5(a2)], 0)
    flags = torch.stack([neg1, neg2], 0)
    return digs.to(torch.int32), flags.to(torch.int32)


def glv_only(k: torch.Tensor):
    """GLV lambda split of a canonical ``[16, B]`` int32 scalar.

    Returns (digits ``[52, B]``, flags ``[2, B]``), int32: rows 0-25 = a1,
    26-51 = a2 (signed-w5, MSB-first, ``mag | sign<<8``), flags = (neg1,
    neg2) with k = (-1)^neg1 * a1 + lambda * (-1)^neg2 * a2 (mod n) — the
    digit streams :func:`ecdsa_prep` makes for u2, here for any scalar.

    CUDA tensors go through the hand-written kernel
    (``csrc/glv_only.cu``); CPU tensors through the plain version."""
    if not k.is_cuda:
        return glv_only_ref(k)
    lanes = _build.check_rows(k, LIMBS, "glv_only k")
    digs = torch.empty((2 * NW5, lanes), dtype=torch.int32, device=k.device)
    flags = torch.empty((2, lanes), dtype=torch.int32, device=k.device)
    lib = _build.lib()
    _build.count_launch("glv_only")
    _build.check(lib.secp_glv_only(
        k.data_ptr(), digs.data_ptr(), flags.data_ptr(), lanes,
        _build.stream_ptr()), "glv_only")
    return digs, flags


# ---------------------------------------------------------------------------
# x^-1 mod n
# ---------------------------------------------------------------------------


def inv_n_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`inv_n` (any device)."""
    return inv_limbs16(canon_n(x.to(I64)), N_ORDER).to(torch.int32)


def inv_n(x: torch.Tensor) -> torch.Tensor:
    """x^-1 mod n on ``[16, B]`` int32 limb-major scalars (limbs <= 0xFFFF,
    any value < 2^256: reduced mod n first); returns the canonical
    inverse, ``[16, B]`` int32, with inv(0) = 0.

    CUDA tensors go through the hand-written kernel (``csrc/inv_n.cu``);
    CPU tensors through the plain version."""
    if not x.is_cuda:
        return inv_n_ref(x)
    lanes = _build.check_rows(x, LIMBS, "inv_n x")
    out = torch.empty_like(x)
    lib = _build.lib()
    _build.count_launch("inv_n")
    _build.check(lib.secp_inv_n(x.data_ptr(), out.data_ptr(), lanes,
                                _build.stream_ptr()), "inv_n")
    return out
