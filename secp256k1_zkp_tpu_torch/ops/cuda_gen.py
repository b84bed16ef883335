"""Fixed-base multiplication k*G from signed-w7 comb digit rows, with the
optional generator blinding, and the epilogue kernels of the sign paths.

Counterpart of the JAX package's ``ops/pallas_gen.py``:

* ``comb_tables``, ``gen_digits``, ``fixedbase_digits`` and ``ecmult_gen``
  (``_comb_tables_np``, ``gen_digits``, ``_gen_kernel``,
  ``fixedbase_digits_tpu``, ``ecmult_gen_tpu``): digit position v (0..36)
  runs against its own 64-entry table of d * 2^(7v) * G, so k*G costs 37
  complete mixed adds and no doublings.  For a secret k the kernel
  selects each entry with a full table scan; ``fixedbase_public`` (a
  verifier's public scalar) reads the named entry alone, as the
  reference's verification ecmult does.  The plain version indexes the
  table directly.  With a :class:`Blind` (b, -b*G) the scalar is offset
  to k + b mod n in glue and the kernel ends with one more mixed add of
  -b*G, the blinding of the reference's ecmult_gen.
* ``ecdsa_sign_finish`` (``_ecdsa_finish_kernel``): affine R, r = x mod n
  with the overflow flag, s = k^-1 (m + r d), low-S, recid, ok.
* ``affine_xy`` (``_affine_xy_kernel``): jacobian -> canonical affine.
* ``muladd_n`` (``_muladd_n_kernel``): (neg ? n - k : k) + e*d mod n.

Each kernel wrapper takes CUDA tensors to its hand-written kernel
(``csrc/fixedbase.cu``, ``ecdsa_finish.cu``, ``affine_xy.cu``,
``muladd_n.cu``) and CPU tensors to the ``*_ref`` plain version beside it.
Every output is canonical.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from . import _build
from ..utils import hostcurve as hc
from .cuda_divsteps import inv_limbs16
from .cuda_field import (I64, LIMBS, MASK16, affine_operands,
                         affine_plain, canon_p, const_rows, group_arg,
                         lane_group, limbs16, ripple)
from .cuda_group import (FE, fe_const, fe_neg, fe_select, fe_weak,
                         jp_add_aff, jp_inf)
from .cuda_scalar import (N_ORDER, NW7, _RED, _N_HALF, _add_mod_n,
                          _is_gt_const, _is_zero16, _neg_mod_n, canon_n,
                          mul_limbs_n, recode_w7_256)

COMB_ENTRIES = 64   # signed-w7 magnitudes 1..64
I32 = torch.int32


class Blind(NamedTuple):
    """Generator-blinding state of a ``Context``: the secret scalar offset
    b and the affine point -b*G, as Python ints.  A blinded k*G runs as
    (k + b)*G + (-b*G)."""

    b: int
    gbx: int
    gby: int


@lru_cache(maxsize=1)
def comb_tables() -> torch.Tensor:
    """``[37, 64, 2, 16]`` int64 (CPU): entry ``[v, d-1]`` holds the x and y
    base-2^16 limbs of (d * 2^(7v) mod n) * G.

    Built by jacobian accumulation (base_{v+1} = 128 * base_v, entry_d =
    entry_{d-1} + base) and one shared Montgomery inversion."""
    jpts = []
    base = hc.jlift(hc.G)
    for _ in range(NW7):
        acc = base
        for _d in range(COMB_ENTRIES):
            jpts.append(acc)
            acc = hc.jadd(acc, base)
        for _ in range(7):
            base = hc.jdouble(base)
    flat = [[limbs16(x), limbs16(y)] for x, y in hc.batch_affine(jpts)]
    return torch.tensor(flat, dtype=I64).reshape(NW7, COMB_ENTRIES, 2, LIMBS)


def pack_words(tab: torch.Tensor) -> torch.Tensor:
    """``[..., 16]`` base-2^16 limbs -> ``[..., 8]`` int32 holding the bits
    of the kernels' 32-bit words."""
    words = tab[..., 0::2] | (tab[..., 1::2] << 16)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


@lru_cache(maxsize=8)
def _comb_words(device: str) -> torch.Tensor:
    """The kernel's table: ``[37, 64, 16]`` int32 words (x 0-7, y 8-15)."""
    return pack_words(comb_tables()).reshape(NW7, COMB_ENTRIES, 16) \
        .contiguous().to(device)


@lru_cache(maxsize=8)
def _comb_limbs(device: str) -> torch.Tensor:
    return comb_tables().to(device)


def gen_digits(k: torch.Tensor) -> torch.Tensor:
    """Canonical scalar ``[16, B]`` int32 -> its ``[37, B]`` int32 signed-w7
    comb rows (MSB-first), the operand of :func:`fixedbase_digits`.
    Elementwise glue in plain PyTorch on both devices, as it is XLA glue
    in the JAX package (``pallas_gen.gen_digits``)."""
    return recode_w7_256(k.to(I64)).to(I32)


def fixedbase_digits_ref(gdigs: torch.Tensor, gb=None):
    """Plain version of :func:`fixedbase_digits` (any device)."""
    gdigs = gdigs.to(I64)
    tab = _comb_limbs(str(gdigs.device))
    acc = jp_inf(gdigs[0])
    for i in range(NW7):
        row = gdigs[i]
        mag, sgn = row & 0xFF, (row >> 8) != 0
        # rows are MSB-first: row i is digit position NW7-1-i
        ent = tab[NW7 - 1 - i].index_select(0, (mag - 1).clamp(min=0))
        gx = FE(ent[:, 0, :].T, MASK16)
        gy = FE(ent[:, 1, :].T, MASK16)
        gy = fe_select(sgn, fe_weak(fe_neg(gy)), gy)
        acc = jp_add_aff(acc, gx, gy, mag == 0)
    if gb is not None:
        acc = jp_add_aff(acc, fe_const(gb[0], gdigs[0]),
                         fe_const(gb[1], gdigs[0]),
                         torch.zeros_like(acc.inf))
    # z = 0 marks infinity lanes (all-zero digits: k === 0 mod n)
    z = torch.where(acc.inf[None, :], torch.zeros_like(acc.z.l),
                    canon_p(fe_weak(acc.z).l))
    return (canon_p(fe_weak(acc.x).l).to(I32),
            canon_p(fe_weak(acc.y).l).to(I32), z.to(I32))


@lru_cache(maxsize=8)
def _gb_words(gbx: int, gby: int, device: str) -> torch.Tensor:
    """-b*G as the blinded kernel's 16 words (x 0-7, y 8-15)."""
    gb = torch.tensor([limbs16(gbx), limbs16(gby)], dtype=I64)
    return pack_words(gb).reshape(16).contiguous().to(device)


# how the kernel finds an entry (csrc/fixedbase.cu): a full scan of the
# row, or the named entry alone, for public digits
COMB_SCAN, COMB_GATHER = 0, 1
COMB_TEAMS = (1, 2, 4, 8)        # threads a lane the kernel takes
# warps an SM the team rule aims for: the scan's 256 loads a row want two
# warps on each of an SM's four schedulers, the gather's adds one (the
# sweep of chip_smoke.py, PERF.md)
COMB_WARPS = {COMB_SCAN: 8, COMB_GATHER: 4}


def comb_team(lanes: int, sms: int, mode: int) -> int:
    """Threads a lane of the comb (T): the most of ``COMB_TEAMS`` for
    which B * T threads stay within ``COMB_WARPS[mode]`` warps on each of
    the card's ``sms`` SMs; 1 once B alone reaches that.  Thread t of a
    team sums the rows t, t + T, ... and a tree of log2(T) complete adds
    joins the team."""
    team = 1
    while (2 * team <= COMB_TEAMS[-1]
           and lanes * 2 * team <= sms * 32 * COMB_WARPS[mode]):
        team *= 2
    return team


def _comb_launch(gdigs: torch.Tensor, gb, mode: int,
                 team: int | None = None):
    """One launch of ``csrc/fixedbase.cu`` on CUDA digit rows; ``team``
    None takes :func:`comb_team`'s T.  Counted as ``fixedbase_public``
    (gather), ``fixedbase_blinded`` (scan with gb) or ``fixedbase_digits``
    (scan)."""
    lanes = _build.check_rows(gdigs, NW7, "fixedbase gdigs")
    dev = str(gdigs.device)
    if team is None:
        team = comb_team(lanes, _build.sm_count(dev), mode)
    tab = _comb_words(dev)
    ox = torch.empty((LIMBS, lanes), dtype=I32, device=gdigs.device)
    oy = torch.empty_like(ox)
    oz = torch.empty_like(ox)
    gbw = None if gb is None else _gb_words(int(gb[0]), int(gb[1]), dev)
    lib = _build.lib()
    if mode == COMB_GATHER:
        _build.count_launch("fixedbase_public")
    elif gb is None:
        _build.count_launch("fixedbase_digits")
    else:
        _build.count_launch("fixedbase_blinded")
    _build.check(lib.secp_fixedbase(
        gdigs.data_ptr(), tab.data_ptr(),
        None if gbw is None else gbw.data_ptr(), ox.data_ptr(),
        oy.data_ptr(), oz.data_ptr(), lanes, team, int(mode == COMB_GATHER),
        _build.stream_ptr()), "fixedbase")
    return ox, oy, oz


def fixedbase_digits(gdigs: torch.Tensor, gb=None):
    """k*G for a **secret** k from signed-w7 comb digit rows ``[37, B]``
    int32 (the layout of ``cuda_scalar.recode_w7_256``, MSB-first); with
    ``gb = (x, y)``, the affine point -b*G as Python ints, one more
    complete mixed add of it (the blinded tail; the rows then encode
    k + b mod n).  Each entry is chosen by a full scan of its row.

    Returns jacobian (x, y, z) ``[16, B]`` int32 **canonical** limbs;
    z == 0 marks infinity lanes.  CUDA tensors go through the hand-written
    kernel (``csrc/fixedbase.cu``, one launch either way, counted as
    ``fixedbase_digits`` or ``fixedbase_blinded``); CPU tensors through
    the plain version."""
    if not gdigs.is_cuda:
        return fixedbase_digits_ref(gdigs, gb)
    return _comb_launch(gdigs, gb, COMB_SCAN)


def fixedbase_public(gdigs: torch.Tensor):
    """k*G for a **public** k (a verifier's scalar) from signed-w7 comb
    digit rows ``[37, B]`` int32: the digit names the table entry, which
    is read alone — no scan, so the time and the addresses depend on k.
    Never call it with a secret.

    Returns what :func:`fixedbase_digits` returns.  CUDA tensors go
    through the hand-written kernel (``csrc/fixedbase.cu``, counted as
    ``fixedbase_public``); CPU tensors through the plain version."""
    if not gdigs.is_cuda:
        return fixedbase_digits_ref(gdigs)
    return _comb_launch(gdigs, None, COMB_GATHER)


def blinded_digits(k: torch.Tensor, blind: Blind):
    """The blinded comb's operands for a canonical ``[16, B]`` int32
    scalar: the digit rows of k' = k + b mod n (glue) and ``gb``, the
    point -b*G for :func:`fixedbase_digits`."""
    kb = _add_mod_n(k.to(I64), const_rows(blind.b, k))
    return gen_digits(kb.to(I32)), (blind.gbx, blind.gby)


def ecmult_gen(k: torch.Tensor, blind: Blind | None = None):
    """k*G on a canonical ``[16, B]`` int32 **secret** scalar, through
    :func:`fixedbase_digits` (the scan); the counterpart of
    ``ecmult_gen_tpu``.

    With ``blind`` the digits are those of k' = k + b mod n
    (:func:`blinded_digits`) and the kernel adds -b*G at the end:
    (k + b)*G - b*G = k*G, the unblinded result.  On the lane k = n - b,
    k' = 0: every digit is zero, the accumulator stays at infinity and the
    last add gives -b*G = k*G."""
    if blind is None:
        return fixedbase_digits(gen_digits(k))
    return fixedbase_digits(*blinded_digits(k, blind))


# ---------------------------------------------------------------------------
# Epilogues of the sign paths
# ---------------------------------------------------------------------------


def affine_xy_ref(x, y, z):
    """Plain version of :func:`affine_xy` (any device)."""
    xa, ya = affine_plain(x, y, z)
    return xa.to(I32), ya.to(I32)


def affine_xy(x, y, z, group: int | None = None):
    """Jacobian (x, y, z) ``[16, B]`` int32 limbs -> canonical affine
    (x, y) ``[16, B]`` int32; infinity lanes (z = 0) give zeros.

    CUDA tensors go through the hand-written kernel (``csrc/affine_xy.cu``:
    ``group`` lanes a thread with one inverse for them, None taking
    :func:`cuda_field.affine_group`'s K); CPU tensors through the plain
    version."""
    if not x.is_cuda:
        return affine_xy_ref(x, y, z)
    lanes, group = affine_operands("affine_xy", x, y, z, group)
    ax = torch.empty_like(x)
    ay = torch.empty_like(x)
    lib = _build.lib()
    _build.count_launch("affine_xy")
    _build.check(lib.secp_affine_xy(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), ax.data_ptr(),
        ay.data_ptr(), lanes, group, _build.stream_ptr()), "affine_xy")
    return ax, ay


def ecdsa_sign_finish_ref(x, y, z, k, m, d):
    """Plain version of :func:`ecdsa_sign_finish` (any device)."""
    xa, ya = affine_plain(x, y, z)
    k, m, d = k.to(I64), m.to(I64), d.to(I64)
    # r = x mod n; x >= n  <=>  x + (2^256 - n) carries out (the overflow
    # flag of the reference)
    t, c = ripple(xa + const_rows(_RED, xa))
    ovf = c > 0
    r = torch.where(ovf[None, :], t, xa)
    kinv = inv_limbs16(k, N_ORDER)
    u = _add_mod_n(m, canon_n(mul_limbs_n(r, d)))
    s = canon_n(mul_limbs_n(kinv, u))
    high = _is_gt_const(s, _N_HALF)
    s = torch.where(high[None, :], _neg_mod_n(s), s)
    recid = ((ovf.to(I64) << 1) | (ya[0] & 1)) ^ high.to(I64)
    ok = ~_is_zero16(r) & ~_is_zero16(s)
    return r.to(I32), s.to(I32), recid.to(I32), ok


# the warps an SM the rule of ecdsa_sign_finish's lanes a thread aims for:
# its K sweep (chip_smoke.py, PERF.md) is fastest at K = 1 for 16,384
# lanes (3.9 warps an SM) and at K = 8 for 262,144 (7.8), not at K = 16
# (3.9)
FINISH_WARPS = 6


def finish_group(lanes: int, sms: int) -> int:
    """K of ``ecdsa_sign_finish``: :func:`cuda_field.lane_group` at
    ``FINISH_WARPS``."""
    return lane_group(lanes, sms, FINISH_WARPS)


def ecdsa_sign_finish(x, y, z, k, m, d, group: int | None = None):
    """ECDSA signing after R = k*G: jacobian R ``[16, B]`` and canonical
    k, m, d ``[16, B]`` int32 limbs -> (r ``[16, B]``, s ``[16, B]``
    canonical low-S, recid ``[B]`` int32, ok ``[B]`` bool).

    r = x(R) mod n, s = k^-1 (m + r d) mod n, negated where it exceeds
    (n-1)/2; recid = ((x(R) >= n ? 2 : 0) | y(R) odd) ^ negated; ok =
    r != 0 and s != 0.  CUDA tensors go through the hand-written kernel
    (``csrc/ecdsa_finish.cu``: ``group`` lanes a thread with one inverse
    of Z and one of k for them, None taking :func:`finish_group`'s K);
    CPU tensors through the plain version."""
    if not x.is_cuda:
        return ecdsa_sign_finish_ref(x, y, z, k, m, d)
    lanes = _build.check_rows(x, LIMBS, "ecdsa_sign_finish x")
    for name, t in (("y", y), ("z", z), ("k", k), ("m", m), ("d", d)):
        _build.check_rows(t, LIMBS, f"ecdsa_sign_finish {name}", lanes)
    group = group_arg("ecdsa_sign_finish", lanes, x.device, FINISH_WARPS,
                      group)
    r = torch.empty_like(x)
    s = torch.empty_like(x)
    meta = torch.empty((2, lanes), dtype=I32, device=x.device)
    lib = _build.lib()
    _build.count_launch("ecdsa_finish")
    _build.check(lib.secp_ecdsa_finish(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), k.data_ptr(),
        m.data_ptr(), d.data_ptr(), r.data_ptr(), s.data_ptr(),
        meta.data_ptr(), lanes, group, _build.stream_ptr()), "ecdsa_finish")
    return r, s, meta[0], meta[1] != 0


def muladd_n_ref(k, e, d, neg_k):
    """Plain version of :func:`muladd_n` (any device)."""
    k, e, d = k.to(I64), e.to(I64), d.to(I64)
    k = torch.where(neg_k.to(torch.bool)[None, :], _neg_mod_n(k), k)
    return _add_mod_n(k, canon_n(mul_limbs_n(e, d))).to(I32)


def muladd_n(k, e, d, neg_k):
    """(neg_k ? n - k : k) + e*d mod n on canonical ``[16, B]`` int32
    limbs, neg_k ``[B]`` bool -> canonical ``[16, B]`` int32: the BIP-340
    s = k + e*d with k negated where R has odd y.

    CUDA tensors go through the hand-written kernel (``csrc/muladd_n.cu``);
    CPU tensors through the plain version."""
    if not k.is_cuda:
        return muladd_n_ref(k, e, d, neg_k)
    lanes = _build.check_rows(k, LIMBS, "muladd_n k")
    _build.check_rows(e, LIMBS, "muladd_n e", lanes)
    _build.check_rows(d, LIMBS, "muladd_n d", lanes)
    if not neg_k.is_cuda or neg_k.shape != (lanes,):
        raise ValueError("muladd_n neg_k: expected a CUDA [B] mask")
    # neg32 dies with this call while the kernel may still run: safe, the
    # caching allocator reuses a block only in stream order
    neg32 = neg_k.to(I32).contiguous()
    s = torch.empty_like(k)
    lib = _build.lib()
    _build.count_launch("muladd_n")
    _build.check(lib.secp_muladd_n(
        k.data_ptr(), e.data_ptr(), d.data_ptr(), neg32.data_ptr(),
        s.data_ptr(), lanes, _build.stream_ptr()), "muladd_n")
    return s
