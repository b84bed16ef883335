"""Batched multi-precision modular arithmetic on PyTorch tensors.

Counterpart of the JAX package's ``ops/limb.py`` with the same public
contract: a 256-bit integer is a **lane-major tensor** ``[..., 16]`` of
base-2^16 limbs (little-endian), every value carries a *static* Python-int
bound on its limbs, and the bound asserts fire at call time.

Storage decision (made once, here): limbs are held in ``torch.int64`` on
the CPU and on CUDA alike.  ``torch.uint32`` has thin operator coverage,
and int64 holds every intermediate of the uint32 design without wrapping
— the uint32 bound asserts are kept, so each operation computes exactly
the limbs the JAX version computes.  Conversion to ``int32`` (same bits
as the kernels' ``uint32``) happens only at the kernel boundary, in the
wrappers of ``ops/cuda_*.py``.

``Mod.pow_const``/``Mod.inv`` are the JAX package's fixed-window Fermat
chain, as portable eager code on both devices (the field's ``sqrt``,
``is_square`` and ``inv`` run on it); the kernels take their inverses by
safegcd (``csrc/modinv.cuh``, ``ops/cuda_divsteps.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as tnf

LIMBS = 16
LIMB_BITS = 16
MASK16 = 0xFFFF
U32_MAX = 0xFFFFFFFF

DTYPE = torch.int64


@dataclasses.dataclass
class LB:
    """A batched big integer: ``v`` is ``[..., K]`` int64 limbs (base 2^16,
    little-endian, each in [0, bound]); ``bound`` is a static per-limb
    upper bound (inclusive)."""

    v: torch.Tensor
    bound: int

    def __post_init__(self):
        self.bound = int(self.bound)

    @property
    def shape(self):
        return self.v.shape

    @property
    def batch_shape(self):
        return self.v.shape[:-1]

    @property
    def device(self):
        return self.v.device

    def to(self, device) -> "LB":
        return LB(self.v.to(device), self.bound)

    def __repr__(self):
        return (f"LB(shape={tuple(self.v.shape)}, bound={hex(self.bound)}, "
                f"device={self.v.device})")


def int_to_limbs(x: int, limbs: int = LIMBS) -> list[int]:
    return [(x >> (LIMB_BITS * i)) & MASK16 for i in range(limbs)]


def lb_from_int(x: int, limbs: int = LIMBS, device="cpu") -> LB:
    """Constant (unbatched) LB from a Python int."""
    assert 0 <= x < (1 << (LIMB_BITS * limbs))
    return LB(torch.tensor(int_to_limbs(x, limbs), dtype=DTYPE,
                           device=device), MASK16)


def kernel_rows(a: LB) -> torch.Tensor:
    """``[..., 16]`` limbs (each <= 0xFFFF) -> the kernels' ``[16, B]``
    int32 operand, the batch flattened."""
    return a.v.reshape(-1, LIMBS).T.to(torch.int32).contiguous()


def from_rows(t: torch.Tensor, batch_shape=None) -> LB:
    """The kernels' ``[16, B]`` int32 limbs -> an int64 ``LB`` of shape
    ``[B, 16]``, or ``[*batch_shape, 16]``."""
    v = t.T.to(DTYPE)
    if batch_shape is not None:
        v = v.reshape(*batch_shape, LIMBS)
    return LB(v.contiguous(), MASK16)


def limbs_to_int_np(arr) -> int:
    """Host-side: collapse a limb vector (last axis) to a Python int."""
    arr = np.asarray(arr, dtype=np.uint64)
    out = 0
    for i in reversed(range(arr.shape[-1])):
        out = (out << LIMB_BITS) | int(arr[..., i])
    return out


def _const(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(list(values), dtype=DTYPE, device=like.device)


# ---------------------------------------------------------------------------
# Wide (column) arithmetic: column k carries weight 2^(16k); column values
# may exceed 2^16 (carry-save form).
# ---------------------------------------------------------------------------


def _diag_colsum(prod: torch.Tensor) -> torch.Tensor:
    """Sum anti-diagonals of the trailing [n, m] axes -> [..., n+m-1]."""
    n, m = prod.shape[-2], prod.shape[-1]
    padded = tnf.pad(prod, (0, n))                       # [..., n, m+n]
    flat = padded.reshape(*prod.shape[:-2], n * (m + n))
    flat = flat[..., : n * (n + m - 1)]
    return flat.reshape(*prod.shape[:-2], n, n + m - 1).sum(dim=-2)


def mul_cols(a: LB, b: LB) -> LB:
    """Exact product of two limb vectors -> column vector of length n+m.

    Both inputs must have limbs <= 0xFFFF (checked statically).  Columns
    follow the uint32 design's lo/hi split (bound min(n, m) * 2 * 0xFFFF)
    so the carry-save form equals the JAX version's."""
    assert a.bound <= MASK16 and b.bound <= MASK16, (
        f"mul_cols requires 16-bit-normalized inputs, got bounds "
        f"{hex(a.bound)}, {hex(b.bound)}")
    n, m = a.v.shape[-1], b.v.shape[-1]
    prod = a.v[..., :, None] * b.v[..., None, :]
    lo_c = _diag_colsum(prod & MASK16)
    hi_c = _diag_colsum(prod >> LIMB_BITS)
    cols = tnf.pad(lo_c, (0, 1)) + tnf.pad(hi_c, (1, 0))
    return LB(cols, 2 * min(n, m) * MASK16)


def sqr_cols(a: LB) -> LB:
    return mul_cols(a, a)


def add_lb(a: LB, b: LB) -> LB:
    """Column-wise add; pads the shorter operand with zero columns."""
    na, nb = a.v.shape[-1], b.v.shape[-1]
    av, bv = a.v, b.v
    if na < nb:
        av = tnf.pad(av, (0, nb - na))
    elif nb < na:
        bv = tnf.pad(bv, (0, na - nb))
    bound = a.bound + b.bound
    assert bound <= U32_MAX, "column overflow: normalize before adding"
    return LB(av + bv, bound)


def shift_cols(a: LB, k: int) -> LB:
    """Multiply by 2^(16k) by prepending k zero columns."""
    if k == 0:
        return a
    return LB(tnf.pad(a.v, (k, 0)), a.bound)


def _ripple(v: torch.Tensor, carry_in=None):
    """Exact sequential carry propagation over the last axis.
    Returns (limbs <= 0xFFFF, carry_out)."""
    outs = []
    c = torch.zeros(v.shape[:-1], dtype=DTYPE, device=v.device) \
        if carry_in is None else carry_in
    for i in range(v.shape[-1]):
        t = v[..., i] + c
        outs.append(t & MASK16)
        c = t >> LIMB_BITS
    return torch.stack(outs, dim=-1), c


def _shift_up(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[i] -> x[i-k] along the last axis, zero-filled (weight *2^(16k))."""
    return tnf.pad(x[..., :-k], (k, 0))


def _ks_carry(v: torch.Tensor):
    """Kogge-Stone carry propagation: exact, log-depth, limb-parallel.
    Requires per-limb bound <= 0x1FFFF (so every carry is 0/1).
    Returns (limbs <= 0xFFFF, carry_out in {0,1})."""
    g = (v >> LIMB_BITS) != 0
    p = (v & MASK16) == MASK16
    k = v.shape[-1]
    sh = 1
    while sh < k:
        gs = _shift_up(g, sh)
        ps = _shift_up(p, sh)
        g = g | (p & gs)
        p = p & ps
        sh *= 2
    c_in = _shift_up(g, 1).to(DTYPE)
    out = (v + c_in) & MASK16
    return out, g[..., -1].to(DTYPE)


# ---------------------------------------------------------------------------
# Modulus engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mod:
    """Arithmetic mod ``modulus`` (2^255 < modulus < 2^256) on 16x16-bit-limb
    batched integers.  Reduction uses 2^256 === red (mod modulus) with
    ``red = 2^256 - modulus``."""

    modulus: int
    name: str = "mod"

    def __post_init__(self):
        assert 2 ** 255 < self.modulus < 2 ** 256
        red = (1 << 256) - self.modulus
        red_limbs = []
        x = red
        while x:
            red_limbs.append(x & MASK16)
            x >>= LIMB_BITS
        object.__setattr__(self, "_red_limbs", tuple(red_limbs))
        object.__setattr__(self, "_mod_limbs",
                           tuple(int_to_limbs(self.modulus)))
        object.__setattr__(self, "_min_mod_limb", min(self._mod_limbs))

    # -- constants ---------------------------------------------------------
    @property
    def red_len(self) -> int:
        return len(self._red_limbs)

    def _red_lb(self, like: torch.Tensor) -> LB:
        return LB(_const(self._red_limbs, like), MASK16)

    def _red16(self, like: torch.Tensor) -> torch.Tensor:
        return _const(self._red_limbs + (0,) * (LIMBS - self.red_len), like)

    def zero(self, batch_shape=(), device="cpu") -> LB:
        return LB(torch.zeros((*batch_shape, LIMBS), dtype=DTYPE,
                              device=device), 0)

    def one(self, batch_shape=(), device="cpu") -> LB:
        v = torch.zeros((*batch_shape, LIMBS), dtype=DTYPE, device=device)
        v[..., 0] = 1
        return LB(v, MASK16)

    def const(self, x: int, device="cpu") -> LB:
        return lb_from_int(x % self.modulus, device=device)

    # -- reduction ---------------------------------------------------------
    def fold(self, a: LB) -> LB:
        """Fold columns >= 16 back using 2^256 === red.  Output: 16 columns."""
        cols = a
        while cols.v.shape[-1] > LIMBS:
            lo = LB(cols.v[..., :LIMBS], cols.bound)
            hi_v = cols.v[..., LIMBS:]
            h0 = LB(hi_v & MASK16, min(cols.bound, MASK16))
            h1 = LB(hi_v >> LIMB_BITS, cols.bound >> LIMB_BITS)
            c0 = mul_cols(h0, self._red_lb(hi_v))
            cols = add_lb(lo, c0)
            if h1.bound > 0:
                c1 = mul_cols(h1, self._red_lb(hi_v))
                cols = add_lb(cols, shift_cols(c1, 1))
        return cols

    def norm_weak(self, a: LB) -> LB:
        """Bring to 16 limbs, each <= 0xFFFF (value < 2^256, may be >= mod)."""
        if a.bound <= MASK16 and a.v.shape[-1] == LIMBS:
            return a
        cols = self.fold(a)
        v, bound = cols.v, cols.bound
        lo = v & MASK16
        c = v >> LIMB_BITS
        v = lo + tnf.pad(c[..., :-1], (1, 0))
        ov = c[..., -1]
        ov_bound = bound >> LIMB_BITS
        v, c1 = _ks_carry(v)
        ov = ov + c1
        ov_bound += 1
        assert ov_bound <= MASK16, "overflow accumulator exceeded 16 bits"
        f = mul_cols(LB(ov[..., None], ov_bound), self._red_lb(v))
        assert f.v.shape[-1] <= LIMBS and f.bound <= 2 * MASK16
        fv = tnf.pad(f.v, (0, LIMBS - f.v.shape[-1]))
        v, c2a = _ks_carry(v + (fv & MASK16))
        v, c2b = _ks_carry(v + _shift_up(fv >> LIMB_BITS, 1))
        c2 = c2a + c2b
        v, _c3 = _ks_carry(v + c2[..., None] * self._red16(v))
        return LB(v, MASK16)

    def normalize(self, a: LB) -> LB:
        """Canonical representative in [0, modulus). Limbs <= 0xFFFF."""
        x = self.norm_weak(a)
        t, c = _ks_carry(x.v + self._red16(x.v))
        ge = (c > 0)[..., None]
        return LB(torch.where(ge, t, x.v), MASK16)

    # -- ring ops ----------------------------------------------------------
    def add(self, a: LB, b: LB) -> LB:
        return add_lb(a, b)

    def neg(self, a: LB) -> LB:
        """k*modulus - a for the smallest safe k."""
        assert a.v.shape[-1] == LIMBS, "negate expects 16-limb (folded) input"
        k = a.bound // self._min_mod_limb + 1
        kk = [k * limb for limb in self._mod_limbs]
        assert max(kk) <= U32_MAX, "negate overflow; normalize first"
        return LB(_const(kk, a.v) - a.v, max(kk))

    def sub(self, a: LB, b: LB) -> LB:
        return add_lb(a, self.neg(b))

    def mul(self, a: LB, b: LB) -> LB:
        a = self.norm_if_needed(a)
        b = self.norm_if_needed(b)
        return self.norm_weak(mul_cols(a, b))

    def sqr(self, a: LB) -> LB:
        a = self.norm_if_needed(a)
        return self.norm_weak(sqr_cols(a))

    def mul_int(self, a: LB, k: int) -> LB:
        assert a.bound * k <= U32_MAX
        return LB(a.v * k, a.bound * k)

    def norm_if_needed(self, a: LB) -> LB:
        if a.bound <= MASK16 and a.v.shape[-1] == LIMBS:
            return a
        return self.norm_weak(a)

    def half(self, a: LB) -> LB:
        """a/2 mod m (m odd): (a + m*(a&1)) >> 1, exact."""
        a = self.norm_if_needed(a)
        odd = a.v[..., 0] & 1
        t = a.v + _const(self._mod_limbs, a.v) * odd[..., None]
        t, c = _ks_carry(t)
        hi_in = torch.cat([t[..., 1:], c[..., None]], dim=-1)
        return LB((t >> 1) | ((hi_in & 1) << (LIMB_BITS - 1)), MASK16)

    # -- comparisons -------------------------------------------------------
    def is_zero_weak(self, a: LB):
        """Zero test for a weak-normalized value: all-0 or exactly the
        modulus (value < 2^256 < 2*modulus)."""
        assert a.bound <= MASK16 and a.v.shape[-1] == LIMBS
        return ((a.v == 0).all(dim=-1)
                | (a.v == _const(self._mod_limbs, a.v)).all(dim=-1))

    def is_zero(self, a: LB):
        return self.is_zero_weak(self.norm_if_needed(a))

    def eq(self, a: LB, b: LB):
        """a === b (mod m), via one subtraction + the weak zero test."""
        return self.is_zero_weak(
            self.norm_weak(self.sub(self.norm_if_needed(a),
                                    self.norm_if_needed(b))))

    def is_odd(self, a: LB):
        return (self.normalize(a).v[..., 0] & 1) == 1

    # -- selection ---------------------------------------------------------
    @staticmethod
    def select(mask, a: LB, b: LB) -> LB:
        """mask ? a : b  (mask: [...] bool). Bounds merge statically."""
        assert a.v.shape[-1] == b.v.shape[-1]
        return LB(torch.where(mask[..., None], a.v, b.v),
                  max(a.bound, b.bound))

    # -- exponentiation ----------------------------------------------------
    def pow_const(self, x: LB, e: int) -> LB:
        """x^e for a Python-int exponent by 4-bit fixed windows, MSB first:
        a table x^0..x^15, then per window 4 squarings and one multiply by
        the table entry (x^0 = 1 for a zero digit) — the uniform dataflow
        of the JAX version, its ``lax.scan`` a Python loop here.  Weak
        result (limbs <= 0xFFFF, value < 2^256); 0^e = 0 for e > 0."""
        assert e >= 0
        if e == 0:
            return self.one(x.batch_shape, x.device)
        x = self.norm_if_needed(x)
        table = [self.one(x.batch_shape, x.device), x]
        for _ in range(14):
            table.append(self.mul(table[-1], x))
        ndig = (e.bit_length() + 3) // 4
        digits = [(e >> (4 * i)) & 15 for i in reversed(range(ndig))]
        acc = table[digits[0]]
        for d in digits[1:]:
            for _ in range(4):
                acc = self.sqr(acc)
            acc = self.mul(acc, table[d])
        return acc

    def inv(self, x: LB) -> LB:
        """x^-1 by Fermat, x^(m-2); inv(0) = 0.  Weak result."""
        return self.pow_const(x, self.modulus - 2)

    # -- bytes -------------------------------------------------------------
    def from_bytes_be(self, b: torch.Tensor):
        """[..., 32] uint8 big-endian -> (LB canonical, overflow mask).

        overflow is True where the 256-bit value was >= modulus."""
        b = b.to(DTYPE)
        limbs_be = (b[..., 0:32:2] << 8) | b[..., 1:32:2]
        v = limbs_be.flip(-1)
        t, c = _ks_carry(v + self._red16(v))
        overflow = c > 0
        return LB(torch.where(overflow[..., None], t, v), MASK16), overflow

    @staticmethod
    def to_bytes_be(a: LB, mod: "Mod") -> torch.Tensor:
        x = mod.normalize(a).v
        le = x.flip(-1)
        hi = (le >> 8).to(torch.uint8)
        lo = (le & 0xFF).to(torch.uint8)
        return torch.stack([hi, lo], dim=-1).reshape(*x.shape[:-1], 32)

    def get_bits(self, a: LB, offset: int, count: int):
        """Static-offset bit extraction from a canonical value; count <= 16."""
        assert a.bound <= MASK16
        limb, sh = divmod(offset, LIMB_BITS)
        lo = a.v[..., limb] >> sh
        if sh + count > LIMB_BITS and limb + 1 < LIMBS:
            lo = lo | (a.v[..., limb + 1] << (LIMB_BITS - sh))
        return lo & ((1 << count) - 1)
