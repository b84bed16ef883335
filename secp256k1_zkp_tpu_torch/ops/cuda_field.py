"""GF(p) limb arithmetic of the kernel library: plain PyTorch versions and
the ``mulmod_chain``, ``lift_x``, ``schnorr_check`` and ``affine_meta``
kernels.

Counterpart of the JAX package's ``ops/pallas_field.py`` (``_mul_limbs``,
``_sqr_limbs``, ``_reduce_cols``, ``_canon_p``, ``mulmod_chain``,
``lift_x_tpu``, ``schnorr_check_tpu``, ``affine_meta_tpu``).  A 256-bit
element is **limb-major**: ``[16, B]`` base-2^16 limbs with the batch
innermost, the layout of every kernel operand.  Kernel operands and
results are ``int32`` (the bits of the reference's ``uint32``); the plain
versions compute in ``int64``.

The plain versions are value-exact, not carry-save-exact: with 64-bit
integers a column sum needs no lo/hi split, so a *weak* result (limbs
<= 0xFFFF, value < 2^256) may be the other representative of its residue
class than the JAX helper returns.  Everything that leaves a kernel
wrapper is therefore canonical (``canon_p``), and comparisons with the JAX
helpers canonicalise both sides.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from . import _build
from .cuda_divsteps import inv_limbs16

LIMBS = 16
MASK16 = 0xFFFF
P_PRIME = 2 ** 256 - 2 ** 32 - 977
_RED_LO = 977               # 2^256 === 2^32 + 977 (mod p)
I64 = torch.int64


def limbs16(x: int, k: int = LIMBS) -> tuple[int, ...]:
    return tuple((x >> (16 * i)) & MASK16 for i in range(k))


def const_rows(x: int, like: torch.Tensor, k: int = LIMBS) -> torch.Tensor:
    """Python int -> ``[k, 1]`` int64 limb column on ``like``'s device."""
    return torch.tensor(limbs16(x, k), dtype=I64,
                        device=like.device)[:, None]


@lru_cache(maxsize=16)
def _col_index(n: int, m: int, device: str) -> torch.Tensor:
    return torch.tensor([i + j for i in range(n) for j in range(m)],
                        dtype=I64, device=device)


def mul_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact schoolbook product ``[n, B] x [m, B] -> [n+m-1, B]`` column
    sums (limbs <= 0xFFFF in; columns < min(n, m) * 2^32 out)."""
    n, m = a.shape[0], b.shape[0]
    lanes = max(a.shape[1], b.shape[1])
    prod = (a[:, None, :] * b[None, :, :]).reshape(n * m, -1)
    prod = prod.expand(n * m, lanes)
    cols = torch.zeros((n + m - 1, lanes), dtype=I64, device=a.device)
    return cols.index_add_(0, _col_index(n, m, str(a.device)), prod)


def ripple(x: torch.Tensor):
    """Exact carry ripple over the rows of ``[K, B]`` non-negative columns.
    Returns (``[K, B]`` limbs <= 0xFFFF, carry_out ``[B]``)."""
    out = []
    carry = None
    for row in x.unbind(0):
        t = row if carry is None else row + carry
        out.append(t & MASK16)
        carry = t >> 16
    return torch.stack(out, 0), carry


def weak_p(x: torch.Tensor) -> torch.Tensor:
    """``[16, B]`` non-negative limbs (each < 2^47) -> weak form mod p:
    limbs <= 0xFFFF, value < 2^256, same residue."""
    out, carry = ripple(x)
    # carry * 2^256 === carry * (2^32 + 977)
    fold = torch.zeros_like(out)
    fold[0] = carry * _RED_LO
    fold[2] = carry
    out, carry = ripple(out + fold)
    # second carry-out is 0/1; if 1 the rest is tiny, so one more fold and
    # a short ripple finish exactly
    fold = torch.zeros_like(out)
    fold[0] = carry * _RED_LO
    fold[2] = carry
    out, _ = ripple(out + fold)
    return out


def reduce_cols(cols: torch.Tensor) -> torch.Tensor:
    """Fold 31 or 32 product columns mod p and carry-normalise to 16 weak
    limbs (2^256 === 2^32 + 977)."""
    nh = cols.shape[0] - LIMBS
    hi = cols[LIMBS:]
    acc = torch.zeros((LIMBS + 2, cols.shape[1]), dtype=I64,
                      device=cols.device)
    acc[:LIMBS] = cols[:LIMBS]
    acc[:nh] += hi * _RED_LO
    acc[2:2 + nh] += hi
    for k in (LIMBS + 1, LIMBS):        # feedback columns 17, 16
        c = acc[k]
        acc[k - 16] += c * _RED_LO
        acc[k - 14] += c
    return weak_p(acc[:LIMBS])


def mul_limbs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p on weak ``[16, B]`` int64 limbs -> weak ``[16, B]``."""
    return reduce_cols(mul_cols(a, b))


def sqr_limbs(a: torch.Tensor) -> torch.Tensor:
    """a^2 mod p.  The dense outer product is one tensor op, so symmetry
    buys nothing here (the CUDA kernel does exploit it)."""
    return reduce_cols(mul_cols(a, a))


def canon_p(a: torch.Tensor) -> torch.Tensor:
    """Weak limbs -> canonical mod p: x >= p  <=>  x + (2^256 - p) carries
    out; one conditional subtract suffices because x < 2^256 < 2p."""
    t, carry = ripple(a + const_rows((1 << 256) - P_PRIME, a))
    return torch.where((carry > 0)[None, :], t, a)


# ---------------------------------------------------------------------------
# mulmod_chain: x * y^n mod p — the unit test of the device library.
# ---------------------------------------------------------------------------


def mulmod_chain_ref(x: torch.Tensor, y: torch.Tensor, n: int = 1):
    """Plain version of :func:`mulmod_chain` (any device)."""
    xv, yv = x.to(I64), y.to(I64)
    for _ in range(n):
        xv = mul_limbs(xv, yv)
    return canon_p(xv).to(torch.int32)


def mulmod_chain(x: torch.Tensor, y: torch.Tensor, n: int = 1):
    """x * y^n mod p on ``[16, B]`` int32 limb-major tensors (limbs
    <= 0xFFFF); returns the canonical result, ``[16, B]`` int32.

    CUDA tensors go through the hand-written kernel
    (``csrc/mulmod_chain.cu``); CPU tensors through the plain version."""
    if not x.is_cuda:
        return mulmod_chain_ref(x, y, n)
    lanes = _build.check_rows(x, LIMBS, "mulmod_chain x")
    _build.check_rows(y, LIMBS, "mulmod_chain y", lanes)
    out = torch.empty_like(x)
    lib = _build.lib()
    _build.count_launch("mulmod_chain")
    _build.check(lib.secp_mulmod_chain(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), lanes, int(n),
        _build.stream_ptr()), "mulmod_chain")
    return out


# ---------------------------------------------------------------------------
# BIP-340 lift_x and the Schnorr acceptance check
# ---------------------------------------------------------------------------


def _sqr_n(a: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        a = sqr_limbs(a)
    return a


def pow_sqrt(a: torch.Tensor) -> torch.Tensor:
    """a^((p+1)/4) on weak limbs (a square root of a wherever one exists),
    by the reference's fixed chain — the one of ``csrc/fe.cuh
    fe_pow_sqrt``: 253 squarings and 13 multiplies."""
    x2 = mul_limbs(sqr_limbs(a), a)
    x3 = mul_limbs(sqr_limbs(x2), a)
    x6 = mul_limbs(_sqr_n(x3, 3), x3)
    x9 = mul_limbs(_sqr_n(x6, 3), x3)
    x11 = mul_limbs(_sqr_n(x9, 2), x2)
    x22 = mul_limbs(_sqr_n(x11, 11), x11)
    x44 = mul_limbs(_sqr_n(x22, 22), x22)
    x88 = mul_limbs(_sqr_n(x44, 44), x44)
    x176 = mul_limbs(_sqr_n(x88, 88), x88)
    x220 = mul_limbs(_sqr_n(x176, 44), x44)
    x223 = mul_limbs(_sqr_n(x220, 3), x3)
    t = mul_limbs(_sqr_n(x223, 23), x22)
    t = mul_limbs(_sqr_n(t, 6), x2)
    return _sqr_n(t, 2)


def _neg_canon(y: torch.Tensor) -> torch.Tensor:
    """p - y for canonical y, canonical (y = 0 -> 0):
    (2^256 - 1 - y) + (p + 1) carries out exactly once."""
    t, _ = ripple((MASK16 - y) + const_rows(P_PRIME + 1, y))
    return canon_p(t)


def lift_x_ref(x: torch.Tensor):
    """Plain version of :func:`lift_x` (any device)."""
    x = x.to(I64)
    y2 = weak_p(mul_limbs(sqr_limbs(x), x) + const_rows(7, x))
    y = canon_p(pow_sqrt(y2))
    ok = (canon_p(sqr_limbs(y)) == canon_p(y2)).all(0)
    odd = (y[0] & 1) == 1
    y = torch.where(odd[None, :], _neg_canon(y), y)
    return y.to(torch.int32), ok


def lift_x(x: torch.Tensor):
    """BIP-340 lift_x on ``[16, B]`` int32 limb-major x (limbs <= 0xFFFF).

    Returns (y ``[16, B]`` int32, ok ``[B]`` bool): y is the canonical even
    one of the two roots of x^3 + 7, taken as (x^3 + 7)^((p+1)/4) and
    negated where odd; ok says y^2 == x^3 + 7.  Where ok is false, y is
    still that even-selected power (the caller masks the lane).

    CUDA tensors go through the hand-written kernel (``csrc/lift_x.cu``);
    CPU tensors through the plain version."""
    if not x.is_cuda:
        return lift_x_ref(x)
    lanes = _build.check_rows(x, LIMBS, "lift_x x")
    y = torch.empty_like(x)
    ok = torch.empty((lanes,), dtype=torch.int32, device=x.device)
    lib = _build.lib()
    _build.count_launch("lift_x")
    _build.check(lib.secp_lift_x(
        x.data_ptr(), y.data_ptr(), ok.data_ptr(), lanes,
        _build.stream_ptr()), "lift_x")
    return y, ok != 0


def schnorr_check_ref(x, y, z, inf, rx):
    """Plain version of :func:`schnorr_check` (any device)."""
    X, Y, Z, xr = (t.to(I64) for t in (x, y, z, rx))
    eq = (canon_p(mul_limbs(xr, sqr_limbs(Z))) == canon_p(X)).all(0)
    w = inv_limbs16(canon_p(Z), P_PRIME)          # inv(0) = 0
    yaff = canon_p(mul_limbs(Y, mul_limbs(sqr_limbs(w), w)))
    even = (yaff[0] & 1) == 0
    return eq & even & ~inf.to(torch.bool)


def schnorr_check(x, y, z, inf, rx):
    """BIP-340 acceptance of a jacobian R against r: not infinity,
    X == r * Z^2 and Y * Z^-3 even.

    x, y, z, rx: ``[16, B]`` int32 limb-major (limbs <= 0xFFFF, values
    < 2^256); inf: ``[B]`` bool.  Returns ``[B]`` bool.  CUDA tensors go
    through the hand-written kernel (``csrc/schnorr_check.cu``); CPU
    tensors through the plain version."""
    if not x.is_cuda:
        return schnorr_check_ref(x, y, z, inf, rx)
    lanes = _build.check_rows(x, LIMBS, "schnorr_check x")
    for name, t in (("y", y), ("z", z), ("rx", rx)):
        _build.check_rows(t, LIMBS, f"schnorr_check {name}", lanes)
    if not inf.is_cuda or inf.shape != (lanes,):
        raise ValueError("schnorr_check inf: expected a CUDA [B] mask")
    # inf32 dies with this call while the kernel may still run: safe, the
    # caching allocator reuses a block only in stream order
    inf32 = inf.to(torch.int32).contiguous()
    ok = torch.empty((lanes,), dtype=torch.int32, device=x.device)
    lib = _build.lib()
    _build.count_launch("schnorr_check")
    _build.check(lib.secp_schnorr_check(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), inf32.data_ptr(),
        rx.data_ptr(), ok.data_ptr(), lanes, _build.stream_ptr()),
        "schnorr_check")
    return ok != 0


# ---------------------------------------------------------------------------
# Jacobian -> affine, and the quadratic character of y (serialization)
# ---------------------------------------------------------------------------


# lanes a thread of the kernels on a batched inverse (K: one inverse per K
# lanes, csrc/affine.cuh, csrc/batch_inv.cuh), and the warps an SM the
# affine conversions' rule aims for (the sweep of chip_smoke.py, PERF.md)
LANE_GROUPS = (1, 2, 4, 8)
AFFINE_WARPS = 6


def lane_group(lanes: int, sms: int, warps: int) -> int:
    """Lanes a thread (K) of a kernel on a batched inverse: the most of
    ``LANE_GROUPS`` for which ceil(B / K) threads still fill ``warps``
    warps on each of the card's ``sms`` SMs; 1 while B threads do not.
    Thread t takes the lanes t, t + S, ... (S the thread count) and
    inverts their product once."""
    group = 1
    while (2 * group <= LANE_GROUPS[-1]
           and -(-lanes // (2 * group)) >= sms * 32 * warps):
        group *= 2
    return group


def affine_group(lanes: int, sms: int) -> int:
    """K of ``affine_xy`` / ``affine_meta``: :func:`lane_group` at
    ``AFFINE_WARPS``."""
    return lane_group(lanes, sms, AFFINE_WARPS)


def group_arg(name: str, lanes: int, device, warps: int,
              group: int | None) -> int:
    """A batched-inverse kernel's K: ``group``, or :func:`lane_group`'s at
    ``warps`` on ``device`` where it is None; raises below 1."""
    if group is None:
        group = lane_group(lanes, _build.sm_count(str(device)), warps)
    if group < 1:
        raise ValueError(f"{name}: expected group >= 1, got {group}")
    return group


def affine_operands(name: str, x, y, z, group: int | None):
    """Check an affine conversion's CUDA operands; returns (B, K), K
    :func:`affine_group`'s where ``group`` is None."""
    lanes = _build.check_rows(x, LIMBS, f"{name} x")
    _build.check_rows(y, LIMBS, f"{name} y", lanes)
    _build.check_rows(z, LIMBS, f"{name} z", lanes)
    return lanes, group_arg(name, lanes, x.device, AFFINE_WARPS, group)


@lru_cache(maxsize=8)
def _undecided(device: str) -> torch.Tensor:
    return torch.zeros((1,), dtype=torch.int32, device=device)


def jacobi_undecided(device, reset: bool = False) -> int:
    """Lanes of ``affine_meta`` launches on ``device`` whose Jacobi symbol
    was left undecided after its cap and took the square-root chain, since
    the last reset (``reset=True`` reads and zeroes the count)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    count = _undecided(str(device))
    n = int(count.item())
    if reset:
        count.zero_()
    return n


def affine_plain(x, y, z):
    """Jacobian -> canonical affine int64 limbs; z = 0 gives zeros."""
    X, Y, Z = (t.to(I64) for t in (x, y, z))
    zinv = inv_limbs16(canon_p(Z), P_PRIME)                # inv(0) = 0
    zi2 = sqr_limbs(zinv)
    zi3 = mul_limbs(zi2, zinv)
    return canon_p(mul_limbs(X, zi2)), canon_p(mul_limbs(Y, zi3))


def affine_meta_ref(x, y, z):
    """Plain version of :func:`affine_meta` (any device)."""
    xa, ya = affine_plain(x, y, z)
    Y, Z = y.to(I64), z.to(I64)
    t = canon_p(mul_limbs(Y, mul_limbs(sqr_limbs(Z), Z)))
    root = (canon_p(sqr_limbs(pow_sqrt(t))) == t).all(0)
    sq = root & ~(t == 0).all(0)
    return xa.to(torch.int32), ya.to(torch.int32), sq


def affine_meta(x, y, z, group: int | None = None):
    """Jacobian (x, y, z) ``[16, B]`` int32 limbs -> (x, y canonical affine
    ``[16, B]`` int32, sq ``[B]`` bool): sq says y is a nonzero square,
    the quadratic character of Y*Z^3.  Infinity lanes (z = 0, or the weak
    zero z = p) give zeros and sq false — false also where Y = 0, where
    ``field.is_square`` would say true (it counts 0 as a square).

    CUDA tensors go through the hand-written kernel
    (``csrc/affine_meta.cu``: ``group`` lanes a thread as in
    ``cuda_gen.affine_xy``, the character by a Jacobi symbol of the public
    affine y; lanes it leaves undecided are counted,
    :func:`jacobi_undecided`); CPU tensors through the plain version."""
    if not x.is_cuda:
        return affine_meta_ref(x, y, z)
    lanes, group = affine_operands("affine_meta", x, y, z, group)
    ax = torch.empty_like(x)
    ay = torch.empty_like(x)
    sq = torch.empty((lanes,), dtype=torch.int32, device=x.device)
    lib = _build.lib()
    _build.count_launch("affine_meta")
    _build.check(lib.secp_affine_meta(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), ax.data_ptr(),
        ay.data_ptr(), sq.data_ptr(), _undecided(str(x.device)).data_ptr(),
        lanes, group, _build.stream_ptr()), "affine_meta")
    return ax, ay, sq != 0
