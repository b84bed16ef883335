"""Complete group formulas of the kernel library and the GLV Strauss
kernel R = u1*G + u2*P with the fused ECDSA x(R) === r check.

Counterpart of the JAX package's ``ops/pallas_group.py``: ``FE`` with a
static limb bound, ``jp_double``, ``jp_add_aff``, ``jp_add``,
``add_aff_ratio`` as plain PyTorch on limb-major ``[16, B]`` int64 rows,
``affine_multiples`` (the true-affine d*P table build that ``ecmult_glv``
and the MSM engine share), the trees of complete adds that the kernels
run (``tree_sum``, ``block_sum_ref``), and three kernels: ``ecmult_glv``
beside ``ecmult_glv_ref``, ``gej_add`` beside ``gej_add_ref`` and
``gej_sum`` beside ``gej_sum_ref``.

The formulas are the reference's line for line, so every coordinate is the
same residue mod p as the JAX kernel's.  Weak representatives may differ
(see ``ops/cuda_field.py``), hence ``ecmult_glv`` returns **canonical**
x, y, z from both the kernel and the plain version.
"""

from __future__ import annotations

import dataclasses

import torch

from . import _build
from ..utils import hostcurve
from .cuda_divsteps import inv_limbs16
from .cuda_field import (I64, LIMBS, MASK16, P_PRIME, canon_p, const_rows,
                         limbs16, mul_limbs, ripple, sqr_limbs, weak_p)

_P_LIMBS = limbs16(P_PRIME)
_MIN_P_LIMB = min(_P_LIMBS)  # 0xFC2F
_BOUND_MAX = 0xFFFF0000      # the uint32 discipline of the reference design

_BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
_N_ORDER = hostcurve.N
NW = 26                      # signed 5-bit windows per 128-bit half-scalar
NT = 17                      # table entries 1..16 (index 0 unused)
GLV_RATIO_ROWS = 15 * 8      # ecmult_glv scratch rows: the 15 z-ratios


@dataclasses.dataclass
class FE:
    """Field element in kernel form: ``l`` is ``[16, B]`` int64 limbs, each
    in [0, bound]; ``bound`` is static (the magnitude discipline)."""

    l: torch.Tensor
    bound: int


def fe_weak(a: FE) -> FE:
    """Carry-normalise to limbs <= 0xFFFF (value may exceed p once)."""
    assert a.bound <= _BOUND_MAX, hex(a.bound)
    if a.bound <= MASK16:
        return a
    return FE(weak_p(a.l), MASK16)


def fe_mul(a: FE, b: FE) -> FE:
    return FE(mul_limbs(fe_weak(a).l, fe_weak(b).l), MASK16)


def fe_sqr(a: FE) -> FE:
    return FE(sqr_limbs(fe_weak(a).l), MASK16)


def fe_add(a: FE, b: FE) -> FE:
    bound = a.bound + b.bound
    assert bound < _BOUND_MAX
    return FE(a.l + b.l, bound)


def fe_mul_int(a: FE, k: int) -> FE:
    assert a.bound * k < _BOUND_MAX
    return FE(a.l * k, a.bound * k)


def fe_neg(a: FE) -> FE:
    """k*p - a for the smallest safe k."""
    k = a.bound // _MIN_P_LIMB + 1
    kp = [k * pl for pl in _P_LIMBS]
    assert max(kp) < _BOUND_MAX
    return FE(torch.tensor(kp, dtype=I64, device=a.l.device)[:, None] - a.l,
              max(kp))


def fe_sub(a: FE, b: FE) -> FE:
    return fe_add(a, fe_neg(b))


def fe_select(mask: torch.Tensor, a: FE, b: FE) -> FE:
    """mask ? a : b, per lane (mask: ``[B]`` bool)."""
    return FE(torch.where(mask[None, :], a.l, b.l), max(a.bound, b.bound))


def fe_half(a: FE) -> FE:
    """a/2 mod p: (a + p*(a&1)) >> 1, exact (the carry-out of the +p
    becomes the result's top bit)."""
    a = fe_weak(a)
    odd = a.l[0] & 1
    t, carry = ripple(a.l + const_rows(P_PRIME, a.l) * odd[None, :])
    up = torch.cat([t[1:], carry[None]], 0)
    return FE((t >> 1) | ((up & 1) << 15), MASK16)


def fe_is_zero(a: FE) -> torch.Tensor:
    """Zero test mod p (``[B]`` bool): canonicalise, then compare."""
    return (canon_p(fe_weak(a).l) == 0).all(0)


def fe_const(x: int, like: torch.Tensor) -> FE:
    """Python int -> FE broadcast over ``like``'s lanes."""
    return FE(const_rows(x, like).expand(LIMBS, like.shape[-1]), MASK16)


def fe_one(like: torch.Tensor) -> FE:
    return fe_const(1, like)


@dataclasses.dataclass
class JP:
    """Jacobian point in kernel form: FE coordinates + ``[B]`` bool inf."""

    x: FE
    y: FE
    z: FE
    inf: torch.Tensor


def jp_inf(like: torch.Tensor) -> JP:
    lanes = like.shape[-1]
    z = torch.zeros((LIMBS, lanes), dtype=I64, device=like.device)
    return JP(FE(z, MASK16), fe_one(like), fe_one(like),
              torch.ones(lanes, dtype=torch.bool, device=like.device))


def jp_double(a: JP) -> JP:
    """Jacobian doubling (the reference's gej_double: 2M + 5S)."""
    A = fe_sqr(a.x)
    B = fe_sqr(a.y)
    C = fe_sqr(B)
    t = fe_sqr(fe_add(fe_weak(a.x), B))
    D = fe_weak(fe_mul_int(fe_sub(fe_sub(t, A), C), 2))
    E = fe_mul_int(A, 3)
    Fq = fe_sqr(E)
    X3 = fe_weak(fe_sub(Fq, fe_mul_int(D, 2)))
    Y3 = fe_weak(fe_sub(fe_mul(E, fe_sub(D, X3)), fe_mul_int(C, 8)))
    Z3 = fe_mul(fe_mul_int(fe_weak(a.y), 2), a.z)
    return JP(X3, Y3, Z3, a.inf)


def _add_core(U1: FE, S1: FE, U2: FE, S2: FE, Zmul: FE):
    """Unified complete addition from the U/S pairs (Brier-Joye with the
    degenerate-case select, the 7M+5S shape of gej_add_ge).  Returns
    (X3, Y3, Z3, m_f): Z3 = Zmul * m_f."""
    T = fe_add(U1, U2)
    M = fe_add(S1, S2)
    rr = fe_sqr(T)
    m_alt = fe_neg(U2)
    tt = fe_mul(U1, m_alt)
    rr = fe_add(rr, tt)                      # R = T^2 - U1*U2
    deg = fe_is_zero(M)
    # If lambda = R/M degenerates (M == 0 but x1 != x2), the slope
    # (S1-S2)/(U1-U2) = 2*S1/(U1-U2) is used instead.
    rr_alt = fe_mul_int(S1, 2)
    m_alt = fe_add(m_alt, U1)                # U1 - U2
    rr_f = fe_select(deg, rr_alt, fe_weak(rr))
    m_f = fe_select(deg, fe_weak(m_alt), fe_weak(M))
    n = fe_sqr(m_f)
    q = fe_mul(fe_neg(T), n)                 # Q = -T*Malt^2
    n2 = fe_sqr(n)
    n_f = fe_select(deg, fe_weak(M), n2)     # M^3*Malt
    t2 = fe_sqr(rr_f)
    Z3 = fe_mul(Zmul, m_f)
    X3 = fe_add(t2, q)
    t3 = fe_add(fe_mul_int(X3, 2), q)
    t4 = fe_mul(t3, rr_f)
    Y3 = fe_half(fe_neg(fe_add(t4, n_f)))
    return fe_weak(X3), Y3, Z3, m_f


def _jp_add_core(U1, S1, U2, S2, Zmul, a: JP, bx: FE, by: FE, b_inf) -> JP:
    X3, Y3, Z3, _ = _add_core(U1, S1, U2, S2, Zmul)
    # Z3 == 0 covers a == -b and the y1 = -y2 completeness argument
    inf3 = fe_is_zero(Z3)
    one = fe_one(X3.l)
    ax, ay, az = fe_weak(a.x), fe_weak(a.y), fe_weak(a.z)
    X3 = fe_select(a.inf, bx, fe_select(b_inf, ax, X3))
    Y3 = fe_select(a.inf, by, fe_select(b_inf, ay, Y3))
    Z3 = fe_select(a.inf, one, fe_select(b_inf, az, fe_weak(Z3)))
    inf = torch.where(a.inf, b_inf, torch.where(b_inf, a.inf, inf3))
    return JP(X3, Y3, Z3, inf)


def jp_add_aff(a: JP, bx: FE, by: FE, b_inf: torch.Tensor) -> JP:
    """Complete mixed addition a + (bx, by) affine."""
    ZZ = fe_sqr(a.z)
    U1 = fe_weak(a.x)
    U2 = fe_mul(bx, ZZ)
    S1 = fe_weak(a.y)
    S2 = fe_mul(fe_mul(by, ZZ), a.z)
    return _jp_add_core(U1, S1, U2, S2, a.z, a, fe_weak(bx), fe_weak(by),
                        b_inf)


def jp_add(a: JP, b: JP) -> JP:
    """Complete general addition (jacobian + jacobian)."""
    Z11 = fe_sqr(a.z)
    Z22 = fe_sqr(b.z)
    U1 = fe_mul(a.x, Z22)
    U2 = fe_mul(b.x, Z11)
    S1 = fe_mul(fe_mul(a.y, Z22), b.z)
    S2 = fe_mul(fe_mul(b.y, Z11), a.z)
    Zc = fe_mul(a.z, b.z)
    out = _jp_add_core(U1, S1, U2, S2, Zc, a, fe_weak(b.x), fe_weak(b.y),
                       b.inf)
    Z3 = fe_select(a.inf, fe_weak(b.z), out.z)
    return JP(out.x, out.y, Z3, out.inf)


def add_aff_ratio(ax: FE, ay: FE, az: FE, bx: FE, by: FE):
    """Complete mixed add for the table build (inputs never infinity);
    returns (X3, Y3, Z3, m) where Z3 = az*m — m is the z-ratio the
    global-Z pass needs."""
    ZZ = fe_sqr(az)
    U1 = fe_weak(ax)
    U2 = fe_mul(bx, ZZ)
    S1 = fe_weak(ay)
    S2 = fe_mul(fe_mul(by, ZZ), az)
    return _add_core(U1, S1, U2, S2, az)


def _gather16(xs, ys, d: torch.Tensor):
    """Select table entry d (1..16) by a full scan; d == 0 is masked by
    the caller."""
    gx, gy = xs[1], ys[1]
    for e in range(2, NT):
        m = d == e
        gx = fe_select(m, xs[e], gx)
        gy = fe_select(m, ys[e], gy)
    return gx, gy


def _rows_fe(t: torch.Tensor) -> FE:
    return FE(t.to(I64), MASK16)


def _canon32(a: FE) -> torch.Tensor:
    return canon_p(fe_weak(a).l).to(torch.int32)


def affine_multiples(px: FE, py: FE, count: int):
    """d*P for d = 1..``count`` as TRUE-affine weak FE lists (index 0
    unused): a jacobian chain with z-ratio tracking (one doubling, mixed
    adds), one inverse of the last Z and the backward global-Z pass.  P
    must be a finite point (callers substitute G for infinity)."""
    like = px.l[0]
    X = [None] * (count + 1)
    Y = [None] * (count + 1)
    R = [None] * (count + 1)                 # z_d = z_{d-1} * R[d]
    X[1], Y[1] = px, py
    d2 = jp_double(JP(px, py, fe_one(like),
                      torch.zeros_like(like, dtype=torch.bool)))
    X[2], Y[2], pz = d2.x, d2.y, d2.z
    R[2] = pz
    for d in range(3, count + 1):
        X[d], Y[d], pz, R[d] = add_aff_ratio(X[d - 1], Y[d - 1], pz, px, py)
    zi = FE(inv_limbs16(canon_p(fe_weak(pz).l), P_PRIME), MASK16)
    zi2 = fe_sqr(zi)
    zi3 = fe_mul(zi2, zi)
    axs = [None] * (count + 1)
    ays = [None] * (count + 1)
    axs[count] = fe_mul(X[count], zi2)
    ays[count] = fe_mul(Y[count], zi3)
    acc = None
    for d in range(count - 1, 0, -1):
        acc = R[d + 1] if acc is None else fe_mul(acc, R[d + 1])
        a2c = fe_sqr(acc)
        axs[d] = fe_mul(fe_mul(X[d], a2c), zi2)
        ays[d] = fe_mul(fe_mul(Y[d], fe_mul(a2c, acc)), zi3)
    return axs, ays


def ecmult_glv_ref(digs, flags, px, py, pinf, gjac, rx=None):
    """Plain version of :func:`ecmult_glv` (any device)."""
    digs = digs.to(I64)
    neg1 = flags[0] != 0
    neg2 = flags[1] != 0
    pinf = pinf.to(torch.bool)
    like = digs[0]

    # infinity lanes: substitute G so the table build stays on the curve;
    # their P-stream adds are masked off below
    px_f = fe_select(pinf, fe_const(hostcurve.GX, like), _rows_fe(px))
    py_f = fe_select(pinf, fe_const(hostcurve.GY, like), _rows_fe(py))
    # fold the a1 sign into the table's y; the a2 stream re-flips when the
    # two half-scalar signs differ
    pyc = fe_weak(fe_select(neg1, fe_neg(py_f), py_f))
    flip = neg1 ^ neg2

    axs, ays = affine_multiples(px_f, pyc, NT - 1)
    # lambda*P' table: beta * x
    beta = fe_const(_BETA, like)
    bxs = [None] + [fe_mul(axs[d], beta) for d in range(1, NT)]

    accp = jp_inf(like)
    for w in range(NW):
        for _ in range(5):
            accp = jp_double(accp)
        for tab_x, row, sflip in ((axs, digs[w], None),
                                  (bxs, digs[NW + w], flip)):
            mag, sgn = row & 0xFF, (row >> 8) != 0
            if sflip is not None:
                sgn = sgn ^ sflip
            gx, gy = _gather16(tab_x, ays, mag)
            gy = fe_select(sgn, fe_weak(fe_neg(gy)), gy)
            accp = jp_add_aff(accp, gx, gy, (mag == 0) | pinf)

    # u1*G from the comb kernel (z == 0 marks infinity): one complete add
    gxf, gyf, gzf = (_rows_fe(t) for t in gjac)
    accp = jp_add(accp, JP(gxf, gyf, gzf, fe_is_zero(gzf)))
    oz = fe_weak(accp.z)

    if rx is not None:
        # x(R) === r (mod n) without an inverse: X == r*Z^2, or
        # X == (r+n)*Z^2 when r < p - n
        xr = _rows_fe(rx)
        zz2 = fe_sqr(oz)
        eq1 = fe_is_zero(fe_sub(fe_mul(xr, zz2), accp.x))
        _, c = ripple(xr.l + const_rows(
            (1 << 256) - (P_PRIME - _N_ORDER), like))
        lt = c == 0
        xr2 = fe_weak(fe_add(xr, fe_const(_N_ORDER, like)))
        eq2 = fe_is_zero(fe_sub(fe_mul(xr2, zz2), accp.x))
        ok = (eq1 | (eq2 & lt)) & ~accp.inf
    else:
        ok = torch.zeros_like(accp.inf)
    i32 = torch.int32
    return (canon_p(fe_weak(accp.x).l).to(i32),
            canon_p(fe_weak(accp.y).l).to(i32),
            canon_p(oz.l).to(i32), accp.inf, ok)


def ecmult_glv(digs, flags, px, py, pinf, gjac, rx=None):
    """GLV double-scalar mult R = u1*G + u2*P from the prep digit streams.

    digs: ``[52, B]`` int32 signed-w5 MSB-first rows (``mag | sign<<8``):
    0-25 a1, 26-51 a2; flags: ``[2, B]`` (neg1, neg2) with
    u2 = (-1)^neg1*a1 + lambda*(-1)^neg2*a2 (mod n); px/py: ``[16, B]``
    int32 canonical limbs; pinf: ``[B]`` bool; gjac: (gx, gy, gz)
    ``[16, B]`` jacobian u1*G from ``cuda_gen.fixedbase_digits`` (z == 0
    -> infinity); rx: ``[16, B]`` canonical r limbs to enable the fused
    ECDSA x(R) === r check.

    Returns (x, y, z ``[16, B]`` int32 **canonical**, inf ``[B]`` bool,
    ok ``[B]`` bool).  CUDA tensors go through the hand-written kernel
    (``csrc/ecmult_glv.cu``); CPU tensors through the plain version."""
    if not px.is_cuda:
        return ecmult_glv_ref(digs, flags, px, py, pinf, gjac, rx)
    lanes = _build.check_rows(px, LIMBS, "ecmult_glv px")
    _build.check_rows(py, LIMBS, "ecmult_glv py", lanes)
    _build.check_rows(digs, 2 * NW, "ecmult_glv digs", lanes)
    _build.check_rows(flags, 2, "ecmult_glv flags", lanes)
    gx, gy, gz = gjac
    for name, t in (("gx", gx), ("gy", gy), ("gz", gz)):
        _build.check_rows(t, LIMBS, f"ecmult_glv {name}", lanes)
    if not pinf.is_cuda or pinf.shape != (lanes,):
        raise ValueError("ecmult_glv pinf: expected a CUDA [B] mask")
    check = rx is not None
    if check:
        _build.check_rows(rx, LIMBS, "ecmult_glv rx", lanes)
    else:
        rx = px                              # never read by the kernel
    i32 = torch.int32
    # misc and scratch die with this call while the kernel may still run:
    # safe, the caching allocator reuses a block only in stream order
    misc = torch.cat([pinf.to(i32)[None, :], flags], 0).contiguous()
    ox = torch.empty((LIMBS, lanes), dtype=i32, device=px.device)
    oy = torch.empty_like(ox)
    oz = torch.empty_like(ox)
    oinf = torch.empty((lanes,), dtype=i32, device=px.device)
    ok = torch.empty_like(oinf)
    scratch = torch.empty((GLV_RATIO_ROWS, lanes), dtype=i32,
                          device=px.device)
    lib = _build.lib()
    _build.count_launch("ecmult_glv")
    _build.check(lib.secp_ecmult_glv(
        digs.data_ptr(), px.data_ptr(), py.data_ptr(), misc.data_ptr(),
        rx.data_ptr(), gx.data_ptr(), gy.data_ptr(), gz.data_ptr(),
        ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), oinf.data_ptr(),
        ok.data_ptr(), lanes, int(check), scratch.data_ptr(),
        _build.stream_ptr()), "ecmult_glv")
    return ox, oy, oz, oinf != 0, ok != 0


# ---------------------------------------------------------------------------
# gej_add: the batched complete jacobian add (the generator's two adds and
# batch verify's rhs add); gej_sum: the sum of a batch of points (the
# Pedersen tally), and the trees of complete adds the kernels share.
# ---------------------------------------------------------------------------

SUM_THREADS = 256         # gej_sum's threads a block (csrc/gej_add.cu)
WARP = 32


def jp_pad(p: JP, lanes: int) -> JP:
    """``p`` with infinity lanes (0, 1, 1, as the kernels' jp_infinity)
    appended up to ``lanes``."""
    extra = lanes - p.inf.shape[0]
    if extra <= 0:
        return p
    q = jp_inf(p.inf.new_empty((extra,)))

    def cat(a: FE, b: FE) -> FE:
        return FE(torch.cat([a.l, b.l], 1), max(a.bound, b.bound))

    return JP(cat(p.x, q.x), cat(p.y, q.y), cat(p.z, q.z),
              torch.cat([p.inf, q.inf]))


def tree_sum(p: JP, width: int) -> JP:
    """Sum each run of ``width`` consecutive lanes (a power of two) by
    halving levels of complete adds -> one lane per run: at each level
    lane t of a run adds lane t + width / 2, as the kernels' shuffle trees
    (``jp_warp_sum``, ``csrc/group.cuh``) leave the run's first thread."""
    while width > 1:
        h = width // 2

        def half(t, lo):
            v = t.reshape(*t.shape[:-1], -1, width)[..., lo:lo + h]
            return v.reshape(*t.shape[:-1], -1)

        a = JP(*(FE(half(c.l, 0), c.bound) for c in (p.x, p.y, p.z)),
               half(p.inf, 0))
        b = JP(*(FE(half(c.l, h), c.bound) for c in (p.x, p.y, p.z)),
               half(p.inf, h))
        p = jp_add(a, b)
        width = h
    return p


def _pow2_ceil(n: int) -> int:
    return 1 << (n - 1).bit_length()


def block_sum_ref(p: JP) -> JP:
    """The sum of all n lanes of ``p`` in the order of ``jp_block_sum``
    (``csrc/group.cuh``) with lane t as thread t: each warp's tree over
    pow2_ceil(min(n, 32)) threads, then one over the warps' sums."""
    n = p.inf.shape[0]
    if n <= WARP:
        return tree_sum(jp_pad(p, _pow2_ceil(n)), _pow2_ceil(n))
    warps = -(-n // WARP)
    s = tree_sum(jp_pad(p, warps * WARP), WARP)
    return tree_sum(jp_pad(s, _pow2_ceil(warps)), _pow2_ceil(warps))


def sum_blocks(lanes: int, sms: int) -> int:
    """Blocks of :func:`gej_sum`'s launch: one an SM at most, and no
    block without a lane of its own."""
    return max(1, min(-(-lanes // SUM_THREADS), sms))


def gej_sum_ref(x, y, z, inf):
    """Plain version of :func:`gej_sum` (any device): the lanes, padded
    with infinity to a power of two, summed by halving levels of complete
    adds.  Another order of additions than the kernel's, so the two agree
    as points."""
    p = _jp_rows((x, y, z, inf))
    width = _pow2_ceil(p.inf.shape[0])
    out = tree_sum(jp_pad(p, width), width)
    return _canon32(out.x), _canon32(out.y), _canon32(out.z), out.inf


def gej_sum(x, y, z, inf):
    """The sum of B >= 1 jacobian points (x, y, z ``[16, B]`` int32
    limbs, inf ``[B]`` bool; any B, infinite lanes allowed) as one point.

    Returns (x, y, z ``[16, 1]`` int32 canonical, inf ``[1]`` bool).  CUDA
    tensors go through the hand-written kernel (``csrc/gej_add.cu``: one
    launch for any B; its blocks' sums meet in the last block to finish),
    CPU tensors through the plain version."""
    if not x.is_cuda:
        return gej_sum_ref(x, y, z, inf)
    lanes = _build.check_rows(x, LIMBS, "gej_sum x")
    _build.check_rows(y, LIMBS, "gej_sum y", lanes)
    _build.check_rows(z, LIMBS, "gej_sum z", lanes)
    if not inf.is_cuda or inf.shape != (lanes,):
        raise ValueError("gej_sum inf: expected a CUDA [B] mask")
    i32 = torch.int32
    inf32 = inf.to(i32).contiguous()
    blocks = sum_blocks(lanes, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    # the blocks' sums and the counter: dies with this call while the
    # kernel may still run, safe in stream order
    part = torch.empty((49 * blocks + 1,), dtype=i32, device=x.device)
    ox = torch.empty((LIMBS, 1), dtype=i32, device=x.device)
    oy = torch.empty_like(ox)
    oz = torch.empty_like(ox)
    oinf = torch.empty((1,), dtype=i32, device=x.device)
    lib = _build.lib()
    _build.count_launch("gej_sum")
    _build.check(lib.secp_gej_sum(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), inf32.data_ptr(),
        ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), oinf.data_ptr(),
        part.data_ptr(), lanes, blocks, _build.stream_ptr()), "gej_sum")
    return ox, oy, oz, oinf != 0


def _jp_rows(a) -> JP:
    x, y, z, inf = a
    return JP(_rows_fe(x), _rows_fe(y), _rows_fe(z), inf.to(torch.bool))


def gej_add_ref(a, b):
    """Plain version of :func:`gej_add` (any device)."""
    out = jp_add(_jp_rows(a), _jp_rows(b))
    return _canon32(out.x), _canon32(out.y), _canon32(out.z), out.inf


def gej_add(a, b):
    """Complete jacobian a + b, lane by lane: a and b are (x, y, z
    ``[16, B]`` int32 limbs, inf ``[B]`` bool).  Handles P + P, P + (-P)
    and infinity operands.

    Returns (x, y, z ``[16, B]`` int32 **canonical**, inf ``[B]`` bool).
    CUDA tensors go through the hand-written kernel (``csrc/gej_add.cu``);
    CPU tensors through the plain version."""
    if not a[0].is_cuda:
        return gej_add_ref(a, b)
    lanes = _build.check_rows(a[0], LIMBS, "gej_add ax")
    i32 = torch.int32
    args = []
    for side, (x, y, z, inf) in (("a", a), ("b", b)):
        for name, t in (("x", x), ("y", y), ("z", z)):
            _build.check_rows(t, LIMBS, f"gej_add {side}{name}", lanes)
        if not inf.is_cuda or inf.shape != (lanes,):
            raise ValueError(f"gej_add {side}inf: expected a CUDA [B] mask")
        # the int32 flags die with this call while the kernel may still
        # run: safe, the caching allocator reuses a block in stream order
        args += [x, y, z, inf.to(i32).contiguous()]
    ox = torch.empty((LIMBS, lanes), dtype=i32, device=a[0].device)
    oy = torch.empty_like(ox)
    oz = torch.empty_like(ox)
    oinf = torch.empty((lanes,), dtype=i32, device=a[0].device)
    lib = _build.lib()
    _build.count_launch("gej_add")
    _build.check(lib.secp_gej_add(
        *(t.data_ptr() for t in args), ox.data_ptr(), oy.data_ptr(),
        oz.data_ptr(), oinf.data_ptr(), lanes, _build.stream_ptr()),
        "gej_add")
    return ox, oy, oz, oinf != 0
