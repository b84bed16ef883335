"""Host-side (Python int) secp256k1 point arithmetic.

The port's own copy of the JAX package's ``utils/hostcurve.py`` (the port
imports nothing of that package).  Used for build-time precomputation of
device tables — the analogue of the reference's table generators
(src/precompute_ecmult.c, src/precompute_ecmult_gen.c) — and as the
Python-int ground truth of tests and of ``chip_smoke.py``.  Never on the hot
path.
"""

from __future__ import annotations

P = 2 ** 256 - 2 ** 32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
G = (GX, GY)
INF = None


def add(a, b):
    if a is INF:
        return b
    if b is INF:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return INF
        lam = (3 * x1 * x1) * pow(2 * y1, P - 2, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def neg(a):
    return INF if a is INF else (a[0], (P - a[1]) % P)


def mul(k, pt=G):
    k %= N
    r, q = INF, pt
    while k:
        if k & 1:
            r = add(r, q)
        q = add(q, q)
        k >>= 1
    return r


# -- jacobian helpers for bulk table generation ------------------------------
# Affine add() costs one pow(..., P-2) inversion per point, far too slow for
# the 2368-entry comb table.  Jacobian accumulation + one shared Montgomery
# inversion builds it in well under a second, the host analog of
# ge_set_all_gej_var (src/group_impl.h:236).


def jdouble(a):
    if a is INF:
        return INF
    x, y, z = a
    A = x * x % P
    B = y * y % P
    C = B * B % P
    D = 2 * ((x + B) * (x + B) - A - C) % P
    E = 3 * A % P
    x3 = (E * E - 2 * D) % P
    y3 = (E * (D - x3) - 8 * C) % P
    z3 = 2 * y * z % P
    return (x3, y3, z3) if z3 else INF


def jadd(a, b):
    """Jacobian + jacobian (python ints); INF is None."""
    if a is INF:
        return b
    if b is INF:
        return a
    x1, y1, z1 = a
    x2, y2, z2 = b
    zz1, zz2 = z1 * z1 % P, z2 * z2 % P
    u1, u2 = x1 * zz2 % P, x2 * zz1 % P
    s1, s2 = y1 * zz2 * z2 % P, y2 * zz1 * z1 % P
    if u1 == u2:
        if (s1 + s2) % P == 0:
            return INF
        return jdouble(a)
    h = (u2 - u1) % P
    r = (s2 - s1) % P
    hh = h * h % P
    hhh = hh * h % P
    v = u1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    y3 = (r * (v - x3) - s1 * hhh) % P
    z3 = z1 * z2 * h % P
    return (x3, y3, z3) if z3 else INF


def jlift(a):
    return INF if a is INF else (a[0], a[1], 1)


def batch_affine(pts):
    """Jacobian list -> affine list with ONE modular inversion
    (Montgomery's trick).  INF entries are not supported (table
    generation never produces them)."""
    zs = [p[2] for p in pts]
    prefix = [1]
    for z in zs:
        prefix.append(prefix[-1] * z % P)
    inv = pow(prefix[-1], P - 2, P)
    out = [None] * len(pts)
    for i in range(len(pts) - 1, -1, -1):
        zi = inv * prefix[i] % P
        inv = inv * zs[i] % P
        zi2 = zi * zi % P
        out[i] = (pts[i][0] * zi2 % P, pts[i][1] * zi2 * zi % P)
    return out
