"""Batched constant-time modular inversion via safegcd divsteps — plain
PyTorch version of the device function the kernels share
(``csrc/modinv.cuh``).

Counterpart of the JAX package's ``ops/pallas_divsteps.py``.  That file
runs 43 batches of 14 divsteps on 14-bit limbs because its vector unit has
no 64-bit lanes.  With 64-bit integers the reference C shape fits
(Bernstein-Yang as in ``secp256k1_modinv32``): **20 batches of 30
divsteps on 9 signed 30-bit limbs** with int64 accumulators, 600 >= the
590 divsteps proven sufficient for 256-bit inputs.  The CUDA device
function and this plain version share that shape; the contract is the
value: canonical ``[16, B]`` limbs in, canonical inverse out,
``inv(0) = 0``.
"""

from __future__ import annotations

from functools import lru_cache

import torch

L = 30                    # limb bits == divsteps per batch
ML = (1 << L) - 1
NL = 9                    # 9 * 30 = 270 bits: fits (-2*mod, mod) signed
NBATCH = 20               # 20 * 30 = 600 >= 590 required divsteps
I64 = torch.int64


@lru_cache(maxsize=8)
def _modinfo(modulus: int):
    """(mod limbs base 2^L, modulus^-1 mod 2^L) as python ints."""
    limbs = tuple((modulus >> (L * i)) & ML for i in range(NL))
    return limbs, pow(modulus, -1, 1 << L)


def _from16(x16):
    """16 x 16-bit limb rows -> NL x L-bit rows."""
    out = []
    for i in range(NL):
        bit = L * i
        idx, off = bit // 16, bit % 16
        if idx >= 16:
            out.append(torch.zeros_like(x16[0]))
            continue
        v = x16[idx] >> off
        take, j = 16 - off, idx + 1
        while take < L and j < 16:
            v = v | (x16[j] << take)
            take += 16
            j += 1
        out.append(v & ML)
    return out


def _to16(xl):
    """NL x L-bit (canonical, non-negative) rows -> 16 x 16-bit rows."""
    out = []
    for i in range(16):
        bit = 16 * i
        idx, off = bit // L, bit % L
        v = xl[idx] >> off
        take, j = L - off, idx + 1
        while take < 16 and j < NL:
            v = v | (xl[j] << take)
            take += L
            j += 1
        out.append(v & 0xFFFF)
    return out


def _divsteps_batch(zeta, f0, g0):
    """L constant-time divsteps on the bottom limbs; returns (zeta',
    (u, v, q, r)) with |entries| <= 2^L."""
    u = torch.ones_like(f0)
    v = torch.zeros_like(f0)
    q = torch.zeros_like(f0)
    r = torch.ones_like(f0)
    f, g = f0, g0
    for _ in range(L):
        c1 = zeta >> 63                       # all-ones iff zeta < 0
        c2 = -(g & 1)                         # all-ones iff g odd
        x = (f ^ c1) - c1
        y = (u ^ c1) - c1
        z = (v ^ c1) - c1
        g = g + (x & c2)
        q = q + (y & c2)
        r = r + (z & c2)
        m = c1 & c2
        zeta = (zeta ^ m) - 1
        f = f + (g & m)
        u = u + (q & m)
        v = v + (r & m)
        g = g >> 1
        u = u << 1
        v = v << 1
    return zeta, (u, v, q, r)


def _update_fg(f, g, t):
    """(t / 2^L) * [f, g] on NL signed-L-bit limb lists."""
    u, v, q, r = t
    cf = (u * f[0] + v * g[0]) >> L           # bottom L bits provably zero
    cg = (q * f[0] + r * g[0]) >> L
    fo, go = [], []
    for i in range(1, NL):
        cf = cf + u * f[i] + v * g[i]
        cg = cg + q * f[i] + r * g[i]
        fo.append(cf & ML)
        go.append(cg & ML)
        cf = cf >> L
        cg = cg >> L
    fo.append(cf)                             # top limb keeps the sign
    go.append(cg)
    return fo, go


def _update_de(d, e, t, mod_limbs, inv_l: int):
    """(t * [d, e] + modulus * [md, me]) / 2^L keeping d, e in
    (-2*modulus, modulus).  |u*di + v*ei| < 2^60 and |mod_i * md| < 2^61,
    so every accumulator fits int64."""
    u, v, q, r = t
    sd = d[NL - 1] >> 63
    se = e[NL - 1] >> 63
    md = (u & sd) + (v & se)
    me = (q & sd) + (r & se)
    cd = u * d[0] + v * e[0]
    ce = q * d[0] + r * e[0]
    # correct md, me so the bottom L bits of the sum vanish (only the
    # value mod 2^L matters, so the operands are masked first)
    md = md - ((inv_l * (cd & ML) + md) & ML)
    me = me - ((inv_l * (ce & ML) + me) & ML)
    cd = (cd + mod_limbs[0] * md) >> L
    ce = (ce + mod_limbs[0] * me) >> L
    do, eo = [], []
    for i in range(1, NL):
        cd = cd + u * d[i] + v * e[i]
        ce = ce + q * d[i] + r * e[i]
        if mod_limbs[i]:
            cd = cd + mod_limbs[i] * md
            ce = ce + mod_limbs[i] * me
        do.append(cd & ML)
        eo.append(ce & ML)
        cd = cd >> L
        ce = ce >> L
    do.append(cd)
    eo.append(ce)
    return do, eo


def _normalize_final(d, sign, mod_limbs):
    """negate-if(sign<0), then two rounds of conditional modulus adds +
    carry propagation -> limbs in [0, 2^L), value in [0, modulus)."""
    for _ in range(2):
        cond_add = d[NL - 1] >> 63
        d = [di + (m & cond_add) for di, m in zip(d, mod_limbs)]
        if sign is not None:
            cond_neg = sign >> 63
            d = [(di ^ cond_neg) - cond_neg for di in d]
            sign = None
        carry = torch.zeros_like(d[0])
        for i in range(NL - 1):
            t = d[i] + carry
            d[i] = t & ML
            carry = t >> L
        d[NL - 1] = d[NL - 1] + carry         # top limb keeps the sign
    return d


def inv_limbs16(x: torch.Tensor, modulus: int) -> torch.Tensor:
    """``[16, B]`` canonical base-2^16 limbs -> x^-1 mod modulus, same
    layout (int64), canonical; ``inv(0) = 0``."""
    mod_limbs, inv_l = _modinfo(modulus)
    x = x.to(I64)
    g = _from16(list(x.unbind(0)))
    zeta = torch.full_like(g[0], -1)
    f = [torch.full_like(g[0], m) for m in mod_limbs]
    d = [torch.zeros_like(zeta) for _ in range(NL)]
    e = [torch.zeros_like(zeta) for _ in range(NL)]
    e[0] = torch.ones_like(zeta)
    for _ in range(NBATCH):
        zeta, t = _divsteps_batch(zeta, f[0] | (f[1] << L),
                                  g[0] | (g[1] << L))
        d, e = _update_de(d, e, t, mod_limbs, inv_l)
        f, g = _update_fg(f, g, t)
    # f == +/- 1 now; its sign lives in the top limb
    out = _normalize_final(d, f[NL - 1], mod_limbs)
    return torch.stack(_to16(out), 0)
