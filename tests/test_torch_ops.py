"""The port's device library, function by function, against the JAX package
and Python integers.

Each case sends the same numpy inputs (``np.random.default_rng(seed)`` plus
the edge values of test_glv.py / test_divsteps.py) through a helper of the
JAX kernels (plain elementwise functions on lists of limb vectors, run on
the CPU; the ``jax.jit``-wrapped ones under ``jax.disable_jit()`` so they
run op by op instead of compiling) and through its plain-PyTorch
counterpart in ``secp256k1_zkp_tpu_torch``.

Tolerance: 0 — everything is an integer.  Canonical quantities (digits,
flags, inverses, canonical limbs, ``ops/limb.py`` results) are compared
limb for limb.  *Weak* field results (< 2^256, possibly >= p) are compared
after ``canon_p`` on both sides: the port sums columns in 64-bit integers,
so its weak representative may be the other one of the residue class.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from secp256k1_zkp_tpu.ops import field as JF
from secp256k1_zkp_tpu.ops import limb as JL
from secp256k1_zkp_tpu.ops import pallas_divsteps as JDS
from secp256k1_zkp_tpu.ops import pallas_field as JPF
from secp256k1_zkp_tpu.ops import pallas_group as JPG
from secp256k1_zkp_tpu.ops import pallas_scalar as JPS
from secp256k1_zkp_tpu.ops import scalar as JS
from secp256k1_zkp_tpu_torch.ops import cuda_divsteps as TDS
from secp256k1_zkp_tpu_torch.ops import cuda_field as TF
from secp256k1_zkp_tpu_torch.ops import cuda_group as TG
from secp256k1_zkp_tpu_torch.ops import cuda_scalar as TS
from secp256k1_zkp_tpu_torch.ops import field as PF
from secp256k1_zkp_tpu_torch.ops import limb as PL
from secp256k1_zkp_tpu_torch.ops import scalar as PS
from secp256k1_zkp_tpu_torch.utils import hostcurve as hc

P, N = hc.P, hc.N
LAM = TS.LAMBDA


# -- plumbing ----------------------------------------------------------------


def rows_np(vals, k=16):
    return np.array([[(v >> (16 * i)) & 0xFFFF for v in vals]
                     for i in range(k)], np.uint32)


def jrows(vals, k=16):
    return [jnp.asarray(r) for r in rows_np(vals, k)]


def trows(vals, k=16):
    return torch.from_numpy(rows_np(vals, k).astype(np.int64))


def ints(rows):
    """[K, B] limb rows (list of jax arrays, numpy or torch) -> ints."""
    if isinstance(rows, torch.Tensor):
        arr = rows.numpy()
    else:
        arr = np.stack([np.asarray(r) for r in rows])
    arr = arr.astype(object)
    return [sum(int(arr[i, j]) << (16 * i) for i in range(arr.shape[0]))
            for j in range(arr.shape[1])]


def jcanon(fe_or_rows):
    rows = fe_or_rows.l if isinstance(fe_or_rows, JPG.FE) else fe_or_rows
    if isinstance(fe_or_rows, JPG.FE):
        rows = JPG.fe_weak(fe_or_rows).l
    return ints(JPF._canon_p(list(rows)))


def tcanon(fe_or_rows):
    if isinstance(fe_or_rows, TG.FE):
        fe_or_rows = TG.fe_weak(fe_or_rows).l
    return ints(TF.canon_p(fe_or_rows))


def rand(rng, mod, n):
    return [int.from_bytes(rng.bytes(32), "big") % mod for _ in range(n)]


def field_vals(seed, n=20):
    rng = np.random.default_rng(seed)
    return [0, 1, 2, P - 1, P, P + 1, 2 ** 256 - 1, 2 ** 255,
            0xFFFF, 0x10000, 2 ** 128] + rand(rng, 2 ** 256, n)


def scalar_vals(seed, n=20):
    rng = np.random.default_rng(seed)
    return rand(rng, N, n) + [0, 1, 2, N - 1, N - 2, TS._N_HALF,
                              TS._N_HALF + 1, 2 ** 128, 2 ** 128 - 1,
                              2 ** 128 + 1, LAM, N - LAM, (LAM * LAM) % N]


# -- GF(p) -------------------------------------------------------------------


@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_field_mul_sqr(op):
    a = field_vals(1)
    b = a[::-1]
    with jax.disable_jit():
        if op == "mul":
            want_j = JPF._mul_limbs(jrows(a), jrows(b))
        else:
            want_j = JPF._sqr_limbs(jrows(a))
    got = (TF.mul_limbs(trows(a), trows(b)) if op == "mul"
           else TF.sqr_limbs(trows(a)))
    assert int(got.max()) <= 0xFFFF and int(got.min()) >= 0   # weak form
    want = [x * (y if op == "mul" else x) % P for x, y in zip(a, b)]
    assert tcanon(got) == jcanon(want_j) == want


def test_field_canon_p():
    a = field_vals(2)
    assert ints(TF.canon_p(trows(a))) == ints(JPF._canon_p(jrows(a))) \
        == [x % P for x in a]


def test_field_reduce_cols_and_weak():
    rng = np.random.default_rng(3)
    cols = rng.integers(0, 2 ** 36, (32, 24), dtype=np.int64)
    cols[:, 0] = 2 ** 36 - 1
    val = [sum(int(cols[k, j]) << (16 * k) for k in range(32)) % P
           for j in range(24)]
    assert tcanon(TF.reduce_cols(torch.from_numpy(cols))) == val
    # 31 columns (a product) and the JAX fold on the same columns
    small = rng.integers(0, 2 ** 21, (32, 24), dtype=np.int64)
    small[31] = 0
    want_j = JPF._reduce_cols([jnp.asarray(r.astype(np.uint32))
                               for r in small])
    assert tcanon(TF.reduce_cols(torch.from_numpy(small[:31]))) \
        == jcanon(want_j)
    lim = rng.integers(0, 2 ** 32, (16, 24), dtype=np.int64)
    assert tcanon(TF.weak_p(torch.from_numpy(lim))) == [
        sum(int(lim[k, j]) << (16 * k) for k in range(16)) % P
        for j in range(24)]


# -- GF(n), GLV, recoding ----------------------------------------------------


def test_scalar_mul_canon_n():
    a = scalar_vals(4) + [2 ** 256 - 1]
    b = a[::-1]
    want_j = JPS._canon_n(JPS._mul_limbs_n(jrows(a), jrows(b)))
    got = TS.canon_n(TS.mul_limbs_n(trows(a), trows(b)))
    assert ints(got) == ints(want_j) == [x * y % N for x, y in zip(a, b)]
    assert ints(TS.canon_n(trows(a))) == ints(JPS._canon_n(jrows(a)))


@pytest.mark.parametrize("g", [TS._G1, TS._G2], ids=["g1", "g2"])
def test_mul_shift384_round(g):
    ks = scalar_vals(5)
    got = ints(TS.mul_shift384_round(trows(ks), g))
    assert got == ints(JPS._mul_shift384_round(jrows(ks), g))
    assert got == [(k * g + (1 << 383)) >> 384 for k in ks]


def test_glv_split():
    ks = scalar_vals(6)
    a1, n1, a2, n2 = TS.glv_split(trows(ks))
    j1, jn1, j2, jn2 = JPS._glv_split(jrows(ks))
    assert ints(a1) == ints(j1) and ints(a2) == ints(j2)
    assert n1.tolist() == np.asarray(jn1).tolist()
    assert n2.tolist() == np.asarray(jn2).tolist()
    for k, x1, s1, x2, s2 in zip(ks, ints(a1), n1.tolist(), ints(a2),
                                 n2.tolist()):
        r1 = (-x1) % N if s1 else x1
        r2 = (-x2) % N if s2 else x2
        assert (r1 + LAM * r2) % N == k
        assert x1 < 2 ** 128 and x2 < 2 ** 128


def _decode(digs, w):
    acc = [0] * digs.shape[1]
    for row in digs.tolist():
        for j, d in enumerate(row):
            mag, sgn = d & 0xFF, d >> 8
            assert mag <= 1 << (w - 1) and sgn in (0, 1)
            acc[j] = acc[j] * (1 << w) + (-mag if sgn else mag)
    return acc


@pytest.mark.parametrize("which", ["w5", "w7"])
def test_recode_signed(which):
    rng = np.random.default_rng(7)
    if which == "w5":
        vals = [int.from_bytes(rng.bytes(16), "big") for _ in range(24)]
        vals += [0, 1, 2 ** 128 - 1, 16, 17, 31, 32, 33 * 32 ** 10]
        got = TS.recode_w5(trows(vals, 8))
        want = JPS.recode_w5(jrows(vals, 8))
        assert got.shape[0] == TS.NW5 == JPS.NW5
    else:
        vals = scalar_vals(7) + [2 ** 256 - 1, 64, 65, 127, 128]
        got = TS.recode_w7_256(trows(vals))
        want = JPS.recode_w7_256(jrows(vals))
        assert got.shape[0] == TS.NW7 == JPS.NW7
    assert got.tolist() == np.stack([np.asarray(r) for r in want]).tolist()
    assert _decode(got, 5 if which == "w5" else 7) == vals


# -- safegcd inverse -----------------------------------------------------------


@pytest.mark.parametrize("mod", [P, N], ids=["p", "n"])
def test_inv_limbs16(mod):
    rng = np.random.default_rng(8)
    vals = [0, 1, 2, 3, mod - 1, mod - 2, (mod - 1) // 2, 2 ** 255 % mod,
            0xFFFF, 0x10000, 2 ** 128, 2 ** 129 - 1] + rand(rng, mod, 20)
    got = ints(TDS.inv_limbs16(trows(vals), mod))
    assert got == [pow(v, -1, mod) if v else 0 for v in vals]
    # the JAX kernel helper on the first 8 lanes (it runs op by op)
    assert got[:8] == ints(JDS.inv_limbs16(jrows(vals[:8]), mod))


def test_divsteps_limb_conversion():
    rng = np.random.default_rng(9)
    vals = rand(rng, 2 ** 256, 16) + [0, 2 ** 256 - 1]
    x = list(trows(vals).unbind(0))
    assert ints(torch.stack(TDS._to16(TDS._from16(x)))) == vals


# -- group formulas ------------------------------------------------------------


def _points(seed, n):
    rng = np.random.default_rng(seed)
    return [hc.mul(int.from_bytes(rng.bytes(32), "big") % N or 1)
            for _ in range(n)]


def _jac(seed, pts):
    """Affine points -> jacobian (x z^2, y z^3, z) with random z."""
    rng = np.random.default_rng(seed)
    out = []
    for x, y in pts:
        z = int.from_bytes(rng.bytes(32), "big") % P or 1
        out.append((x * z * z % P, y * z ** 3 % P, z))
    return out


def _jp_pair(jac, inf):
    """The same jacobian lanes as a JAX ``JP`` and a port ``JP``."""
    xs, ys, zs = ([c[i] for c in jac] for i in range(3))
    j = JPG.JP(JPG.FE(jrows(xs), 0xFFFF), JPG.FE(jrows(ys), 0xFFFF),
               JPG.FE(jrows(zs), 0xFFFF),
               jnp.asarray(np.array(inf, np.uint32)))
    t = TG.JP(TG.FE(trows(xs), 0xFFFF), TG.FE(trows(ys), 0xFFFF),
              TG.FE(trows(zs), 0xFFFF), torch.tensor(inf, dtype=torch.bool))
    return j, t


def _affine(x, y, z, inf):
    out = []
    for xv, yv, zv, iv in zip(x, y, z, inf):
        if iv:
            out.append(None)
        else:
            zi = pow(zv, -1, P)
            out.append((xv * zi * zi % P, yv * zi ** 3 % P))
    return out


def _same_point(jout, tout, want):
    """JAX and port outputs agree coordinate for coordinate (canonical)
    on finite lanes, flag for flag, and both equal ``want`` (affine)."""
    jinf = [bool(v) for v in np.asarray(jout.inf)]
    tinf = tout.inf.tolist()
    assert jinf == tinf == [w is None for w in want]
    jc = [jcanon(c) for c in (jout.x, jout.y, jout.z)]
    tc = [tcanon(c) for c in (tout.x, tout.y, tout.z)]
    for lane, w in enumerate(want):
        if w is not None:
            assert [c[lane] for c in jc] == [c[lane] for c in tc], lane
    assert _affine(*tc, tinf) == want


def test_jp_double():
    pts = _points(10, 6)
    jac = _jac(11, pts)
    j, t = _jp_pair(jac, [0] * 6)
    with jax.disable_jit():
        jout = JPG.jp_double(j)
    _same_point(jout, TG.jp_double(t), [hc.add(p, p) for p in pts])


def _add_cases(seed):
    """(a, b, a_inf, b_inf) lanes: generic, P+P, P+(-P), inf operands."""
    pts = _points(seed, 8)
    a = [pts[0], pts[1], pts[2], pts[3], pts[4], pts[5], pts[6]]
    b = [pts[7], pts[1], hc.neg(pts[2]), pts[0], pts[1], pts[2], pts[6]]
    ainf = [0, 0, 0, 1, 0, 1, 0]
    binf = [0, 0, 0, 0, 1, 1, 0]
    want = []
    for p, q, i, k in zip(a, b, ainf, binf):
        want.append(hc.add(None if i else p, None if k else q))
    return a, b, ainf, binf, want


def test_jp_add_aff():
    a, b, ainf, binf, want = _add_cases(12)
    j, t = _jp_pair(_jac(13, a), ainf)
    bx, by = [p[0] for p in b], [p[1] for p in b]
    with jax.disable_jit():
        jout = JPG.jp_add_aff(j, JPG.FE(jrows(bx), 0xFFFF),
                              JPG.FE(jrows(by), 0xFFFF),
                              jnp.asarray(np.array(binf, np.uint32)))
    tout = TG.jp_add_aff(t, TG.FE(trows(bx), 0xFFFF), TG.FE(trows(by), 0xFFFF),
                         torch.tensor(binf, dtype=torch.bool))
    _same_point(jout, tout, want)


def test_jp_add():
    a, b, ainf, binf, want = _add_cases(14)
    ja, ta = _jp_pair(_jac(15, a), ainf)
    jb, tb = _jp_pair(_jac(16, b), binf)
    with jax.disable_jit():
        jout = JPG.jp_add(ja, jb)
    _same_point(jout, TG.jp_add(ta, tb), want)


def test_add_aff_ratio():
    pts = _points(17, 6)
    a = pts[:5] + [pts[0]]
    b = pts[1:6] + [hc.neg(pts[0])]       # last lane: the degenerate select
    b[-1] = hc.mul(3, pts[0])             # keep it finite: P + 3P
    jac = _jac(18, a)
    xs, ys, zs = ([c[i] for c in jac] for i in range(3))
    bx, by = [p[0] for p in b], [p[1] for p in b]
    with jax.disable_jit():
        jo = JPG._add_aff_ratio(*(JPG.FE(jrows(v), 0xFFFF)
                                  for v in (xs, ys, zs, bx, by)))
    to = TG.add_aff_ratio(*(TG.FE(trows(v), 0xFFFF)
                            for v in (xs, ys, zs, bx, by)))
    jc = [jcanon(c) for c in jo]
    tc = [tcanon(c) for c in to]
    assert jc == tc
    x3, y3, z3, m = tc
    assert _affine(x3, y3, z3, [0] * 6) == [hc.add(p, q)
                                            for p, q in zip(a, b)]
    assert [z * r % P for z, r in zip(zs, m)] == z3     # m is the z-ratio


def test_fe_helpers():
    a = field_vals(19, 8)
    b = a[::-1]
    ta, tb = TG.FE(trows(a), 0xFFFF), TG.FE(trows(b), 0xFFFF)
    ja, jb = JPG.FE(jrows(a), 0xFFFF), JPG.FE(jrows(b), 0xFFFF)
    assert tcanon(TG.fe_half(ta)) == jcanon(JPG.fe_half(ja)) \
        == [x * pow(2, -1, P) % P for x in a]
    assert tcanon(TG.fe_sub(ta, tb)) == jcanon(JPG.fe_sub(ja, jb)) \
        == [(x - y) % P for x, y in zip(a, b)]
    big = TG.fe_mul_int(TG.fe_add(ta, tb), 8)
    assert tcanon(big) == [8 * (x + y) % P for x, y in zip(a, b)]
    assert TG.fe_is_zero(ta).tolist() == [x % P == 0 for x in a] \
        == [bool(v) for v in np.asarray(JPG.fe_is_zero(ja))]


# -- ops/limb.py: the [..., 16] engine, limb for limb ------------------------------


def _lb_pair(vals):
    arr = rows_np(vals).T.copy()                       # [B, 16]
    return (JL.LB(jnp.asarray(arr), 0xFFFF),
            PL.LB(torch.from_numpy(arr.astype(np.int64)), 0xFFFF))


def _same_lb(j, t):
    assert j.bound == t.bound
    assert np.asarray(j.v).astype(np.int64).tolist() == t.v.tolist()


@pytest.mark.parametrize("which", ["p", "n"])
def test_limb_mod_ops(which):
    jm, tm, mod = ((JF.FP, PF.FP, P) if which == "p" else (JS.FN, PS.FN, N))
    a = field_vals(20, 8)
    b = a[::-1]
    ja, ta = _lb_pair(a)
    jb, tb = _lb_pair(b)
    _same_lb(jm.mul(ja, jb), tm.mul(ta, tb))
    _same_lb(jm.sqr(ja), tm.sqr(ta))
    _same_lb(jm.neg(ja), tm.neg(ta))
    _same_lb(jm.norm_weak(jm.sub(ja, jb)), tm.norm_weak(tm.sub(ta, tb)))
    _same_lb(jm.normalize(jm.mul_int(jm.add(ja, jb), 7)),
             tm.normalize(tm.mul_int(tm.add(ta, tb), 7)))
    _same_lb(jm.half(ja), tm.half(ta))
    got = tm.normalize(tm.mul(ta, tb))
    assert [PL.limbs_to_int_np(r) for r in got.v.numpy()] \
        == [x * y % mod for x, y in zip(a, b)]
    assert np.asarray(jm.is_zero(ja)).tolist() == tm.is_zero(ta).tolist() \
        == [x % mod == 0 for x in a]
    assert np.asarray(jm.eq(ja, jb)).tolist() == tm.eq(ta, tb).tolist()
    assert np.asarray(jm.is_odd(ja)).tolist() == tm.is_odd(ta).tolist()
    mask = np.arange(len(a)) % 2 == 0
    _same_lb(JL.Mod.select(jnp.asarray(mask), ja, jb),
             PL.Mod.select(torch.from_numpy(mask), ta, tb))
    assert np.asarray(jm.get_bits(ja, 13, 9)).tolist() \
        == tm.get_bits(ta, 13, 9).tolist()


@pytest.mark.parametrize("which", ["p", "n"])
def test_limb_byte_codecs(which):
    jmod, tmod, mod = ((JF, PF, P) if which == "p" else (JS, PS, N))
    vals = field_vals(21, 8)
    raw = np.array([list(v.to_bytes(32, "big")) for v in vals], np.uint8)
    jv, jovf = jmod.from_bytes_be(jnp.asarray(raw))
    tv, tovf = tmod.from_bytes_be(torch.from_numpy(raw))
    _same_lb(jv, tv)
    assert np.asarray(jovf).tolist() == tovf.tolist() \
        == [v >= mod for v in vals]
    back = tmod.to_bytes_be(tv)
    assert back.dtype == torch.uint8
    assert back.tolist() == np.asarray(jmod.to_bytes_be(jv)).tolist() \
        == [list((v % mod if v < 2 * mod else v).to_bytes(32, "big"))
            if v < mod else list((v - mod).to_bytes(32, "big")) for v in vals]


def test_scalar_is_high():
    vals = scalar_vals(22, 8)
    j, t = _lb_pair(vals)
    assert np.asarray(JS.is_high(j)).tolist() == PS.is_high(t).tolist() \
        == [v > (N - 1) // 2 for v in vals]
