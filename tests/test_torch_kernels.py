"""The port's four kernels, each as a whole, on the CPU: the plain version
that sits beside each kernel wrapper against the composition the JAX
kernel body performs and against Python integers.

* ``ecdsa_prep`` (B1): the JAX body's dataflow ``inv_limbs16 -> _mul_limbs_n
  -> _canon_n -> _glv_split -> recode_w5 / recode_w7_256``, run op by op.
* ``fixedbase_digits`` (B2): the JAX body's row loop written out with
  ``_gather_const`` / ``jp_add_aff`` under ``jax.disable_jit()`` on four
  lanes, for the last 10 of the 37 rows (scalars whose other digits are
  zero); full-width scalars against Python integers.
* ``ecmult_glv`` (B3): against Python integers (``hostcurve``): X/Z^2,
  Y/Z^3 of the output equal u1*G + u2*P, the infinity flag, and ``ok`` for
  r, for r+n, for a wrong r and for the gated-off second candidate.  Its
  building blocks are held against the JAX formulas in test_torch_ops.py.
* ``mulmod_chain`` (B15a): against the JAX chain and ``pow``.

Tolerance: 0 (integers).  Digits and flags are compared row for row;
jacobian coordinates are canonical in the port and are compared with the
canonicalised JAX values.  On CPU tensors a wrapper takes its plain
version, so calling the wrapper here exercises the same code path the
tests of the slice use; the launch counters must not move.
"""

import ctypes
import hashlib
import re
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from secp256k1_zkp_tpu.ops import pallas_divsteps as JDS
from secp256k1_zkp_tpu.ops import pallas_field as JPF
from secp256k1_zkp_tpu.ops import pallas_gen as JGEN
from secp256k1_zkp_tpu.ops import pallas_group as JPG
from secp256k1_zkp_tpu.ops import pallas_scalar as JPS
from secp256k1_zkp_tpu_torch.ops import _build
from secp256k1_zkp_tpu_torch.ops import cuda_field as TF
from secp256k1_zkp_tpu_torch.ops import cuda_gen as TGEN
from secp256k1_zkp_tpu_torch.ops import cuda_group as TG
from secp256k1_zkp_tpu_torch.ops import cuda_msm as TM
from secp256k1_zkp_tpu_torch.ops import cuda_scalar as TS
from secp256k1_zkp_tpu_torch.ops import cuda_sha256 as TC
from secp256k1_zkp_tpu_torch.ops import sha256 as TH
from secp256k1_zkp_tpu_torch.utils import hostcurve as hc

import oracle
from test_torch_ops import ints, jcanon, jrows, rand, rows_np

P, N = hc.P, hc.N
I32 = torch.int32


def trows32(vals, k=16):
    return torch.from_numpy(rows_np(vals, k).astype(np.int32))


def _stack(rows):
    return np.stack([np.asarray(r) for r in rows]).astype(np.int64).tolist()


def test_mulmod_chain():
    rng = np.random.default_rng(30)
    x = [0, 1, P - 1, P, 2 ** 256 - 1] + rand(rng, 2 ** 256, 11)
    y = x[::-1]
    for n in (1, 5):
        before = dict(_build.LAUNCH_COUNTS)
        got = TF.mulmod_chain(trows32(x), trows32(y), n)
        assert _build.LAUNCH_COUNTS == before      # CPU: no kernel launch
        assert got.dtype == I32 and got.shape == (16, len(x))
        jx = jrows(x)
        with jax.disable_jit():
            for _ in range(n):
                jx = JPF._mul_limbs(jx, jrows(y))
        assert ints(got) == jcanon(jx) \
            == [a * pow(b, n, P) % P for a, b in zip(x, y)]


def test_ecdsa_prep_vs_jax_body():
    rng = np.random.default_rng(31)
    m = rand(rng, N, 4) + [0, 1, N - 1, 5]
    r = rand(rng, N, 4) + [1, N - 1, 7, 9]
    s = rand(rng, N, 4) + [1, N - 1, 3, 0]          # last lane: s = 0
    before = dict(_build.LAUNCH_COUNTS)
    digs, gdigs, flags = TS.ecdsa_prep(trows32(m), trows32(r), trows32(s))
    assert _build.LAUNCH_COUNTS == before
    assert digs.shape == (52, 8) and gdigs.shape == (37, 8)
    assert flags.shape == (2, 8) and digs.dtype == I32

    # the JAX kernel body, op by op (pallas_scalar._ecdsa_prep_kernel)
    sinv = JDS.inv_limbs16(jrows(s), N)
    u1 = JPS._canon_n(JPS._mul_limbs_n(jrows(m), sinv))
    u2 = JPS._canon_n(JPS._mul_limbs_n(jrows(r), sinv))
    a1, neg1, a2, neg2 = JPS._glv_split(u2)
    assert digs.tolist() == _stack(JPS.recode_w5(a1) + JPS.recode_w5(a2))
    assert gdigs.tolist() == _stack(JPS.recode_w7_256(u1))
    assert flags.tolist() == _stack([neg1, neg2])

    # and Python integers: the digit rows decode to u1 and to u2's halves
    for j in range(8):
        si = pow(s[j], -1, N) if s[j] else 0
        w1, w2 = m[j] * si % N, r[j] * si % N

        def dec(rows, w):
            acc = 0
            for d in rows:
                acc = acc * (1 << w) + (-(d & 0xFF) if d >> 8 else d & 0xFF)
            return acc

        assert dec(gdigs[:, j].tolist(), 7) == w1
        h1 = dec(digs[:26, j].tolist(), 5) * (-1 if flags[0, j] else 1)
        h2 = dec(digs[26:, j].tolist(), 5) * (-1 if flags[1, j] else 1)
        assert (h1 + TS.LAMBDA * h2) % N == w2
    assert not digs[:, 7].any() and not gdigs[:, 7].any()   # s = 0 lane


JAX_ROWS = 10       # comb rows the JAX loop is run for (see below)


def test_fixedbase_digits_vs_jax_body():
    """The port runs all 37 rows.  The JAX loop costs ~1.6 s per eager
    complete add on this CPU, so it is run for the last ``JAX_ROWS`` rows
    only, on scalars < 2^(7*JAX_ROWS - 1) whose leading rows are all zero
    (a zero digit masks the add and leaves the accumulator as it was)."""
    rng = np.random.default_rng(32)
    top = 1 << (7 * JAX_ROWS - 1)
    ks = rand(rng, top, 2) + [0, 2 ** 7 * 65 + 64]  # u1 = 0 -> infinity lane
    gd = TS.recode_w7_256(torch.from_numpy(
        rows_np(ks).astype(np.int64))).to(I32)
    assert not gd[:JGEN.NW7 - JAX_ROWS].any()
    before = dict(_build.LAUNCH_COUNTS)
    x, y, z = TGEN.fixedbase_digits(gd)
    assert _build.LAUNCH_COUNTS == before
    assert x.dtype == I32 and x.shape == (16, 4)

    # the JAX kernel body's row loop (pallas_gen._gen_kernel)
    tab = jnp.asarray(JGEN._comb_tables_np())
    jd = jnp.asarray(gd.numpy().astype(np.uint32))
    with jax.disable_jit():
        acc = JPG.jp_inf(jd[0])
        for i in range(JGEN.NW7 - JAX_ROWS, JGEN.NW7):
            mag, sgn = jd[i] & 0xFF, jd[i] >> 8
            start = (JGEN.NW7 - 1 - i) * JGEN._TAB_STRIDE
            gx, gy = JGEN._gather_const(
                tab[:, start:start + JGEN._TAB_STRIDE], mag)
            gy = JPG.fe_select(sgn != 0, JPG.fe_weak(JPG.fe_neg(gy)), gy)
            acc = JPG.jp_add_aff(acc, gx, gy, (mag == 0).astype(jnp.uint32))
    inf = [bool(v) for v in np.asarray(acc.inf)]
    assert inf == [False, False, True, False]
    jx, jy, jz = jcanon(acc.x), jcanon(acc.y), jcanon(acc.z)
    px, py, pz = ints(x), ints(y), ints(z)
    for j, k in enumerate(ks):
        if inf[j]:
            assert pz[j] == 0                      # z = 0 marks infinity
            continue
        assert (px[j], py[j], pz[j]) == (jx[j], jy[j], jz[j])
        zi = pow(pz[j], -1, P)
        assert (px[j] * zi * zi % P, py[j] * zi ** 3 % P) == hc.mul(k)


def test_fixedbase_digits_full_width_vs_ints():
    rng = np.random.default_rng(34)
    ks = rand(rng, N, 5) + [1, N - 1, 2 ** 255]
    gd = TS.recode_w7_256(torch.from_numpy(
        rows_np(ks).astype(np.int64))).to(I32)
    x, y, z = TGEN.fixedbase_digits(gd)
    for j, (xv, yv, zv) in enumerate(zip(ints(x), ints(y), ints(z))):
        zi = pow(zv, -1, P)
        assert (xv * zi * zi % P, yv * zi ** 3 % P) == hc.mul(ks[j])


def _point_with_x_at_least_n():
    """A curve point whose x lies in [n, p): x = n + t for the first t
    that makes x^3 + 7 a square (p = 3 mod 4)."""
    t = 0
    while True:
        x = N + t
        y = pow((x ** 3 + 7) % P, (P + 1) // 4, P)
        if y * y % P == (x ** 3 + 7) % P:
            return t, (x, y)
        t += 1


def test_ecmult_glv_vs_ints(monkeypatch):
    rng = np.random.default_rng(33)
    t_small, r0 = _point_with_x_at_least_n()
    pts = [hc.mul(k or 1) for k in rand(rng, N, 4)]
    u1 = rand(rng, N, 4)
    u2 = rand(rng, N, 4)
    # lane 4: u1 = 0 (comb result is infinity); lane 5: u2 = 0;
    # lane 6: P infinite; lane 7: u1*G + u2*G = infinity;
    # lanes 8, 9: R = r0 whose x >= n (second candidate of the check)
    lanes = [(u1[i], u2[i], pts[i], False) for i in range(4)]
    lanes += [(0, u2[0], pts[0], False), (u1[1], 0, pts[1], False),
              (u1[2], u2[2], pts[2], True), (u1[3], N - u1[3], hc.G, False),
              (0, 1, r0, False), (0, 1, r0, False)]
    want = []
    for a, b, pt, pinf in lanes:
        want.append(hc.add(hc.mul(a), None if pinf else hc.mul(b, pt)))
    # rx per lane and the expected check result
    rx, ok = [], []
    for j, w in enumerate(want):
        xr = 0 if w is None else w[0]
        if j == 1:
            rx.append((xr + 1) % N); ok.append(False)        # wrong r
        elif j == 2:
            # X == (rx + n) mod p holds, but rx >= p - n gates it off
            rx.append(xr + P - N); ok.append(False)
            assert xr + P - N < 2 ** 256 and (xr + P - N + N) % P == xr
        elif j == 8:
            rx.append(t_small); ok.append(True)              # r + n == x(R)
        elif j == 9:
            rx.append(t_small + 1); ok.append(False)
        else:
            rx.append(xr % N); ok.append(w is not None and xr < N)

    # digit streams through the prep with s = 1: u1 = m, u2 = r
    one = trows32([1] * len(lanes))
    digs, gdigs, flags = TS.ecdsa_prep(trows32([c[0] for c in lanes]),
                                       trows32([c[1] for c in lanes]), one)
    gjac = TGEN.fixedbase_digits(gdigs)
    pinf = torch.tensor([c[3] for c in lanes])
    px = trows32([c[2][0] for c in lanes])
    py = trows32([c[2][1] for c in lanes])
    before = dict(_build.LAUNCH_COUNTS)
    x, y, z, inf, okv = TG.ecmult_glv(digs, flags, px, py, pinf, gjac,
                                      rx=trows32(rx))
    assert _build.LAUNCH_COUNTS == before
    assert x.dtype == I32 and x.shape == (16, len(lanes))
    assert inf.dtype == torch.bool and okv.dtype == torch.bool
    xs, ys, zs = ints(x), ints(y), ints(z)
    for j, w in enumerate(want):
        assert bool(inf[j]) == (w is None), j
        if w is not None:
            zi = pow(zs[j], -1, P)
            assert (xs[j] * zi * zi % P, ys[j] * zi ** 3 % P) == w, j
    assert okv.tolist() == ok
    # without rx the check is off and ok is all-false
    *_, ok2 = TG.ecmult_glv(digs, flags, px, py, pinf, gjac)
    assert not ok2.any()
    # the commitment pipeline on the comb and GLV Strauss (rx=None) with
    # the affine_meta kernel after them: tests/test_torch_pedersen.py
    from test_torch_pedersen import check_pedersen_generators_and_commitments
    check_pedersen_generators_and_commitments(monkeypatch)


def test_comb_table_matches_jax_and_hostcurve():
    from secp256k1_zkp_tpu_torch.utils import convert
    mine = TGEN.comb_tables()
    assert mine.shape == (37, 64, 2, 16) and mine.dtype == torch.int64
    conv = convert.comb_table_from_jax(JGEN._comb_tables_np())
    assert torch.equal(conv, mine)
    # spot entries against plain double-and-add
    for v, d in ((0, 1), (0, 64), (5, 17), (36, 3)):
        xw, yw = hc.mul((d << (7 * v)) % N)
        got = mine[v, d - 1].tolist()
        assert sum(l << (16 * i) for i, l in enumerate(got[0])) == xw
        assert sum(l << (16 * i) for i, l in enumerate(got[1])) == yw
    # the kernel's packed words hold the same bits
    words = TGEN.pack_words(mine).numpy().view(np.uint32).astype(np.int64)
    limbs = mine.numpy()
    assert ((words & 0xFFFF) == limbs[..., 0::2]).all()
    assert ((words >> 16) == limbs[..., 1::2]).all()


B0_HARNESS = Path(__file__).with_name("torch_b0_harness.cpp")


def _b0_harness(tmp_path):
    """Build the host harness of the B0 core with g++ (the portable branch
    of csrc/common.cuh's carry-chain primitives) and load it."""
    so = tmp_path / "b0_core.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-I",
                    str(_build.SRC_DIR), str(B0_HARNESS), "-o", str(so)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.b0_fe.argtypes = [i32, vp, vp, ctypes.c_uint32, vp, vp, i32]
    lib.b0_jp.argtypes = [i32, vp, vp, vp, i32]
    lib.b0_comb.argtypes = [vp, vp, i32, i32, i32, vp]
    lib.b0_msm_table.argtypes = [vp, vp, vp, i32, vp, vp]
    lib.b0_msm_finish.argtypes = [vp, vp, vp, vp, i32, i32, vp]
    lib.b0_gej_sum.argtypes = [vp, vp, vp, vp, i32, i32, i32, vp]
    u32 = ctypes.c_uint32
    lib.b0_sha_msg.argtypes = [vp, i32, i32, vp, vp, u32, u32, i32, i32, vp]
    lib.b0_rfc6979.argtypes = [vp, i32, vp, i32, i32, vp]
    lib.b0_batch_digest.argtypes = [vp, vp, vp, i32, i32, vp, vp]
    lib.b0_lift_x.argtypes = [vp, vp, vp, i32]
    lib.b0_even_root.argtypes = [vp, vp, i32]
    lib.b0_affine.argtypes = [i32, vp, vp, vp, vp, vp, vp, i32, i32]
    lib.b0_affine.restype = u32
    lib.b0_jacobi.argtypes = [vp, vp, i32]
    lib.b0_ecdsa_finish.argtypes = [vp] * 9 + [i32, i32]
    lib.b0_ecdsa_prep.argtypes = [vp] * 6 + [i32, i32]
    return lib


def _words(vals):
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                     for v in vals], np.uint32)


def _from_words(arr):
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in arr]


def _b0_fe(lib, op, xs, ys, k=0):
    a, b = _words(xs), _words(ys)
    r = np.zeros_like(a)
    z = np.zeros(len(xs), np.uint32)
    lib.b0_fe(op, a.ctypes.data, b.ctypes.data, k, r.ctypes.data,
              z.ctypes.data, len(xs))
    return _from_words(r), z.tolist()


def _b0_jp(lib, op, a_pts, b_pts):
    """(x, y, z, inf) int tuples -> the harness's results, same form."""
    def pack(pts):
        return np.array([np.append(_words([x, y, z]).ravel(), inf)
                         for x, y, z, inf in pts], np.uint32)
    a, b = pack(a_pts), pack(b_pts)
    r = np.zeros_like(a)
    lib.b0_jp(op, a.ctypes.data, b.ctypes.data, r.ctypes.data, len(a_pts))
    return [tuple(_from_words(row[8 * j:8 * j + 8].reshape(1, 8))[0]
                  for j in range(3)) + (int(row[24]),) for row in r]


def _check_b0_field(lib):
    """fe_mul / fe_sqr / add / sub / neg / half / mul_int / canon /
    is_zero of the portable branch against Python ints, on weak operands
    (p <= x < 2^256), zero and the words where the folds carry."""
    rng = np.random.default_rng(7)
    edge = [0, 1, 2, 977, 2 ** 32 + 977, P - 1, P, P + 1, P + 2 ** 32,
            2 ** 256 - 1, 2 ** 256 - 2, 2 ** 256 - 2 ** 32 - 978, 2 ** 255,
            2 ** 224 - 1, 0xFFFFFFFF, 2 ** 128 + 1,
            # words where 3 * a carries out of every word
            int("55555555FFFFFFFF" * 4, 16), 0x55555555FFFFFFFF << 192]
    xs = [a for a in edge for _ in edge] + rand(rng, 2 ** 256, 300)
    ys = [b for _ in edge for b in edge] + rand(rng, 2 ** 256, 300)
    want = {0: lambda a, b: a * b, 1: lambda a, b: a * a,
            2: lambda a, b: a + b, 3: lambda a, b: a - b,
            4: lambda a, b: -a}
    for op, f in want.items():
        got, _ = _b0_fe(lib, op, xs, ys)
        for a, b, r in zip(xs, ys, got):
            assert r % P == f(a, b) % P, (op, hex(a), hex(b))
    got, zero = _b0_fe(lib, 4, xs, ys)
    assert all(r <= P for r in got)                 # neg: in [0, p]
    assert zero == [int(a % P == 0) for a in xs]
    got, _ = _b0_fe(lib, 5, xs, ys)
    assert all((2 * r - a) % P == 0 for a, r in zip(xs, got))
    for k in (2, 3, 8):
        got, _ = _b0_fe(lib, 6, xs, ys, k)
        assert all(r % P == a * k % P for a, r in zip(xs, got)), k
    got, _ = _b0_fe(lib, 7, xs, ys)
    assert got == [a % P for a in xs]


def _check_b0_group(lib):
    """jp_double / jp_add_aff / jp_add of the portable branch: the points
    against hostcurve, every coordinate (canonical) against the plain
    PyTorch formulas of ops/cuda_group.py, on generic sums, P + P,
    P + (-P) and infinity operands; the pair doubling's two threads
    (jp_double_half, jp_double_join) against jp_double's residues."""
    rng = np.random.default_rng(11)
    ks = rand(rng, N, 12)
    A = [hc.mul(k) for k in ks]
    Bq = [hc.mul(k) for k in rand(rng, N, 12)]
    zs = [z or 1 for z in rand(rng, P, 24)]

    def jac(pt, z, inf=0):
        if pt is None:
            return (0, 1, 1, 1)
        x, y = pt
        return (x * z * z % P, y * z ** 3 % P, z, inf)

    def aff(pt):
        x, y, z, inf = pt
        if inf:
            return None
        zi = pow(z, -1, P)
        return (x * zi * zi % P, y * zi ** 3 % P)

    n = len(A)
    a_pts = [jac(A[i], zs[i]) for i in range(n)]
    # b: generic, = a (doubling), = -a (infinity), infinite; a infinite
    # (lane 9), both (lane 11)
    b_pts = ([jac(Bq[i], zs[n + i]) for i in range(4)]
             + [jac(A[i], zs[n + i]) for i in range(4, 7)]
             + [jac(hc.neg(A[i]), zs[n + i]) for i in range(7, 10)]
             + [(0, 1, 1, 1)] * 2)
    a_pts[9] = a_pts[11] = (0, 1, 1, 1)
    want_b = [aff(b) for b in b_pts]
    aff_b = [(b[0], b[1], 1, 0) if b else (0, 1, 1, 1) for b in want_b]

    def plain(op, a, b):
        def jp(pts):
            cols = list(zip(*pts))
            return TG.JP(*(TG.FE(torch.from_numpy(rows_np(list(c))
                                                  .astype(np.int64)),
                                 TG.MASK16) for c in cols[:3]),
                         torch.tensor([bool(i) for i in cols[3]]))
        pa, pb = jp(a), jp(b)
        if op == 0:
            r = TG.jp_double(pa)
        elif op == 1:
            r = TG.jp_add_aff(pa, pb.x, pb.y, pb.inf)
        else:
            r = TG.jp_add(pa, pb)
        cs = [ints(TG._canon32(c).to(torch.int64)) for c in (r.x, r.y, r.z)]
        return list(zip(*cs, r.inf.to(torch.int64).tolist()))

    for op, bs, want in ((0, a_pts, [None if aff(a) is None else
                                     hc.add(aff(a), aff(a)) for a in a_pts]),
                         (1, aff_b, [hc.add(aff(a), b)
                                     for a, b in zip(a_pts, want_b)]),
                         (2, b_pts, [hc.add(aff(a), b)
                                     for a, b in zip(a_pts, want_b)])):
        got = _b0_jp(lib, op, a_pts, bs)
        assert [aff(g) for g in got] == want, op
        canon = [(x % P, y % P, z % P, inf) for x, y, z, inf in got]
        assert canon == plain(op, a_pts, bs), op
        if op == 0:
            # the pair doubling: both threads' results, the same residues
            for half in (3, 4):
                pair = _b0_jp(lib, half, a_pts, a_pts)
                assert [(x % P, y % P, z % P, inf)
                        for x, y, z, inf in pair] == canon, half


def _check_b0_comb(lib):
    """The comb's T-thread sum (csrc/comb.cuh, joined by fixedbase.cu's
    tree) with T = 1, 2, 4 and 8, scanning and gathering: every lane's
    point equals k*G (hostcurve), an all-zero scalar gives infinity with
    z = 0, and with T = 1 the words equal the plain version's (which adds
    the rows in the same order).  Scalars with zero digit rows leave some
    team threads' partial sums at infinity."""
    rng = np.random.default_rng(12)
    ks = rand(rng, N, 6) + [0, 1, N - 1, 2 ** 255, 5, 2 ** 7 * 65 + 64,
                            2 ** 140 + 3]
    gd = TS.recode_w7_256(torch.from_numpy(
        rows_np(ks).astype(np.int64))).to(I32)
    assert (gd[:30] == 0).all(0).any()          # lanes with zero rows
    digs = np.ascontiguousarray(gd.numpy().astype(np.uint32))
    table = np.ascontiguousarray(
        TGEN._comb_words("cpu").numpy().view(np.uint32))
    rx, ry, rz = (ints(c) for c in TGEN.fixedbase_digits_ref(gd))
    for mode in (0, 1):                         # COMB_SCAN, COMB_GATHER
        for team in (1, 2, 4, 8):
            out = np.zeros((len(ks), 25), np.uint32)
            lib.b0_comb(digs.ctypes.data, table.ctypes.data, len(ks), team,
                        mode, out.ctypes.data)
            for j, k in enumerate(ks):
                x, y, z = (_from_words(out[j:j + 1, 8 * c:8 * c + 8])[0]
                           for c in range(3))
                if k % N == 0:
                    assert out[j, 24] == 1 and z == 0, (mode, team, j)
                    continue
                zi = pow(z, -1, P)
                assert out[j, 24] == 0
                assert (x * zi * zi % P, y * zi ** 3 % P) == hc.mul(k), \
                    (mode, team, j)
                if team == 1:
                    assert (x, y, z) == (rx[j], ry[j], rz[j]), (mode, j)


def _check_b0_msm_table(lib):
    """msm_table.cu's lane (csrc/msm.cuh: the chain's X, Y and z-ratios in
    the word-major scratch, the lane's inverse of its last Z, the backward
    pass stepping 1 / z_d by the ratios): every entry d*P against
    hostcurve and every word against the plain version, with an infinite
    lane (G's table) and a point off the curve, (0, 0), whose Z is 0 (its
    entries all zero)."""
    rng = np.random.default_rng(13)
    pts = [hc.mul(k or 1) for k in rand(rng, N, 5)] + [hc.mul(7), (0, 0)]
    pinf = [False] * 5 + [True, False]
    n = len(pts)
    px = np.ascontiguousarray(rows_np([p[0] for p in pts]))
    py = np.ascontiguousarray(rows_np([p[1] for p in pts]))
    inf = np.array(pinf, np.uint32)
    tab = np.zeros((n, TM.NENT, 16), np.uint32)
    scratch = np.zeros((TM.TABLE_SCRATCH_ROWS, n), np.uint32)
    lib.b0_msm_table(px.ctypes.data, py.ctypes.data, inf.ctypes.data, n,
                     tab.ctypes.data, scratch.ctypes.data)
    want = TM.msm_table_ref(trows32([p[0] for p in pts]),
                            trows32([p[1] for p in pts]),
                            torch.tensor(pinf))
    assert (tab.view(np.int32) == want.numpy()).all()
    for j, (pt, pi) in enumerate(zip(pts[:6], pinf)):
        base = hc.G if pi else pt
        for d in range(1, TM.NENT + 1):
            x, y = _from_words(tab[j, d - 1].reshape(2, 8))
            assert (x, y) == hc.mul(d, base), (j, d)
    assert not tab[6].any()


def _jac_lanes(rng, pts):
    """Affine points (None = infinity) -> limb-major x, y, z [16, B] uint32
    of jacobian representatives with random Z, and the flags."""
    zs = [z or 1 for z in rand(rng, P, len(pts))]
    cols = [(0, 1, 1) if p is None else
            (p[0] * z * z % P, p[1] * pow(z, 3, P) % P, z)
            for p, z in zip(pts, zs)]
    x, y, z = (np.ascontiguousarray(rows_np([c[k] for c in cols]))
               for k in range(3))
    return x, y, z, np.array([p is None for p in pts], np.uint32)


def _run_of(rng, n):
    """n points P, P + Q, P + 2Q, ... (one host add each)."""
    p, q = hc.mul(rand(rng, N, 1)[0]), hc.mul(rand(rng, N, 1)[0])
    out = []
    for _ in range(n):
        out.append(p)
        p = hc.add(p, q)
    return out


def _b0_point(out):
    """The harness's 25 result words -> affine ints or None."""
    if out[24]:
        return None
    x, y, z = (_from_words(out[8 * c:8 * c + 8].reshape(1, 8))[0]
               for c in range(3))
    zi = pow(z, -1, P)
    return x * zi * zi % P, y * zi ** 3 % P


def _check_b0_msm_finish(lib):
    """msm_finish.cu's block (csrc/msm.cuh's finish_fold and
    finish_ladder, group.cuh's trees written out in the harness) against
    sum_w 16^w S_w by hostcurve on 64 and 32 windows of 16, 33 and 1
    partials, on all-infinite partials, and with a window whose partials
    cancel (P, -P) and one where a thread's fold meets P + P; its words
    against the plain version's (which runs the kernel's order) on two
    of the sets."""
    rng = np.random.default_rng(14)
    sets = []
    for nwin, nblk in ((64, 16), (32, 33), (64, 1), (32, 1)):
        pts = _run_of(rng, nwin * nblk)
        pts = [None if i % 9 == 4 else p for i, p in enumerate(pts)]
        sets.append((nwin, nblk, pts))
    pts = list(sets[1][2])
    team = TM.finish_team(32)
    # window 5: P and -P and nothing else; window 7: P + P in one fold
    pts[5 * 33:6 * 33] = [pts[0], hc.neg(pts[0])] + [None] * 31
    pts[7 * 33 + team] = pts[7 * 33] = pts[1]
    sets.append((32, 33, pts))
    sets.append((64, 16, [None] * (64 * 16)))
    for k, (nwin, nblk, pts) in enumerate(sets):
        x, y, z, inf = _jac_lanes(rng, pts)
        out = np.zeros(25, np.uint32)
        lib.b0_msm_finish(x.ctypes.data, y.ctypes.data, z.ctypes.data,
                          inf.ctypes.data, nwin, nblk, out.ctypes.data)
        want = None
        for w in reversed(range(nwin)):
            for _ in range(4):
                want = hc.add(want, want)
            for p in pts[w * nblk:(w + 1) * nblk]:
                want = hc.add(want, p)
        assert _b0_point(out) == want, (nwin, nblk, k)
        if k in (2, 4):
            ref = TM.msm_finish_ref(*(torch.from_numpy(a.astype(np.int32))
                                      for a in (x, y, z)),
                                    torch.from_numpy(inf != 0), nwin)
            words = [ints(c)[0] for c in ref[:3]] + [int(ref[3][0])]
            assert words == _from_words(out[:24].reshape(3, 8)) \
                + [int(out[24])], k


def _check_b0_gej_sum(lib):
    """gej_add.cu's gej_sum (group.cuh's fold and trees, the blocks'
    sums through the scratch and the last block's sum, written out in the
    harness) against hostcurve on B = 1, 2, 3, 65 and 1,000 lanes with
    infinite lanes, a P + P pair and a cancelling pair, in the blocks the
    wrapper picks (cuda_group.sum_blocks) on 132, 2 and 1 SMs: 4, 2 and 1
    blocks at 1,000 lanes, one lane or more a thread."""
    rng = np.random.default_rng(15)
    run = _run_of(rng, 1000)
    p, q = run[0], run[1]
    cases = [[p], [None], [p, p], [p, hc.neg(p)], [p, p, None]]
    for n in (65, 1000):
        pts = [None if i % 7 == 6 else v for i, v in enumerate(run[:n])]
        pts[:4] = [p, p, q, hc.neg(q)]
        cases.append(pts)
    for pts in cases:
        want = None
        for v in pts:
            want = hc.add(want, v)
        x, y, z, inf = _jac_lanes(rng, pts)
        for sms in (132, 2, 1):
            nb = TG.sum_blocks(len(pts), sms)
            out = np.zeros(25, np.uint32)
            lib.b0_gej_sum(x.ctypes.data, y.ctypes.data, z.ctypes.data,
                           inf.ctypes.data, len(pts), nb, TG.SUM_THREADS,
                           out.ctypes.data)
            assert _b0_point(out) == want, (len(pts), sms)


def _be_bytes(words):
    """uint32 digest words -> the digest bytes."""
    return np.asarray(words, np.uint32).astype(">u4").tobytes()


def _check_b0_sha_msg(lib):
    """sha256.cu's sha256_msg (staging by the block's threads, padding in
    the kernel, chunks of 256 bytes) against hashlib, oracle.tagged_hash
    and the port's plain version, on messages of 0 to 300 bytes: from the
    IV and from a tag's midstate, by whole words and by bytes, and from a
    state a lane (an HMAC's inner hash); 7 lanes in blocks of 4 threads."""
    rng = np.random.default_rng(16)
    tag = "BIP0340/challenge"
    mid = TH.tag_midstate(tag)
    B, T = 7, 4
    for L in (0, 1, 32, 55, 56, 63, 64, 97, 128, 256, 300):
        msg = rng.integers(0, 256, (B, L), dtype=np.uint8)
        for start, consumed in ((TC.IV, 0), (mid, 64)):
            bits = (consumed + L) * 8
            st0 = np.asarray(start, np.uint32)
            plain = TC.sha256_msg_ref(torch.from_numpy(msg), start,
                                      consumed)
            for words in ((0, 1) if L % 4 == 0 else (0,)):
                out = np.zeros((B, 8), np.uint32)
                lib.b0_sha_msg(msg.ctypes.data, L, B, st0.ctypes.data, None,
                               bits >> 32, bits & 0xFFFFFFFF, T, words,
                               out.ctypes.data)
                for j in range(B):
                    want = (hashlib.sha256(bytes(msg[j])).digest()
                            if consumed == 0 else
                            oracle.tagged_hash(tag, bytes(msg[j])))
                    assert _be_bytes(out[j]) == want, (L, consumed, words)
                    assert bytes(plain[j].numpy()) == want
    # a state a lane, 97 bytes after it (RFC6979's first inner hash)
    lane = rng.integers(0, 2 ** 32, (B, 8), dtype=np.uint32)
    msg = rng.integers(0, 256, (B, 97), dtype=np.uint8)
    bits = (64 + 97) * 8
    out = np.zeros((B, 8), np.uint32)
    lib.b0_sha_msg(msg.ctypes.data, 97, B, None, lane.ctypes.data, 0, bits,
                   T, 0, out.ctypes.data)
    plain = TC.sha256_msg_ref(torch.from_numpy(msg), None, 64,
                              torch.from_numpy(lane.astype(np.int64)))
    assert [_be_bytes(o) for o in out] == [bytes(p.numpy()) for p in plain]
    blocks = TH._pad_bytes_to_blocks(torch.from_numpy(msg), 64)
    st = torch.from_numpy(lane.astype(np.int64))
    for i in range(2):
        st = TH.compress_plain(st, blocks[:, 16 * i:16 * (i + 1)])
    assert out.astype(np.int64).tolist() == st.tolist()


def _check_b0_rfc6979(lib):
    """rfc6979's lane (csrc/sha256.cuh) against oracle.rfc6979_nonce and
    the port's plain version, one to three candidates; keys 0, 1, n - 1
    and random ones, 6 lanes in blocks of 4 threads."""
    rng = np.random.default_rng(17)
    B = 6
    secs = [0, 1, N - 1] + [int.from_bytes(rng.bytes(32), "big") % N
                            for _ in range(B - 3)]
    sec = np.array([list(d.to_bytes(32, "big")) for d in secs], np.uint8)
    msg = rng.integers(0, 256, (B, 32), dtype=np.uint8)
    msg[1] = 0xFF
    kd = np.ascontiguousarray(np.concatenate([sec, msg], 1))
    k0 = np.asarray(TC.zero_key_states(), np.uint32)
    for rounds in (1, 2, 3):
        out = np.zeros((rounds, B, 8), np.uint32)
        lib.b0_rfc6979(kd.ctypes.data, B, k0.ctypes.data, rounds, 4,
                       out.ctypes.data)
        plain = TC.rfc6979_ref(torch.from_numpy(kd), rounds)
        assert out.astype(np.int64).tolist() == plain.tolist(), rounds
        for j in range(B):
            for c in range(rounds):
                assert _be_bytes(out[c, j]) == oracle.rfc6979_nonce(
                    bytes(sec[j]), bytes(msg[j]), counter=c), (j, c)


def _host_batch_root(px, msg, sig):
    nodes = [oracle.tagged_hash("BIP0340/batch/leaf",
                                bytes(p) + bytes(m) + bytes(s))
             for p, m, s in zip(px, msg, sig)]
    while len(nodes) > 1:
        if len(nodes) % 2:
            nodes.append(bytes(32))
        nodes = [oracle.tagged_hash("BIP0340/batch/node", a + b)
                 for a, b in zip(nodes[::2], nodes[1::2])]
    return nodes[0]


def _check_b0_batch_digest(lib):
    """batch_digest (a block's leaves and subtree, the last block's levels
    over the blocks' roots) against hashlib and the port's plain version:
    n = 1, 2, 3, 5, 255, 256, 257 and 1,061 in the kernel's blocks of 256
    threads, and n = 5, 17 and 33 in blocks of 4 (three to five levels
    over the roots, an odd count at every level)."""
    rng = np.random.default_rng(18)
    most = 1061
    px = rng.integers(0, 256, (most, 32), dtype=np.uint8)
    msg = rng.integers(0, 256, (most, 32), dtype=np.uint8)
    sig = rng.integers(0, 256, (most, 64), dtype=np.uint8)
    mids = np.asarray(TC._batch_midstates(), np.uint32)
    for n, T in ((1, TC.BD_THREADS), (2, TC.BD_THREADS), (3, TC.BD_THREADS),
                 (5, TC.BD_THREADS), (255, TC.BD_THREADS),
                 (256, TC.BD_THREADS), (257, TC.BD_THREADS),
                 (most, TC.BD_THREADS), (5, 4), (17, 4), (33, 4)):
        a, b, c = (np.ascontiguousarray(v[:n]) for v in (px, msg, sig))
        out = np.zeros(8, np.uint32)
        lib.b0_batch_digest(a.ctypes.data, b.ctypes.data, c.ctypes.data, n,
                            T, mids.ctypes.data, out.ctypes.data)
        want = _host_batch_root(a, b, c)
        assert _be_bytes(out) == want, (n, T)
        if T == TC.BD_THREADS:
            plain = TC.batch_digest_ref(*map(torch.from_numpy, (a, b, c)))
            assert bytes(plain.numpy()) == want, n


def _check_b0_lift_x(lib):
    """lift_x.cu's lane on the inlined sqrt chain against Python ints and
    the plain version: x with a square (curve points, G), without one,
    x >= p as given (p, p + 1, 2^256 - 1), 0; its parity select on y = 0,
    1, p - 1 and random canonical y."""
    rng = np.random.default_rng(19)
    xs = [hc.mul(k)[0] for k in rand(rng, N, 5)] + rand(rng, P, 6)
    xs += [0, 1, hc.GX, P - 1, P, P + 1, 2 ** 256 - 1]
    n = len(xs)
    x = rows_np(xs).astype(np.uint32)
    y = np.zeros_like(x)
    ok = np.zeros(n, np.uint32)
    lib.b0_lift_x(x.ctypes.data, y.ctypes.data, ok.ctypes.data, n)
    py, pok = TF.lift_x_ref(torch.from_numpy(x.astype(np.int64)))
    assert y.astype(np.int64).tolist() == py.tolist()
    assert ok.astype(bool).tolist() == pok.tolist()
    assert {bool(v) for v in ok} == {True, False}
    for j, v in enumerate(ints(y)):
        y2 = (xs[j] ** 3 + 7) % P
        r = pow(y2, (P + 1) // 4, P)
        assert v == (P - r if r & 1 else r) and bool(ok[j]) == (r * r % P
                                                               == y2)
    ys = [0, 1, 2, P - 1, P - 2] + rand(rng, P, 5)
    r = np.zeros((len(ys), 8), np.uint32)
    yw = _words(ys)
    lib.b0_even_root(yw.ctypes.data, r.ctypes.data, len(ys))
    assert _from_words(r) == [P - v if v & 1 else v for v in ys]


def _affine_edges(rng, B, K):
    """Jacobian lanes (x, y, z ints) for a launch of B lanes with K lanes a
    thread (S = ceil(B / K) threads; thread t holds t, t + S, ...): Z = 0
    at the first, a middle and the last slot of thread 0's group, thread
    2's whole group at Z = 0, Z = p and p + 1 in thread 3's, Y = 0 on lane
    5; the rest random, weak values (>= p) among them."""
    S = -(-B // K)
    xs, ys, zs = (rand(rng, 2 ** 256, B) for _ in range(3))
    for i in (0, K // 2, K - 1):
        zs[i * S] = 0
    for lane in range(2, B, S):
        zs[lane] = 0
    zs[3] = P
    zs[3 + S if 3 + S < B else 4] = P + 1
    ys[5] = 0
    zs[5] = zs[5] or 1
    return xs, ys, zs


def _check_b0_affine(lib):
    """affine_xy.cu's and affine_meta.cu's thread groups (affine.cuh) on
    every thread of a launch against Python ints (z^-1 by pow, x = X z^-2,
    y = Y z^-3, Euler's criterion for y) and the plain versions: K = 1, 2,
    3 and 8 lanes a thread on a ragged 29 lanes and K = 8 on 64, with the
    edges of _affine_edges; and modinv.cuh's Jacobi symbol on 0, 1, p - 1,
    200 random squares and 200 random non-squares."""
    rng = np.random.default_rng(20)
    for B, K in ((29, 1), (29, 2), (29, 3), (29, 8), (64, 8)):
        xs, ys, zs = _affine_edges(rng, B, K)
        x, y, z = (rows_np(v) for v in (xs, ys, zs))
        want_x, want_y, want_sq = [], [], []
        for X, Y, Z in zip(xs, ys, zs):
            zi = pow(Z % P, -1, P) if Z % P else 0
            ax, ay = X * zi * zi % P, Y * zi ** 3 % P
            want_x.append(ax)
            want_y.append(ay)
            want_sq.append(ay != 0 and pow(ay, (P - 1) // 2, P) == 1)
        assert {True, False} <= set(want_sq)
        ref = TF.affine_meta_ref(*(torch.from_numpy(a.astype(np.int64))
                                   for a in (x, y, z)))
        for meta in (0, 1):
            ax, ay = np.zeros_like(x), np.zeros_like(x)
            sq = np.zeros(B, np.uint32)
            undecided = lib.b0_affine(meta, x.ctypes.data, y.ctypes.data,
                                      z.ctypes.data, ax.ctypes.data,
                                      ay.ctypes.data, sq.ctypes.data, B, K)
            assert (ints(ax), ints(ay)) == (want_x, want_y), (B, K, meta)
            assert ax.astype(np.int64).tolist() == ref[0].tolist()
            assert ay.astype(np.int64).tolist() == ref[1].tolist()
            if meta:
                assert undecided == 0
                assert sq.astype(bool).tolist() == want_sq, (B, K)
                assert sq.astype(bool).tolist() == ref[2].tolist()
    plain_xy = TGEN.affine_xy_ref(*(torch.from_numpy(a.astype(np.int64))
                                    for a in (x, y, z)))
    assert [t.tolist() for t in plain_xy] == [ref[0].tolist(),
                                              ref[1].tolist()]
    roots = rand(rng, P, 400)
    squares = [r * r % P for r in roots[:200]]
    nonsq = [v for v in roots[200:] if pow(v, (P - 1) // 2, P) != 1]
    nonsq += [P - s for s in squares[:200 - len(nonsq)]]
    vals = [0, 1, P - 1] + squares + nonsq
    w, out = _words(vals), np.zeros(len(vals), np.int32)
    lib.b0_jacobi(w.ctypes.data, out.ctypes.data, len(vals))
    assert out.tolist() == [0, 1, -1] + [1] * 200 + [-1] * 200


# the batched-inverse kernels' launches: (B, K), ragged for every K > 1
BATCH_INV_LAUNCHES = ((29, 1), (29, 2), (29, 3), (29, 8), (64, 8))


def _group_lanes(B, K, thread, slots=None):
    """The lanes of ``thread``'s group (t, t + S, ... below B, S =
    ceil(B / K)): all of them, or those at ``slots`` (-1: the last)."""
    S = -(-B // K)
    lanes = list(range(thread, B, S))[:K]
    return lanes if slots is None else [lanes[i] for i in slots
                                        if i < len(lanes)]


def _decode_digits(rows, w):
    acc = 0
    for d in rows:
        acc = acc * (1 << w) + (-(d & 0xFF) if d >> 8 else d & 0xFF)
    return acc


def _check_b0_ecdsa_prep(lib):
    """ecdsa_prep.cu's thread groups (batch_inv.cuh over n) on every
    thread of a launch against Python ints (the digit rows decode to u1 =
    m / s and to u2 = r / s's GLV halves; s = 0 gives zero rows) and the
    plain version, at BATCH_INV_LAUNCHES: s = 0 at the first, a middle
    and the last slot of thread 0's group and on thread 2's whole group;
    s = 1 and n - 1; m = 0."""
    rng = np.random.default_rng(21)
    for B, K in BATCH_INV_LAUNCHES:
        m, r, s = (rand(rng, N, B) for _ in range(3))
        for lane in (_group_lanes(B, K, 0, (0, K // 2, -1))
                     + _group_lanes(B, K, 2)):
            s[lane] = 0
        s[1], s[3], s[5], m[4] = 1, N - 1, N - 1, 0
        mr, rr, sr = (rows_np(v) for v in (m, r, s))
        digs = np.zeros((52, B), np.uint32)
        gdigs = np.zeros((37, B), np.uint32)
        flags = np.zeros((2, B), np.uint32)
        lib.b0_ecdsa_prep(mr.ctypes.data, rr.ctypes.data, sr.ctypes.data,
                          digs.ctypes.data, gdigs.ctypes.data,
                          flags.ctypes.data, B, K)
        ref = TS.ecdsa_prep_ref(*(torch.from_numpy(a.astype(np.int64))
                                  for a in (mr, rr, sr)))
        for got, want in zip((digs, gdigs, flags), ref):
            assert got.astype(np.int64).tolist() == want.tolist(), (B, K)
        for j in range(B):
            si = pow(s[j], -1, N) if s[j] else 0
            h1 = _decode_digits(digs[:26, j].tolist(), 5)
            h2 = _decode_digits(digs[26:, j].tolist(), 5)
            h1, h2 = (-h if f else h for h, f in zip((h1, h2), flags[:, j]))
            assert _decode_digits(gdigs[:, j].tolist(), 7) == m[j] * si % N
            assert (h1 + TS.LAMBDA * h2) % N == r[j] * si % N, (B, K, j)
            if not s[j]:
                assert not digs[:, j].any() and not gdigs[:, j].any()


def _check_b0_ecdsa_finish(lib):
    """ecdsa_finish.cu's thread groups (batch_inv.cuh: Z over p and k over
    n in one pass) on every thread of a launch against Python ints (r = x
    mod n with the overflow, s = k^-1 (m + r d) low-S, recid, ok) and the
    plain version, at BATCH_INV_LAUNCHES: Z = 0 at the first, a middle and
    the last slot of thread 0's group and on thread 2's whole group, Z =
    p and p + 1; k = 0 at thread 1's three slots and on the last thread's
    whole group; an affine x in [n, p) (r's overflow: recid bit 1); m =
    0; high-S and low-S lanes; the rest random."""
    rng = np.random.default_rng(22)
    _, (bx, by) = _point_with_x_at_least_n()
    for B, K in BATCH_INV_LAUNCHES:
        S = -(-B // K)
        ax, ay = rand(rng, P, B), rand(rng, P, B)
        ax[5], ay[5] = bx, by
        zs = [z or 1 for z in rand(rng, P, B)]
        xs = [a * z * z % P for a, z in zip(ax, zs)]
        ys = [a * pow(z, 3, P) % P for a, z in zip(ay, zs)]
        for lane in (_group_lanes(B, K, 0, (0, K // 2, -1))
                     + _group_lanes(B, K, 2)):
            zs[lane] = 0
        zs[3] = P
        zs[3 + S if 3 + S < B else 4] = P + 1
        k, m, d = (rand(rng, N, B) for _ in range(3))
        for lane in (_group_lanes(B, K, 1, (0, K // 2, -1))
                     + _group_lanes(B, K, S - 1)):
            k[lane] = 0
        m[6] = 0
        ins = [rows_np(v) for v in (xs, ys, zs, k, m, d)]
        r = np.zeros((16, B), np.uint32)
        s = np.zeros((16, B), np.uint32)
        meta = np.zeros((2, B), np.uint32)
        lib.b0_ecdsa_finish(*(a.ctypes.data for a in ins), r.ctypes.data,
                            s.ctypes.data, meta.ctypes.data, B, K)
        ref = TGEN.ecdsa_sign_finish_ref(
            *(torch.from_numpy(a.astype(np.int64)) for a in ins))
        assert r.astype(np.int64).tolist() == ref[0].tolist(), (B, K)
        assert s.astype(np.int64).tolist() == ref[1].tolist(), (B, K)
        assert meta[0].astype(np.int64).tolist() == ref[2].tolist()
        assert meta[1].astype(bool).tolist() == ref[3].tolist()
        highs = set()
        for j in range(B):
            zi = pow(zs[j] % P, -1, P) if zs[j] % P else 0
            x, y = xs[j] * zi * zi % P, ys[j] * zi ** 3 % P
            ovf = x >= N
            rv = x - N if ovf else x
            sv = (pow(k[j], -1, N) if k[j] else 0) * (m[j] + rv * d[j]) % N
            high = sv > (N - 1) // 2
            sv = N - sv if high else sv
            want = (rv, sv, ((2 * ovf) | (y & 1)) ^ high, rv != 0 and sv != 0)
            got = (ints(r[:, j:j + 1])[0], ints(s[:, j:j + 1])[0],
                   int(meta[0, j]), bool(meta[1, j]))
            assert got == want, (B, K, j)
            if want[3]:
                highs.add(high)
        assert meta[0, 5] >> 1 == 1 and highs == {True, False}, (B, K)


def test_cuda_constants_header(tmp_path):
    """csrc/consts.cuh carries the same curve constants as the Python
    modules and the JAX package; and the B0 field and group core of
    csrc/fe.cuh and group.cuh, built as plain C++ with g++, gives the
    right residues and points.  That checks the portable branch of the
    carry-chain primitives (csrc/common.cuh) and the chains built on them,
    and with them the comb's T-thread sum (csrc/comb.cuh), msm_table's
    lane (csrc/msm.cuh), msm_finish's block and gej_sum's blocks (the
    folds and trees of csrc/group.cuh), the SHA-256 kernels' staging,
    padding, RFC6979 lane and batch tree (csrc/sha256.cuh), lift_x's
    lane on the inlined sqrt chain, the affine conversions' thread groups
    with their batched inverse and Jacobi symbol (csrc/affine.cuh,
    modinv.cuh), and the thread groups of ECDSA's verify prep and sign
    finish on the batched inverse over p and n (csrc/batch_inv.cuh); the
    PTX forms are held against the plain PyTorch versions on the card by
    chip_smoke.py."""
    lib = _b0_harness(tmp_path)
    _check_b0_field(lib)
    _check_b0_group(lib)
    _check_b0_comb(lib)
    _check_b0_msm_table(lib)
    _check_b0_msm_finish(lib)
    _check_b0_gej_sum(lib)
    _check_b0_sha_msg(lib)
    _check_b0_rfc6979(lib)
    _check_b0_batch_digest(lib)
    _check_b0_lift_x(lib)
    _check_b0_affine(lib)
    _check_b0_ecdsa_prep(lib)
    _check_b0_ecdsa_finish(lib)
    text = (Path(_build.SRC_DIR) / "consts.cuh").read_text()

    def words(name):
        body = re.search(rf"#define SECP_{name}_WORDS \{{([^}}]*)\}}",
                         text).group(1)
        ws = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
        return sum(w << (32 * i) for i, w in enumerate(ws))

    want = {"P": P, "N": N, "RED_N": 2 ** 256 - N, "N_HALF": (N - 1) // 2,
            "LAMBDA": JPS.LAMBDA, "MINUS_B1": JPS._MINUS_B1,
            "MINUS_B2": JPS._MINUS_B2, "G1": JPS._G1, "G2": JPS._G2,
            "BETA": JPG._BETA, "GX": hc.GX, "GY": hc.GY, "P_MINUS_N": P - N}
    for name, val in want.items():
        assert words(name) == val, name
    assert (TS.LAMBDA, TS._G1, TS._G2, TS._MINUS_B1, TS._MINUS_B2) == (
        JPS.LAMBDA, JPS._G1, JPS._G2, JPS._MINUS_B1, JPS._MINUS_B2)
    assert TG._BETA == JPG._BETA
    for tag, mod in (("P", P), ("N", N)):
        body = re.search(rf"#define SECP_MODINV_{tag}_LIMBS \{{([^}}]*)\}}",
                         text).group(1)
        limbs = [int(w, 16) for w in body.split(",")]
        assert sum(l << (30 * i) for i, l in enumerate(limbs)) == mod
        inv = int(re.search(rf"#define SECP_MODINV_{tag}_INV30 (\w+)u",
                            text).group(1), 16)
        assert inv * mod % 2 ** 30 == 1


def test_wrappers_refuse_what_the_kernels_do_not_take():
    good = torch.zeros((16, 4), dtype=I32)
    for bad, msg in ((good, "CUDA"), (None, "CUDA")):
        with pytest.raises(ValueError, match=msg):
            _build.check_rows(bad, 16, "x")
    # the sources a build would compile are all there, and keyed by content
    names = {p.name for p in _build.sources()}
    assert {"mulmod_chain.cu", "ecdsa_prep.cu", "fixedbase.cu",
            "ecmult_glv.cu", "fe.cuh", "sc.cuh", "modinv.cuh",
            "group.cuh"} <= names
    assert re.fullmatch(r"[0-9a-f]{16}", _build.source_hash())
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
