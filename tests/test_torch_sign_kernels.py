"""The sign-path kernels of the port, each as a whole, on the CPU: the
plain version beside each kernel wrapper against the JAX kernel body and
against Python integers, and the hashes the sign paths stand on.

* ``ecdsa_sign_finish`` (B7), ``affine_xy`` (B8), ``muladd_n`` (B9): the
  JAX kernel bodies ``_ecdsa_finish_kernel``, ``_affine_xy_kernel`` and
  ``_muladd_n_kernel`` themselves, run op by op under
  ``jax.disable_jit()`` with numpy arrays as their refs, and Python
  integers — on random points with random Z, an infinity lane (Z = 0), a
  weak Z >= p, points with x = n (r = 0) and x = n + 2 (the r-overflow
  flag), high-S lanes, d = 0 and k = 0.
* ``ecmult_gen`` blinded (the comb kernel's blinded tail): against k*G in
  Python integers, on the lane k = n - b too (k + b = 0: all digits zero,
  the result is -b*G itself), with the blind of the JAX package's
  ``Context.randomize`` carried across by ``convert.blind_from_jax``.
* ``hmac_sha256``, ``hmac_sha256_bytes`` and ``RFC6979`` against the JAX
  package's ``ops/sha256.py`` and ``oracle.hmac_sha256`` /
  ``oracle.rfc6979_nonce``; the ``rfc6979`` kernel's plain version (and
  the entries that reach it on the CPU, ``ecdsa.rfc6979_nonce_ref``) on
  seckey || msg bytes against the JAX ``RFC6979`` run under
  ``jax.disable_jit()``, one to three candidates.

Tolerance: 0 (integers, limbs, bytes).  On CPU tensors every wrapper takes
its plain version; the launch counters must not move.  The C entry points
of the new kernels are held against their ``ctypes`` signatures in
test_torch_schnorr_kernels.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

import oracle
from secp256k1_zkp_tpu import context as jcontext
from secp256k1_zkp_tpu.ops import pallas_gen as JGEN
from secp256k1_zkp_tpu.ops import sha256 as JH
from secp256k1_zkp_tpu_torch.ops import _build
from secp256k1_zkp_tpu_torch.modules import ecdsa
from secp256k1_zkp_tpu_torch.ops import cuda_gen as TGEN
from secp256k1_zkp_tpu_torch.ops import cuda_sha256 as TC
from secp256k1_zkp_tpu_torch.ops import sha256 as TH
from secp256k1_zkp_tpu_torch.utils import convert
from secp256k1_zkp_tpu_torch.utils import hostcurve as hc

from test_torch_kernels import trows32
from test_torch_ops import ints, rand, rows_np

P, N = hc.P, hc.N


def _curve_x_from(x0):
    """The first curve point with x >= x0 (x^3 + 7 a square)."""
    x = x0
    while True:
        y = pow((x ** 3 + 7) % P, (P + 1) // 4, P)
        if y * y % P == (x ** 3 + 7) % P:
            return x, y
        x += 1


def _sign_lanes():
    """Jacobian points with their scalars: (X, Y, Z, k, m, d, affine or
    None for infinity)."""
    rng = np.random.default_rng(70)
    pts = [hc.mul(k) for k in rand(rng, N, 6)]
    pts += [_curve_x_from(N), _curve_x_from(N + 1)]   # x = n, x = n + 2
    assert pts[-2][0] == N and pts[-1][0] == N + 2
    zs = [z or 1 for z in rand(rng, P, len(pts))]
    X = [p[0] * z * z % P for p, z in zip(pts, zs)]
    Y = [p[1] * pow(z, 3, P) % P for p, z in zip(pts, zs)]
    Z = zs
    X.append(0); Y.append(1); Z.append(0); pts.append(None)   # infinity
    X.append(pts[0][0]); Y.append(pts[0][1]); Z.append(1 + P)  # weak Z = 1
    pts.append(pts[0])
    lanes = len(X)
    k = rand(rng, N, lanes)
    m = rand(rng, N, lanes)
    d = rand(rng, N, lanes)
    d[1] = 0
    return X, Y, Z, k, m, d, pts


def test_sign_epilogues_vs_jax_bodies_and_ints():
    X, Y, Z, k, m, d, pts = _sign_lanes()
    L = len(X)
    before = dict(_build.LAUNCH_COUNTS)

    # B8: affine_xy
    ax, ay = TGEN.affine_xy(*(trows32(v) for v in (X, Y, Z)))
    assert ax.dtype == torch.int32 and ax.shape == (16, L)
    want = [(0, 0) if pt is None else pt for pt in pts]
    assert list(zip(ints(ax), ints(ay))) == want
    jax_, jay = np.zeros((16, L), np.uint32), np.zeros((16, L), np.uint32)
    with jax.disable_jit():
        JGEN._affine_xy_kernel(rows_np(X), rows_np(Y), rows_np(Z), jax_, jay)
    assert ints(ax) == ints(jax_) and ints(ay) == ints(jay)

    # B7: ecdsa_sign_finish
    r, s, recid, ok = TGEN.ecdsa_sign_finish(
        *(trows32(v) for v in (X, Y, Z, k, m, d)))
    assert r.shape == s.shape == (16, L) and recid.dtype == torch.int32
    assert ok.dtype == torch.bool and ok.shape == recid.shape == (L,)
    jr, js = np.zeros((16, L), np.uint32), np.zeros((16, L), np.uint32)
    jmeta = np.zeros((2, L), np.uint32)
    with jax.disable_jit():
        JGEN._ecdsa_finish_kernel(*(rows_np(v) for v in (X, Y, Z, k, m, d)),
                                  jr, js, jmeta)
    assert ints(r) == ints(jr) and ints(s) == ints(js)
    assert recid.tolist() == jmeta[0].astype(np.int64).tolist()
    assert ok.tolist() == (jmeta[1] != 0).tolist()
    highs = ovfs = 0
    for j, (xa, ya) in enumerate(want):
        rr = xa % N
        ss = pow(k[j], -1, N) * (m[j] + rr * d[j]) % N
        high = ss > N // 2
        ss = N - ss if high else ss
        highs += high
        ovfs += xa >= N
        assert (ints(r)[j], ints(s)[j]) == (rr, ss)
        assert recid[j] == ((2 if xa >= N else 0) | (ya & 1)) ^ high
        assert bool(ok[j]) == (rr != 0 and ss != 0)
    assert highs and L - highs and ovfs == 2       # both kinds, both flags
    assert ok.tolist().count(False) == 2           # r = 0: x = n, infinity

    # B9: muladd_n
    neg = [j % 2 == 0 for j in range(L)]
    kk = list(k)
    kk[2] = 0
    sm = TGEN.muladd_n(trows32(kk), trows32(m), trows32(d),
                       torch.tensor(neg))
    assert sm.dtype == torch.int32 and sm.shape == (16, L)
    assert ints(sm) == [(((N - a) % N if f else a) + b * c) % N
                        for a, b, c, f in zip(kk, m, d, neg)]
    jsm = np.zeros((16, L), np.uint32)
    with jax.disable_jit():
        JGEN._muladd_n_kernel(rows_np(kk), rows_np(m), rows_np(d),
                              np.array([neg], np.uint32), jsm)
    assert ints(sm) == ints(jsm)
    assert _build.LAUNCH_COUNTS == before


def test_blinded_ecmult_gen_vs_ints():
    # the JAX package's blinding state for a seed (its Context.randomize,
    # run on a bare object: no generator table is built), carried across
    jblind = jcontext.Context.randomize(types.SimpleNamespace(),
                                        b"\x42" * 32).blind
    blind = convert.blind_from_jax(jblind)
    assert convert.blind_from_jax(None) is None
    assert blind.b == sum(int(c) << (16 * i) for i, c in enumerate(jblind[0]))
    assert (blind.gbx, blind.gby) == hc.mul(N - blind.b)
    rng = np.random.default_rng(71)
    ks = rand(rng, N, 4) + [N - blind.b, 1, N - 1, 0]
    before = dict(_build.LAUNCH_COUNTS)
    x, y, z = TGEN.ecmult_gen(trows32(ks), blind)
    x0, y0, z0 = TGEN.ecmult_gen(trows32(ks))
    assert _build.LAUNCH_COUNTS == before
    assert x.dtype == torch.int32 and x.shape == (16, len(ks))
    for j, kv in enumerate(ks):
        want = hc.mul(kv)
        for xs, ys, zs in ((x, y, z), (x0, y0, z0)):
            zv = ints(zs)[j]
            if want is None:
                assert zv == 0                      # z = 0: infinity
                continue
            zi = pow(zv, -1, P)
            assert (ints(xs)[j] * zi * zi % P,
                    ints(ys)[j] * zi ** 3 % P) == want
    # on k = n - b the comb sums nothing and the tail adds -b*G = k*G in
    # affine form: z = 1
    assert ints(z)[4] == 1 and (ints(x)[4], ints(y)[4]) == hc.mul(ks[4])


def test_hmac_and_rfc6979_vs_jax_and_oracle():
    rng = np.random.default_rng(72)
    B = 5
    keys = rng.integers(0, 2 ** 32, (B, 8), dtype=np.uint32)
    keys[0] = 0
    msgs = rng.integers(0, 2 ** 32, (B, 8), dtype=np.uint32)
    kt = torch.from_numpy(keys.astype(np.int64))
    key_b = [keys[j].astype(">u4").tobytes() for j in range(B)]
    got = TH.hmac_sha256(kt, torch.from_numpy(msgs.astype(np.int64)))
    want = np.asarray(JH.hmac_sha256(jnp.asarray(keys), jnp.asarray(msgs)))
    assert got.tolist() == want.astype(np.int64).tolist()
    for j in range(B):
        assert bytes(TH.words_to_bytes32(got[j]).tolist()) == \
            oracle.hmac_sha256(key_b[j], msgs[j].astype(">u4").tobytes())
    # byte messages of every padding case: one block, the length field
    # spilling into a second block, two and three blocks, unaligned
    for L in (1, 33, 55, 56, 64, 97, 119, 120):
        mb = rng.integers(0, 256, (B, L), dtype=np.uint8)
        got = TH.hmac_sha256_bytes(kt, torch.from_numpy(mb))
        want = np.asarray(JH.hmac_sha256_bytes(jnp.asarray(keys),
                                               jnp.asarray(mb)))
        assert got.tolist() == want.astype(np.int64).tolist(), L
        assert bytes(TH.words_to_bytes32(got[1]).tolist()) == \
            oracle.hmac_sha256(key_b[1], bytes(mb[1]))
    # RFC6979: the key material of ECDSA signing (seckey || msg), two
    # candidates
    sec = rng.integers(0, 256, (B, 32), dtype=np.uint8)
    msg = rng.integers(0, 256, (B, 32), dtype=np.uint8)
    kb = np.concatenate([sec, msg], -1)
    kw = TH.bytes32_to_words(torch.from_numpy(kb).reshape(B, 2, 32)) \
        .reshape(B, 16)
    drbg = TH.RFC6979(kw)
    outs = [drbg.generate32() for _ in range(2)]
    jd = JH.RFC6979(jnp.asarray(kw.numpy().astype(np.uint32)))
    for o in outs:
        assert o.tolist() == np.asarray(jd.generate32()).astype(
            np.int64).tolist()
    for j in range(B):
        for c, o in enumerate(outs):
            assert bytes(TH.words_to_bytes32(o[j]).tolist()) == \
                oracle.rfc6979_nonce(bytes(sec[j]), bytes(msg[j]), counter=c)
    # the rfc6979 kernel's plain version and the entries on it: seckey ||
    # msg bytes in, the same candidates (the JAX DRBG eagerly)
    kd_t = torch.from_numpy(np.ascontiguousarray(kb))
    with jax.disable_jit():
        jd = JH.RFC6979(jnp.asarray(kw.numpy().astype(np.uint32)))
        jouts = [np.asarray(jd.generate32()).astype(np.int64).tolist()
                 for _ in range(3)]
    for rounds in (1, 2, 3):
        for got in (TC.rfc6979_ref(kd_t, rounds), TH.rfc6979(kd_t, rounds),
                    TC.rfc6979(kd_t, rounds)):
            assert got.shape == (rounds, B, 8)
            assert got.tolist() == jouts[:rounds]
    assert ecdsa.rfc6979_nonce_ref(torch.from_numpy(msg),
                                   torch.from_numpy(sec)).tolist() == \
        jouts[:2]
