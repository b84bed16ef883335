"""The Schnorr-verify kernels of the port, each as a whole, on the CPU: the
plain version beside each kernel wrapper against the JAX kernel body and
against Python integers.

* ``glv_only`` (B5): the JAX kernel body ``_glv_only_kernel`` itself, run
  op by op under ``jax.disable_jit()`` with numpy arrays as its refs, and
  the digit rows decoded back to k with Python integers.
* ``lift_x`` (B4) and its sqrt chain: against ``pow`` and
  ``oracle.lift_x_even_y``, on residues, non-residues and x >= p.  The
  JAX body (64 windows of eager limb multiplies, ~70 s on one CPU core)
  is not run; its value is the one ``pow`` gives, and the module-level
  ``lift_x`` is held against the JAX package's in test_torch_schnorr.py.
* ``schnorr_check`` (B6): the JAX kernel body ``_schnorr_check_kernel``
  under ``jax.disable_jit()``, and Python integers, on valid, odd-y,
  wrong-r and infinity lanes.
* ``gen_digits`` (glue) against the JAX function, and the composition
  glv_only(-e) + comb(s) + ``ecmult_glv`` with ``rx=None`` against
  s*G - e*P in Python integers.

Tolerance: 0 (integers, digit rows, masks).  The SHA-256 kernel's plain
version is held against the JAX package in test_torch_sha256.py.  On CPU
tensors every wrapper takes its plain version; the launch counters must
not move.  Also here: the C entry points in ``csrc/`` (the sign slice's
too) and the ``ctypes`` signatures in ``ops/_build.py`` agree, so a
binding fault shows on the CPU.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

import oracle
from secp256k1_zkp_tpu.ops import pallas_field as JPF
from secp256k1_zkp_tpu.ops import pallas_gen as JGEN
from secp256k1_zkp_tpu.ops import pallas_scalar as JPS
from secp256k1_zkp_tpu_torch.ops import _build
from secp256k1_zkp_tpu_torch.ops import cuda_field as TF
from secp256k1_zkp_tpu_torch.ops import cuda_gen as TGEN
from secp256k1_zkp_tpu_torch.ops import cuda_group as TG
from secp256k1_zkp_tpu_torch.ops import cuda_scalar as TS
from secp256k1_zkp_tpu_torch.utils import hostcurve as hc

from test_torch_kernels import trows32
from test_torch_ops import ints, rand, rows_np

P, N = hc.P, hc.N
I32 = torch.int32


def _dec(rows, w):
    acc = 0
    for d in rows:
        acc = acc * (1 << w) + (-(d & 0xFF) if d >> 8 else d & 0xFF)
    return acc


def test_glv_only_vs_jax_body():
    rng = np.random.default_rng(60)
    k = rand(rng, N, 6) + [0, 1, N - 1, TS.LAMBDA, (N - 1) // 2,
                           (N + 1) // 2]
    before = dict(_build.LAUNCH_COUNTS)
    digs, flags = TS.glv_only(trows32(k))
    assert _build.LAUNCH_COUNTS == before
    assert digs.dtype == I32 and digs.shape == (52, len(k))
    assert flags.dtype == I32 and flags.shape == (2, len(k))
    d_ref = np.zeros((52, len(k)), np.uint32)
    f_ref = np.zeros((2, len(k)), np.uint32)
    with jax.disable_jit():
        JPS._glv_only_kernel(rows_np(k), d_ref, f_ref)
    assert digs.tolist() == d_ref.astype(np.int64).tolist()
    assert flags.tolist() == f_ref.astype(np.int64).tolist()
    # the rows decode to k, halves below 2^128; the same rows as the prep
    # kernel's for u2 = k (r = k, s = 1)
    for j in range(len(k)):
        h1 = _dec(digs[:26, j].tolist(), 5)
        h2 = _dec(digs[26:, j].tolist(), 5)
        assert 0 <= h1 < 2 ** 128 and 0 <= h2 < 2 ** 128
        s1 = -1 if flags[0, j] else 1
        s2 = -1 if flags[1, j] else 1
        assert (s1 * h1 + TS.LAMBDA * s2 * h2) % N == k[j]
    pdigs, _, pflags = TS.ecdsa_prep(trows32(k), trows32(k),
                                     trows32([1] * len(k)))
    assert torch.equal(pdigs, digs) and torch.equal(pflags, flags)


def _lift_want(x):
    xm = x % P
    y2 = (xm ** 3 + 7) % P
    y = pow(y2, (P + 1) // 4, P)
    if y & 1:
        y = P - y
    return y, y * y % P == y2


def test_lift_x_vs_ints():
    rng = np.random.default_rng(61)
    xs = [hc.mul(k)[0] for k in rand(rng, N, 4)] + rand(rng, P, 8)
    xs += [0, 1, P - 1, hc.GX, P, P + 1, 2 ** 256 - 1]   # x >= p as given
    want = [_lift_want(x) for x in xs]
    assert {ok for _, ok in want} == {True, False}       # both kinds
    before = dict(_build.LAUNCH_COUNTS)
    y, ok = TF.lift_x(trows32(xs))
    assert _build.LAUNCH_COUNTS == before
    assert y.dtype == I32 and y.shape == (16, len(xs))
    assert ok.dtype == torch.bool and ok.shape == (len(xs),)
    assert ints(y) == [w[0] for w in want]
    assert ok.tolist() == [w[1] for w in want]
    for x, (yw, okw) in zip(xs, want):
        if x < P:
            pt = oracle.lift_x_even_y(x)
            assert (pt is not None) == okw and (pt is None or pt[1] == yw)
    # the sqrt chain on its own, weak input included
    a = rand(rng, P, 6) + [0, 1, P - 1, 2 ** 256 - 1]
    got = TF.canon_p(TF.pow_sqrt(torch.from_numpy(
        rows_np(a).astype(np.int64))))
    assert ints(got) == [pow(v, (P + 1) // 4, P) for v in a]


def _jacobian(pt, z):
    x, y = pt
    return x * z * z % P, y * pow(z, 3, P) % P, z


def test_schnorr_check_vs_ints_and_jax_body():
    rng = np.random.default_rng(63)
    pts = [hc.mul(k) for k in rand(rng, N, 8)]
    odd = next(p for p in pts if p[1] & 1)
    even = next(p for p in pts if not p[1] & 1)
    zs = [z or 1 for z in rand(rng, P, 8)]
    # (point, z, r, inf, expected)
    lanes = [(even, zs[0], even[0], False, True),
             (odd, zs[1], odd[0], False, False),          # odd y
             (even, zs[2], even[0] + 1, False, False),    # wrong r
             (even, zs[3], even[0], True, False),         # flagged infinite
             (even, 1, even[0], False, True),             # affine input
             ((odd[0], P - odd[1]), zs[4], odd[0], False, True),
             (even, zs[5], (even[0] * zs[5]) % P, False, False)]
    X, Y, Z, R, inf, want = [], [], [], [], [], []
    for pt, z, r, i, w in lanes:
        x, y, zz = _jacobian(pt, z)
        X.append(x); Y.append(y); Z.append(zz); R.append(r)
        inf.append(i); want.append(w)
    # infinity as ecmult_glv reports it: z = 0
    X.append(0); Y.append(1); Z.append(0); R.append(0)
    inf.append(True); want.append(False)
    args = [trows32(v) for v in (X, Y, Z)]
    before = dict(_build.LAUNCH_COUNTS)
    ok = TF.schnorr_check(*args, torch.tensor(inf), trows32(R))
    assert _build.LAUNCH_COUNTS == before
    assert ok.dtype == torch.bool and ok.tolist() == want
    ok_ref = np.zeros((1, len(X)), np.uint32)
    with jax.disable_jit():
        JPF._schnorr_check_kernel(
            rows_np(X), rows_np(Y), rows_np(Z),
            np.array([inf], np.uint32), rows_np(R), ok_ref)
    assert ok_ref[0].astype(bool).tolist() == want


def test_gen_digits_vs_jax():
    rng = np.random.default_rng(64)
    k = rand(rng, N, 5) + [0, N - 1]
    got = TGEN.gen_digits(trows32(k))
    want = JGEN.gen_digits(jnp.asarray(rows_np(k)))
    assert got.dtype == I32 and got.shape == (37, len(k))
    assert got.tolist() == np.asarray(want).astype(np.int64).tolist()
    for j in range(len(k)):
        assert _dec(got[:, j].tolist(), 7) == k[j]


def test_schnorr_ecmult_composition_vs_ints():
    """R = s*G + (-e)*P through glv_only (flags flipped), gen_digits, the
    comb and ecmult_glv with rx=None — the Schnorr path's use of B3."""
    rng = np.random.default_rng(65)
    s = rand(rng, N, 3) + [0, 5, 9]
    e = rand(rng, N, 3) + [7, 0, 9]
    pts = [hc.mul(k) for k in rand(rng, N, 5)] + [hc.G]  # last: infinity
    digs, flags = TS.glv_only(trows32(e))
    gjac = TGEN.fixedbase_digits(TGEN.gen_digits(trows32(s)))
    pinf = torch.zeros(len(s), dtype=torch.bool)
    x, y, z, inf, ok = TG.ecmult_glv(
        digs, flags ^ 1, trows32([p[0] for p in pts]),
        trows32([p[1] for p in pts]), pinf, gjac, rx=None)
    assert not ok.any()
    for j in range(len(s)):
        w = hc.add(hc.mul(s[j]), hc.neg(hc.mul(e[j], pts[j])))
        assert bool(inf[j]) == (w is None)
        if w is not None:
            zi = pow(ints(z)[j], -1, P)
            assert (ints(x)[j] * zi * zi % P,
                    ints(y)[j] * zi ** 3 % P) == w


def test_c_entry_points_match_ctypes_signatures():
    """Every ``extern "C"`` kernel entry in csrc/*.cu has a ctypes
    signature with as many arguments, and every launch counter has a
    wrapper that counts it."""
    entries = {}
    for cu in _build.SRC_DIR.glob("*.cu"):
        for name, params in re.findall(
                r'extern "C" int (secp_\w+)\(([^)]*)\)', cu.read_text()):
            entries[name] = (0 if params.strip() in ("", "void")
                             else len(params.split(",")))
    assert entries == {k: len(v) for k, v in _build._SIGNATURES.items()}
    wrappers = "".join(p.read_text() for p in
                       (_build.SRC_DIR.parent / "ops").glob("cuda_*.py"))
    counted = set(re.findall(r'count_launch\("(\w+)"\)', wrappers))
    assert counted == set(_build.LAUNCH_COUNTS)
    assert {"lift_x.cu", "glv_only.cu", "schnorr_check.cu", "sha256.cu",
            "ecdsa_finish.cu", "affine_xy.cu", "muladd_n.cu"} \
        <= {p.name for p in _build.sources()}
    # the sign slice's entry points, and the comb's one entry for its
    # three kernels (scan, blinded scan, public gather)
    assert {"secp_fixedbase", "secp_ecdsa_finish", "secp_affine_xy",
            "secp_muladd_n"} <= set(entries)
    # the MSM engine's: gej_add and the three fused-MSM kernels
    assert {"gej_add.cu", "msm_table.cu", "msm_winreduce.cu",
            "msm_finish.cu", "msm.cuh"} <= {p.name for p in _build.sources()}
    assert {"secp_gej_add", "secp_msm_table", "secp_msm_winreduce",
            "secp_msm_finish"} <= set(entries)
    # the one-launch lane sum beside gej_add, and the latency probe of
    # the finish's and the sum's floor
    assert {"secp_gej_sum", "secp_latency_probe"} <= set(entries)
    # the commitment and recovery slice's: affine_meta (B10), inv_n (B15b)
    assert {"affine_meta.cu", "inv_n.cu"} <= {p.name for p in _build.sources()}
    assert {"secp_affine_meta", "secp_inv_n"} <= set(entries)
    # the occupancy queries beside the redesigned kernels
    assert {"secp_ecmult_glv_warps", "secp_msm_winreduce_warps",
            "secp_fixedbase_warps", "secp_msm_table_warps",
            "secp_msm_finish_warps", "secp_gej_warps"} <= set(entries)
