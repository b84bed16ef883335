#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Drives the port's main paths through the entry points a user calls —
``context.selftest``, batched ECDSA verify (``modules.ecdsa.verify``) and
batched BIP-340 Schnorr verify (``modules.schnorrsig.verify``), each at
16,384 and 262,144 signatures — builds the eight hand-written kernels
from the sources in this checkout, holds each against its plain PyTorch
version on the card at every shape those paths give it (exact equality:
the values are integers, the tolerance is 0), times them, and prints one
JSON line per phase.  Any failed phase raises: nothing is caught.
Without a CUDA device the script exits non-zero and prints no result.

Bounds: ``bound_ms`` is the larger of bytes/3.35 TB/s (each operand read
once, each result written once) and operations/67 TOP/s, the card's
published non-tensor rate, with a 32-bit multiply-add counted as two
operations.  Only the arithmetic the function needs is counted (field
multiplies per doubling and addition, additions per window, divsteps per
inverse; written out in ``OPS`` below).  The full-table select scans are
a choice of the kernels, not arithmetic of k*G, and are not in the bound.
SHA-256 is counted in 32-bit logic and add operations, one operation each
(a rotate is one; ``SHA_BLOCK`` below), i.e. half a multiply-add.

``mulmod_chain`` is on the main path only through ``context.selftest``
(one or two lanes, chains of 1 to 16 multiplies); its ``ms``, ``plain_ms``
and ``bound_ms`` are read at the longest of those.  The ``chain64_*`` keys
are a micro-benchmark of the field multiply at the verify batch sizes
(64 multiplies a lane), a shape the main path does not give it.
``sha256`` runs twice in ``context.selftest`` (one block each) and once
per Schnorr verify (the 96-byte challenge after the tag midstate: two
blocks in one launch); its ``ms`` is read at the verify shape.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
import time
from functools import lru_cache

import numpy as np
import torch

from secp256k1_zkp_tpu_torch import context
from secp256k1_zkp_tpu_torch.modules import ecdsa, schnorrsig
from secp256k1_zkp_tpu_torch.ops import (_build, cuda_field, cuda_gen,
                                         cuda_group, cuda_scalar,
                                         cuda_sha256)
from secp256k1_zkp_tpu_torch.ops import field as F
from secp256k1_zkp_tpu_torch.ops import scalar as S
from secp256k1_zkp_tpu_torch.ops import sha256 as H
from secp256k1_zkp_tpu_torch.ops.group import GE
from secp256k1_zkp_tpu_torch.ops.limb import LB, MASK16
from secp256k1_zkp_tpu_torch.utils import hostcurve as hc

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
CHAIN_N = 64                      # multiplies a lane in the chain64 timing

# --- operation model (32-bit multiply-adds per lane) -----------------------
MUL = 64 + 8                      # 8x8 words + the fold by 977
SQR = 28 + 8 + 8                  # off-diagonal once, diagonal, fold
DOUBLE = 5 * SQR + 2 * MUL        # gej_double
ADD_AFF = 5 * SQR + 7 * MUL       # complete mixed add (7M + 5S)
ADD_JAC = 6 * SQR + 11 * MUL      # complete jacobian add
# safegcd: 20 batches of (30 divsteps of ~13 integer operations, counted as
# 13/2 multiply-adds, and 90 wide multiplies in the two limb updates)
MODINV = 20 * (30 * 13 // 2 + 90)
SC_MUL = 64 + 3 * 40              # 8x8 words + three folds by the 129-bit red
# GLV split: k*g1, k*g2 (8x8 each), c1*(-b1) (4x4), c2*(-b2) (4x8), their
# two reductions and the modular multiply by lambda
GLV_SPLIT = 2 * 64 + 48 + 2 * 120 + SC_MUL
# SHA-256, one block: 64 rounds of 26 logic/add operations (Sigma1 5, Ch 4,
# t1 4, Sigma0 5, Maj 5, 3 more adds), 48 schedule words of 13 (sigma0 5,
# sigma1 5, 3 adds), 8 final adds — counted one each, so halved here
SHA_BLOCK = (64 * 26 + 48 * 13 + 8) / 2
SHA_VERIFY_BLOCKS = 2             # the 96-byte challenge after the midstate
OPS = {
    "mulmod_chain": MUL,          # per multiply of the chain
    # inverse, u1, u2, split
    "ecdsa_prep": MODINV + 2 * SC_MUL + GLV_SPLIT,
    # 37 rows, one mixed add each
    "fixedbase_digits": 37 * ADD_AFF,
    # table (1 double, 14 adds), global-Z pass, beta * x of the 16 entries,
    # 26 windows of 5 doublings and 2 mixed adds, join, check
    "ecmult_glv": (DOUBLE + 14 * ADD_AFF + MODINV + SQR + 3 * MUL
                   + 15 * (SQR + 5 * MUL) + 14 * MUL + 16 * MUL
                   + 26 * (5 * DOUBLE + 2 * ADD_AFF)
                   + ADD_JAC + SQR + 2 * MUL),
    # x^2, x^3, the sqrt chain (253 S + 13 M), the check y^2
    "lift_x": 255 * SQR + 14 * MUL,
    "glv_only": GLV_SPLIT,
    # X == r*Z^2, the inverse of Z, Y * (Z^-1)^3
    "schnorr_check": MODINV + 2 * SQR + 3 * MUL,
    "sha256": SHA_BLOCK,          # per block
}
# 32-bit elements read + written per lane
WORDS = {
    "mulmod_chain": 3 * 16,
    "ecdsa_prep": 3 * 16 + 52 + 37 + 2,
    "fixedbase_digits": 37 + 3 * 16,
    "ecmult_glv": 52 + 3 + 6 * 16 + 3 * 16 + 2,
    "lift_x": 16 + 16 + 1,
    "glv_only": 16 + 52 + 2,
    "schnorr_check": 4 * 16 + 1 + 1,
    "sha256": 8 + 8,              # state in and out; + 16 a block
}
REPLACES = {
    "mulmod_chain": "secp256k1_zkp_tpu/ops/pallas_field.py:183",
    "ecdsa_prep": "secp256k1_zkp_tpu/ops/pallas_scalar.py:423",
    "fixedbase_digits": "secp256k1_zkp_tpu/ops/pallas_gen.py:114",
    "ecmult_glv": "secp256k1_zkp_tpu/ops/pallas_group.py:517",
    "lift_x": "secp256k1_zkp_tpu/ops/pallas_field.py:272",
    "glv_only": "secp256k1_zkp_tpu/ops/pallas_scalar.py:484",
    "schnorr_check": "secp256k1_zkp_tpu/ops/pallas_field.py:366",
    # no TPU kernel: XLA glue there (the compression it replaces)
    "sha256": "secp256k1_zkp_tpu/ops/sha256.py:54 (XLA, no Pallas kernel)",
}
SOURCES = {
    "mulmod_chain": "secp256k1_zkp_tpu_torch/csrc/mulmod_chain.cu",
    "ecdsa_prep": "secp256k1_zkp_tpu_torch/csrc/ecdsa_prep.cu",
    "fixedbase_digits": "secp256k1_zkp_tpu_torch/csrc/fixedbase.cu",
    "ecmult_glv": "secp256k1_zkp_tpu_torch/csrc/ecmult_glv.cu",
    "lift_x": "secp256k1_zkp_tpu_torch/csrc/lift_x.cu",
    "glv_only": "secp256k1_zkp_tpu_torch/csrc/glv_only.cu",
    "schnorr_check": "secp256k1_zkp_tpu_torch/csrc/schnorr_check.cu",
    "sha256": "secp256k1_zkp_tpu_torch/csrc/sha256.cu",
}
MAIN_PATH_KERNELS = tuple(OPS)
ECDSA_KERNELS = ("ecdsa_prep", "fixedbase_digits", "ecmult_glv")
SCHNORR_KERNELS = ("sha256", "lift_x", "glv_only", "fixedbase_digits",
                   "ecmult_glv", "schnorr_check")
# the kernels each path must launch, and how often a call
PATHS = {"selftest": {"mulmod_chain": 4, "sha256": 2},
         "ecdsa": {k: 1 for k in ECDSA_KERNELS},
         "schnorr": {k: 1 for k in SCHNORR_KERNELS}}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def ptxas_summary(log: str) -> dict:
    """``nvcc -Xptxas -v`` output -> {kernel: "N registers, S B stack"}
    for each ``__global__`` entry function."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(\w+?_kernel)", ln)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes cumulative "
                      r"stack size)?", ln)
        if m and cur:
            out[cur] = f"{m.group(1)} registers, {m.group(2) or 0} B stack"
            cur = None
    return out


def profile_call(fn):
    """One warm call of ``fn`` under ``torch.profiler``: (wall ms with the
    profiler on, device ms summed over the kernels the card ran, number of
    kernels, the 10 kernels with the most device time as
    [name, count, ms])."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        wall = (time.perf_counter() - t1) * 1e3
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kern:
        n, ms = by_name.get(e.name[:60], (0, 0.0))
        by_name[e.name[:60]] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    dev_ms = sum(ms for _, ms in by_name.values())
    return wall, dev_ms, len(kern), [[k, n, ms] for k, (n, ms) in top]


def bound_ms(name: str, lanes: int, chain: int = 1):
    """Least time for ``lanes`` lanes of kernel ``name`` (``chain``
    multiplies a lane for mulmod_chain, blocks a lane for sha256), and
    what sets it."""
    words = WORDS[name] + (16 * chain if name == "sha256" else 0)
    t_bytes = words * 4 * lanes / PEAK_BYTES_PER_S
    t_ops = OPS[name] * chain * 2 * lanes / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


# --- host-built signatures --------------------------------------------------


def _limbs(x: int):
    return [(x >> (16 * i)) & MASK16 for i in range(16)]


@lru_cache(maxsize=1)
def _comb_ints():
    tab = cuda_gen.comb_tables().tolist()
    return [[(sum(l << (16 * i) for i, l in enumerate(e[0])),
              sum(l << (16 * i) for i, l in enumerate(e[1])))
             for e in win] for win in tab]


def _mul_g(k: int, comb):
    """k*G as a jacobian triple of Python ints, 37 table additions."""
    acc = None
    for v in range(37):
        d = (k >> (7 * v)) & 0x7F
        if d > 64:                 # keep magnitudes within the 64 entries
            pt = hc.neg(comb[v][128 - d - 1])
            k += 1 << (7 * (v + 1))
        elif d:
            pt = comb[v][d - 1]
        else:
            continue
        acc = hc.jadd(acc, hc.jlift(pt))
    return acc


def make_distinct(distinct: int, seed: int):
    """``distinct`` valid low-S signatures built on the host with Python
    ints: (msgs, sigs, n - s bytes, key x limbs, key y limbs)."""
    comb = _comb_ints()
    rng = np.random.default_rng(seed)
    seedb = rng.bytes(32)
    msgs = rng.integers(0, 256, (distinct, 32), dtype=np.uint8)
    ds, ks = [], []
    for i in range(distinct):
        ds.append(int.from_bytes(hashlib.sha256(
            seedb + b"d%d" % i).digest(), "big") % hc.N or 1)
        ks.append(int.from_bytes(hashlib.sha256(
            seedb + b"k%d" % i).digest(), "big") % hc.N or 1)
    Ra = hc.batch_affine([_mul_g(k, comb) for k in ks])
    Pa = hc.batch_affine([_mul_g(d, comb) for d in ds])
    for i in range(0, distinct, max(distinct // 4, 1)):
        # the table-driven multiples against plain double-and-add
        assert Pa[i] == hc.mul(ds[i]) and Ra[i] == hc.mul(ks[i])
    sigs = np.zeros((distinct, 64), np.uint8)
    high = np.zeros((distinct, 32), np.uint8)       # n - s, for the high-S lanes
    pkx = np.zeros((distinct, 16), np.int64)
    pky = np.zeros((distinct, 16), np.int64)
    for i in range(distinct):
        m = int.from_bytes(bytes(msgs[i]), "big") % hc.N
        r = Ra[i][0] % hc.N
        s = pow(ks[i], -1, hc.N) * (m + r * ds[i]) % hc.N
        if s > hc.N // 2:
            s = hc.N - s
        sigs[i] = np.frombuffer(r.to_bytes(32, "big") + s.to_bytes(32, "big"),
                                np.uint8)
        high[i] = np.frombuffer((hc.N - s).to_bytes(32, "big"), np.uint8)
        pkx[i], pky[i] = _limbs(Pa[i][0]), _limbs(Pa[i][1])
    return msgs, sigs, high, pkx, pky


def make_batch(base, lanes: int):
    """``lanes`` signatures tiled from the distinct ones of ``base``, with the
    corruption mix valid / flipped sig byte / flipped msg / high-S by lane
    index and a few edge lanes (r = 0, s = 0, s >= n, infinite key).
    Returns (msg32, sig64, pub GE on the CPU, expected mask)."""
    msgs, sigs, high, pkx, pky = base
    reps = -(-lanes // len(msgs))
    msgs = np.tile(msgs, (reps, 1))[:lanes].copy()
    sigs = np.tile(sigs, (reps, 1))[:lanes].copy()
    high = np.tile(high, (reps, 1))[:lanes]
    pkx = np.tile(pkx, (reps, 1))[:lanes].copy()
    pky = np.tile(pky, (reps, 1))[:lanes].copy()
    pinf = np.zeros(lanes, bool)
    kind = np.arange(lanes) % 5
    sigs[kind == 1, 40] ^= 1                    # flipped signature byte
    msgs[kind == 2, 0] ^= 0x80                  # flipped message bit
    sigs[kind == 3, 32:] = high[kind == 3]      # high-S
    expect = (kind == 0) | (kind == 4)
    # edge lanes, on lanes that were valid
    edge = [0, 5, 10, 15]
    if lanes > edge[-1]:
        sigs[edge[0], :32] = 0                                  # r = 0
        sigs[edge[1], 32:] = 0                                  # s = 0
        sigs[edge[2], 32:] = np.frombuffer(hc.N.to_bytes(32, "big"),
                                           np.uint8)           # s >= n
        pinf[edge[3]] = True                                    # P = infinity
        expect[edge] = False
    pub = GE(LB(torch.from_numpy(pkx), MASK16),
             LB(torch.from_numpy(pky), MASK16),
             torch.from_numpy(pinf))
    return torch.from_numpy(msgs), torch.from_numpy(sigs), pub, expect


# --- host-built BIP-340 signatures ------------------------------------------

# the BIP-340 verify vectors (pubkey, msg, sig, valid): data from the BIP,
# as the reference embeds them in modules/schnorrsig/tests_impl.h
BIP340_VERIFY_VECTORS = [
    ("D69C3509BB99E412E68B0FE8544E72837DFA30746D8BE2AA65975F29D22DC7B9",
     "4DF3C3F68FCC83B27E9D42C90431A72499F17875C81A599B566C9889B9696703",
     "00000000000000000000003B78CE563F89A0ED9414F5AA28AD0D96D6795F9C63"
     "76AFB1548AF603B3EB45C9F8207DEE1060CB71C04E80F593060B07D28308D7F4",
     True),
    ("EEFDEA4CDB677750A420FEE807EACF21EB9898AE79B9768766E4FAA04A2D4A34",
     "243F6A8885A308D313198A2E03707344A4093822299F31D0082EFA98EC4E6C89",
     "6CFF5C3BA86C69EA4B7376F31A9BCB4F74C1976089B2D9963DA2E5543E177769"
     "69E89B4C5564D00349106B8497785DD7D1D713A8AE82B32FA79D5F7FC407D39B",
     False),  # public key not on the curve
    ("DFF1D77F2A671C5F36183726DB2341BE58FEAE1DA2DECED843240F7B502BA659",
     "243F6A8885A308D313198A2E03707344A4093822299F31D0082EFA98EC4E6C89",
     "FFF97BD5755EEEA420453A14355235D382F6472F8568A18B2F057A1460297556"
     "3CC27944640AC607CD107AE10923D9EF7A73C643E166BE5EBEAFA34B1AC553E2",
     False),  # has_even_y(R) is false
    ("DFF1D77F2A671C5F36183726DB2341BE58FEAE1DA2DECED843240F7B502BA659",
     "243F6A8885A308D313198A2E03707344A4093822299F31D0082EFA98EC4E6C89",
     "6CFF5C3BA86C69EA4B7376F31A9BCB4F74C1976089B2D9963DA2E5543E177769"
     "FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141",
     False),  # sig[32:64] is equal to curve order
    ("FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFC30",
     "243F6A8885A308D313198A2E03707344A4093822299F31D0082EFA98EC4E6C89",
     "6CFF5C3BA86C69EA4B7376F31A9BCB4F74C1976089B2D9963DA2E5543E177769"
     "69E89B4C5564D00349106B8497785DD7D1D713A8AE82B32FA79D5F7FC407D39B",
     False),  # pubkey x exceeds field size
]


def _tagged(tag: str, msg: bytes) -> bytes:
    th = hashlib.sha256(tag.encode()).digest()
    return hashlib.sha256(th + th + msg).digest()


def _challenge(r32: bytes, px32: bytes, msg: bytes) -> int:
    return int.from_bytes(_tagged("BIP0340/challenge", r32 + px32 + msg),
                          "big") % hc.N


def _i32(x: int) -> bytes:
    return x.to_bytes(32, "big")


def make_schnorr_distinct(distinct: int, seed: int):
    """``distinct`` valid BIP-340 signatures built on the host with Python
    ints and hashlib: (msgs, sigs, x-only keys, a signature right but for
    its R's odd y with its msg and key)."""
    comb = _comb_ints()
    rng = np.random.default_rng(seed + 1)
    seedb = rng.bytes(32)
    msgs = rng.integers(0, 256, (distinct, 32), dtype=np.uint8)
    ds, ks = [], []
    for i in range(distinct):
        ds.append(int.from_bytes(hashlib.sha256(
            seedb + b"D%d" % i).digest(), "big") % hc.N or 1)
        ks.append(int.from_bytes(hashlib.sha256(
            seedb + b"K%d" % i).digest(), "big") % hc.N or 1)
    Ra = hc.batch_affine([_mul_g(k, comb) for k in ks])
    Pa = hc.batch_affine([_mul_g(d, comb) for d in ds])
    for i in range(0, distinct, max(distinct // 4, 1)):
        assert Pa[i] == hc.mul(ds[i]) and Ra[i] == hc.mul(ks[i])
    sigs = np.zeros((distinct, 64), np.uint8)
    pxs = np.zeros((distinct, 32), np.uint8)
    odd_r = None
    for i in range(distinct):
        d = ds[i] if Pa[i][1] % 2 == 0 else hc.N - ds[i]
        k = ks[i] if Ra[i][1] % 2 == 0 else hc.N - ks[i]
        r32, px32, msg = _i32(Ra[i][0]), _i32(Pa[i][0]), bytes(msgs[i])
        s = (k + _challenge(r32, px32, msg) * d) % hc.N
        sigs[i] = np.frombuffer(r32 + _i32(s), np.uint8)
        pxs[i] = np.frombuffer(px32, np.uint8)
        if odd_r is None and Ra[i][1] % 2:
            # the nonce left unnegated: s*G - e*P is R itself, odd y
            s_odd = (ks[i] + _challenge(r32, px32, msg) * d) % hc.N
            odd_r = (msg, r32 + _i32(s_odd), px32)
    return msgs, sigs, pxs, odd_r


def _not_on_curve_x() -> int:
    x = 5
    while True:
        y2 = (x ** 3 + 7) % hc.P
        if pow(y2, (hc.P - 1) // 2, hc.P) != 1:
            return x
        x += 1


def make_schnorr_batch(base, lanes: int):
    """``lanes`` BIP-340 signatures tiled from ``base`` with the mix valid
    / signature byte 50 bit 2 flipped / message byte flipped by lane index
    and edge lanes: key x not on the curve, x >= p, r >= p, s >= n, s = 0,
    R with odd y, and the five BIP-340 verify vectors.  Returns (msg32,
    sig64, px32 on the CPU, expected mask)."""
    msgs, sigs, pxs, odd_r = base
    reps = -(-lanes // len(msgs))
    msgs = np.tile(msgs, (reps, 1))[:lanes].copy()
    sigs = np.tile(sigs, (reps, 1))[:lanes].copy()
    pxs = np.tile(pxs, (reps, 1))[:lanes].copy()
    kind = np.arange(lanes) % 3
    sigs[kind == 1, 50] ^= 4                    # flipped signature bit
    msgs[kind == 2, 0] ^= 1                     # flipped message bit
    expect = kind == 0

    def put(lane, msg, sig, px32, ok):
        msgs[lane] = np.frombuffer(msg, np.uint8)
        sigs[lane] = np.frombuffer(sig, np.uint8)
        pxs[lane] = np.frombuffer(px32, np.uint8)
        expect[lane] = ok

    def lane_bytes(lane):
        return bytes(msgs[lane]), bytes(sigs[lane]), bytes(pxs[lane])

    # edge lanes, each on a lane that was valid (kind 0)
    m, sg, px = lane_bytes(0)
    put(0, m, sg, _i32(_not_on_curve_x()), False)
    m, sg, px = lane_bytes(3)
    x_ge_p = hc.P + int.from_bytes(px, "big") % (2 ** 256 - hc.P)
    put(3, m, sg, _i32(x_ge_p), False)
    m, sg, px = lane_bytes(6)
    r_ge_p = hc.P + int.from_bytes(sg[:32], "big") % (2 ** 256 - hc.P)
    put(6, m, _i32(r_ge_p) + sg[32:], px, False)
    m, sg, px = lane_bytes(9)
    s_ge_n = hc.N + int.from_bytes(sg[32:], "big") % (2 ** 256 - hc.N)
    put(9, m, sg[:32] + _i32(s_ge_n), px, False)
    m, sg, px = lane_bytes(12)
    put(12, m, sg[:32] + bytes(32), px, False)           # s = 0
    put(15, *odd_r, False)
    for j, (pk, msg, sig, ok) in enumerate(BIP340_VERIFY_VECTORS):
        put(18 + 3 * j, bytes.fromhex(msg), bytes.fromhex(sig),
            bytes.fromhex(pk), ok)
    return (torch.from_numpy(msgs), torch.from_numpy(sigs),
            torch.from_numpy(pxs), expect)


# --- timing -----------------------------------------------------------------


def time_ms(fn, reps: int = 5, warm: int = 1):
    """Median time of ``fn`` on the card in ms, by CUDA events (warm,
    fenced)."""
    for _ in range(warm):
        fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out))


def kernel_inputs(msgs, sigs, pub, dev):
    """The tensors each ECDSA kernel sees on the main path, from a batch."""
    m, _ = S.from_bytes_be(msgs.to(dev))
    r, s, _ = ecdsa.sig_parse_compact(sigs.to(dev))
    pub = pub.to(dev)
    rows = ecdsa.kernel_rows
    t = dict(m=rows(m), r=rows(r), s=rows(s),
             px=rows(F.normalize(pub.x)), py=rows(F.normalize(pub.y)),
             pinf=pub.inf)
    t["digs"], t["gdigs"], t["flags"] = cuda_scalar.ecdsa_prep(
        t["m"], t["r"], t["s"])
    t["gjac"] = cuda_gen.fixedbase_digits(t["gdigs"])
    t["check_rx"] = t["r"]
    return t


def schnorr_inputs(msgs, sigs, pxs, dev):
    """The tensors each Schnorr kernel sees on the main path, from a
    batch: the steps of ``schnorrsig.verify`` one by one."""
    msgs, sigs, pxs = msgs.to(dev), sigs.to(dev), pxs.to(dev)
    rows = ecdsa.kernel_rows
    rx, _ = F.from_bytes_be(sigs[:, :32])
    s, _ = S.from_bytes_be(sigs[:, 32:])
    pkx, _ = F.from_bytes_be(pxs)
    ch = torch.cat([sigs[:, :32], pxs, msgs], -1)
    mid = torch.tensor(H.tag_midstate("BIP0340/challenge"),
                       dtype=torch.int64, device=dev)
    t = dict(sha_state=cuda_sha256.words_to_rows(
                 mid.expand(len(msgs), 8)),
             sha_blocks=cuda_sha256.words_to_rows(
                 H._pad_bytes_to_blocks(ch, 64)),
             px=rows(pkx), rx=rows(F.normalize(rx)),
             pinf=torch.zeros(len(msgs), dtype=torch.bool, device=dev))
    e = schnorrsig.challenge(sigs[:, :32], pxs, msgs)
    t["e"] = rows(S.normalize(e))
    t["py"], _ = cuda_field.lift_x(t["px"])
    t["digs"], eflags = cuda_scalar.glv_only(t["e"])
    t["flags"] = eflags ^ 1
    t["gdigs"] = cuda_gen.gen_digits(rows(s))
    t["gjac"] = cuda_gen.fixedbase_digits(t["gdigs"])
    t["check_rx"] = None
    t["R"] = cuda_group.ecmult_glv(t["digs"], t["flags"], t["px"], t["py"],
                                   t["pinf"], t["gjac"], rx=None)[:4]
    return t


def run_pair(name, t, use_ref: bool):
    """One kernel (or its plain version) on the tensors ``t``; returns a
    tuple of result tensors."""
    if name == "mulmod_chain":
        f = cuda_field.mulmod_chain_ref if use_ref else cuda_field.mulmod_chain
        return (f(t["px"], t["py"], t.get("chain", CHAIN_N)),)
    if name == "ecdsa_prep":
        f = cuda_scalar.ecdsa_prep_ref if use_ref else cuda_scalar.ecdsa_prep
        return f(t["m"], t["r"], t["s"])
    if name == "fixedbase_digits":
        f = (cuda_gen.fixedbase_digits_ref if use_ref
             else cuda_gen.fixedbase_digits)
        return f(t["gdigs"])
    if name == "ecmult_glv":
        f = cuda_group.ecmult_glv_ref if use_ref else cuda_group.ecmult_glv
        return f(t["digs"], t["flags"], t["px"], t["py"], t["pinf"],
                 t["gjac"], rx=t["check_rx"])
    if name == "sha256":
        f = (cuda_sha256.sha256_blocks_ref if use_ref
             else cuda_sha256.sha256_blocks)
        return (f(t["sha_state"], t["sha_blocks"]),)
    if name == "lift_x":
        f = cuda_field.lift_x_ref if use_ref else cuda_field.lift_x
        return f(t["px"])
    if name == "glv_only":
        f = cuda_scalar.glv_only_ref if use_ref else cuda_scalar.glv_only
        return f(t["e"])
    f = cuda_field.schnorr_check_ref if use_ref else cuda_field.schnorr_check
    return (f(*t["R"], t["rx"]),)


def compare(name, t):
    """Kernel against plain version on ``t``: (max abs err, plain ms by
    the host clock around one fenced call)."""
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want = run_pair(name, t, use_ref=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t1) * 1e3
    got = run_pair(name, t, use_ref=False)
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_cuda and w.is_cuda
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                           .abs().max()))
    return err, plain_ms


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    t_start = time.time()

    # -- phase 1: env --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs one CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sizes, distinct, ragged = (16384, 262144), 2048, 1024 + 37
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-2]
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc, triton=triton_v, gpu=smi)

    # -- phase 2: build ------------------------------------------------------
    t0 = time.time()
    _build.lib()
    ptxas = [ln.strip() for ln in _build.build_log().splitlines()
             if "registers" in ln or "spill" in ln.lower()]
    emit("build", seconds=round(time.time() - t0, 2),
         nvcc_seconds=_build.BUILD_SECONDS, sources=len(_build.sources()),
         kernels=ptxas_summary(_build.build_log()),
         spills=[ln for ln in ptxas if "spill" in ln
                 and not ln.startswith("0 bytes stack frame, 0 bytes spill")])

    # -- phase 3: kernels against their plain versions ----------------------
    # the verify kernels at both main-path batches and at a ragged one, on
    # each path's own tensors (fixedbase_digits and ecmult_glv on both:
    # ecmult_glv with the fused r check on the ECDSA path, rx=None on the
    # Schnorr path); mulmod_chain and sha256 also on the selftest's own
    # operands, and mulmod_chain as a micro-benchmark at the verify batches
    t0 = time.time()
    base = make_distinct(distinct, args.seed)
    sbase = make_schnorr_distinct(distinct, args.seed)
    batches = {n: make_batch(base, n) for n in (*sizes, ragged)}
    sbatches = {n: make_schnorr_batch(sbase, n) for n in (*sizes, ragged)}
    emit("data", seconds=round(time.time() - t0, 2),
         lanes=sorted(batches), distinct=distinct)
    results = {k: {"name": k, "route": "cuda", "source": SOURCES[k],
                   "replaces": REPLACES[k], "match": True,
                   "max_abs_err": 0, "library_ms": None}
               for k in MAIN_PATH_KERNELS}

    def record(name, shape, err, plain_ms):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        results[name]["match"] &= err == 0
        emit("kernel_check", name=name, shape=shape, match=err == 0,
             max_abs_err=err, plain_ms=round(plain_ms, 3))

    tensors = {n: kernel_inputs(*batches[n][:3], dev) for n in batches}
    stensors = {n: schnorr_inputs(*sbatches[n][:3], dev) for n in sbatches}
    selftest_t = [dict(px=x, py=y, chain=n)
                  for x, y, n, _ in context.selftest_operands(dev)]
    for t in selftest_t:
        err, plain_ms = compare("mulmod_chain", t)
        record("mulmod_chain", f"selftest [16, {t['px'].shape[1]}], "
               f"n = {t['chain']}", err, plain_ms)
        results["mulmod_chain"]["plain_ms"] = plain_ms      # longest last
    sha_selftest = dict(
        sha_state=cuda_sha256.words_to_rows(torch.tensor(
            [list(H._INIT)], dtype=torch.int64, device=dev)),
        sha_blocks=cuda_sha256.words_to_rows(H._pad_bytes_to_blocks(
            torch.zeros((1, 32), dtype=torch.uint8, device=dev))))
    err, plain_ms = compare("sha256", sha_selftest)
    record("sha256", "selftest shape [8, 1], 1 block", err, plain_ms)
    for n in (*sizes, ragged):
        for name in ("mulmod_chain", *ECDSA_KERNELS):
            err, plain_ms = compare(name, tensors[n])
            chain64 = name == "mulmod_chain"
            record(name, f"{n} lanes" + (f", n = {CHAIN_N}" if chain64
                                         else ""), err, plain_ms)
            if chain64:
                if n in sizes:
                    results[name][f"chain64_plain_ms_{n}"] = plain_ms
            elif n == sizes[0]:
                results[name]["plain_ms"] = plain_ms
            elif n in sizes:
                results[name][f"plain_ms_{n}"] = plain_ms
        for name in SCHNORR_KERNELS:
            err, plain_ms = compare(name, stensors[n])
            shared = name in ECDSA_KERNELS
            pre = "schnorr_" if shared else ""
            record(name, f"{n} lanes, Schnorr path"
                   + (", rx=None" if name == "ecmult_glv" else ""),
                   err, plain_ms)
            if n == sizes[0] and not shared:
                results[name]["plain_ms"] = plain_ms
            elif n in sizes:
                results[name][f"{pre}plain_ms_{n}"] = plain_ms
    bad = [k for k, v in results.items() if not v["match"]]
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")

    # -- phase 4: main paths -------------------------------------------------
    # each call runs with the counts set to 0 just before it and read just
    # after; it must launch exactly the kernels of its path, as often as
    # PATHS says, and nothing else
    launches = {k: 0 for k in MAIN_PATH_KERNELS}
    by_path = {p: {k: 0 for k in MAIN_PATH_KERNELS} for p in PATHS}

    def counted(path, fn):
        _build.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = dict(_build.LAUNCH_COUNTS)
        want = {k: PATHS[path].get(k, 0) for k in got}
        if got != want:
            raise SystemExit(f"{path}: launches {got}, expected {want}")
        for k, v in got.items():
            launches[k] += v
            by_path[path][k] += v
        return out

    counted("selftest", lambda: context.selftest(dev))
    emit("main_path", path="selftest", launches=by_path["selftest"])
    for path, entry, data in (("ecdsa", ecdsa.verify, batches),
                              ("schnorr", schnorrsig.verify, sbatches)):
        for n in sizes:
            *inputs, expect = data[n]
            ok = counted(path, lambda: entry(*inputs, device=dev))
            assert ok.shape == (n,) and ok.dtype == torch.bool and ok.is_cuda
            wrong = int((ok.cpu().numpy() != expect).sum())
            emit("main_path", path=path, lanes=n, valid=int(expect.sum()),
                 accepted=int(ok.sum()), wrong_lanes=wrong,
                 launches=PATHS[path])
            if wrong:
                raise SystemExit(f"{path} verify mask wrong on {wrong} of "
                                 f"{n} lanes")
    idle = [k for k in MAIN_PATH_KERNELS if launches[k] < 1]
    if idle:
        raise SystemExit(f"main path never launched: {idle}")

    # -- phase 5: timing -----------------------------------------------------
    for name in MAIN_PATH_KERNELS:
        results[name]["launches"] = launches[name]
        results[name]["launches_by_path"] = {
            p: c[name] for p, c in by_path.items() if c[name]}
        chain64 = name == "mulmod_chain"
        if chain64:
            t = selftest_t[-1]                   # the longest chain
            lanes = t["px"].shape[1]
            ms = time_ms(lambda: run_pair(name, t, False))
            b_ms, b_by = bound_ms(name, lanes, t["chain"])
            results[name].update(
                ms=ms, lanes=lanes, bound_ms=b_ms, bound_by=b_by,
                shape=f"selftest [16, {lanes}], n = {t['chain']}")
            emit("timing", name=name, shape=results[name]["shape"], ms=ms,
                 bound_ms=b_ms, bound_by=b_by)
        runs = []
        if name in ECDSA_KERNELS or chain64:
            runs.append(("chain64_" if chain64 else "", tensors))
        if name in SCHNORR_KERNELS:
            runs.append(("schnorr_" if name in ECDSA_KERNELS else "",
                         stensors))
        for pre, tset in runs:
            chain = (CHAIN_N if chain64 else
                     SHA_VERIFY_BLOCKS if name == "sha256" else 1)
            for n in sizes:
                ms = time_ms(lambda: run_pair(name, tset[n], False))
                b_ms, b_by = bound_ms(name, n, chain)
                results[name][f"{pre}ms_{n}"] = ms
                results[name][f"{pre}bound_ms_{n}"] = b_ms
                if n == sizes[0] and not pre:
                    results[name].update(ms=ms, lanes=n, bound_ms=b_ms,
                                         bound_by=b_by)
                emit("timing", name=pre + name, lanes=n, ms=ms,
                     bound_ms=b_ms, bound_by=b_by, lanes_per_s=n / ms * 1e3)
    for path, entry, data in (("ecdsa", ecdsa.verify, batches),
                              ("schnorr", schnorrsig.verify, sbatches)):
        for n in sizes:
            on_dev = [x.to(dev) for x in data[n][:3]]

            def whole():
                entry(*on_dev, device=dev)
                torch.cuda.synchronize()

            whole()
            walls = []
            for _ in range(5):
                t1 = time.perf_counter()
                whole()
                walls.append((time.perf_counter() - t1) * 1e3)
            ms = float(np.median(walls))
            emit("timing", name=f"{path}.verify", lanes=n, ms=ms,
                 verifies_per_s=n / ms * 1e3)
            # where the call's time goes: the card's kernels, by name
            wall, dev_ms, nkern, top = profile_call(whole)
            emit("profile", name=f"{path}.verify", lanes=n,
                 profiled_wall_ms=wall, device_ms=dev_ms, kernels=nkern,
                 device_busy_share=dev_ms / ms, top=top)

    emit("total", seconds=round(time.time() - t_start, 1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {**{k: results[name][k] for k in keys},
         **{k: v for k, v in results[name].items() if k not in keys}}
        for name in MAIN_PATH_KERNELS]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
