#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Drives the port's main path — ``context.selftest`` and batched ECDSA verify
(``modules.ecdsa.verify``) at 16,384 and 262,144 signatures — through the
entry points a user calls, builds the four hand-written kernels from the
sources in this checkout, holds each against its plain PyTorch version on
the card at every shape the main path gives it (exact equality: the values
are integers, the tolerance is 0), times them, and prints one JSON line
per phase.  Any failed phase raises: nothing is caught.  Without a CUDA
device the script exits non-zero and prints no result.

Bounds: ``bound_ms`` is the larger of bytes/3.35 TB/s (each operand read
once, each result written once) and operations/67 TOP/s, the card's
published non-tensor rate, with a 32-bit multiply-add counted as two
operations.  Only the arithmetic the function needs is counted (field
multiplies per doubling and addition, additions per window, divsteps per
inverse; written out in ``OPS`` below).  The full-table select scans are
a choice of the kernels, not arithmetic of k*G, and are not in the bound.

``mulmod_chain`` is on the main path only through ``context.selftest``
(one or two lanes, chains of 1 to 16 multiplies); its ``ms``, ``plain_ms``
and ``bound_ms`` are read at the longest of those.  The ``chain64_*`` keys
are a micro-benchmark of the field multiply at the verify batch sizes
(64 multiplies a lane), a shape the main path does not give it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from secp256k1_zkp_tpu_torch import context
from secp256k1_zkp_tpu_torch.modules import ecdsa
from secp256k1_zkp_tpu_torch.ops import (_build, cuda_field, cuda_gen,
                                         cuda_group, cuda_scalar)
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
OPS = {
    "mulmod_chain": MUL,          # per multiply of the chain
    # inverse, u1, u2, split (2 x 64 + 16 + 32 + one modular multiply)
    "ecdsa_prep": MODINV + 2 * SC_MUL + 2 * 64 + 48 + 2 * 120 + SC_MUL,
    # 37 rows, one mixed add each
    "fixedbase_digits": 37 * ADD_AFF,
    # table (1 double, 14 adds), global-Z pass, beta * x of the 16 entries,
    # 26 windows of 5 doublings and 2 mixed adds, join, check
    "ecmult_glv": (DOUBLE + 14 * ADD_AFF + MODINV + SQR + 3 * MUL
                   + 15 * (SQR + 5 * MUL) + 14 * MUL + 16 * MUL
                   + 26 * (5 * DOUBLE + 2 * ADD_AFF)
                   + ADD_JAC + SQR + 2 * MUL),
}
# 32-bit elements read + written per lane
WORDS = {
    "mulmod_chain": 3 * 16,
    "ecdsa_prep": 3 * 16 + 52 + 37 + 2,
    "fixedbase_digits": 37 + 3 * 16,
    "ecmult_glv": 52 + 3 + 6 * 16 + 3 * 16 + 2,
}
REPLACES = {
    "mulmod_chain": "secp256k1_zkp_tpu/ops/pallas_field.py:183",
    "ecdsa_prep": "secp256k1_zkp_tpu/ops/pallas_scalar.py:423",
    "fixedbase_digits": "secp256k1_zkp_tpu/ops/pallas_gen.py:114",
    "ecmult_glv": "secp256k1_zkp_tpu/ops/pallas_group.py:517",
}
SOURCES = {
    "mulmod_chain": "secp256k1_zkp_tpu_torch/csrc/mulmod_chain.cu",
    "ecdsa_prep": "secp256k1_zkp_tpu_torch/csrc/ecdsa_prep.cu",
    "fixedbase_digits": "secp256k1_zkp_tpu_torch/csrc/fixedbase.cu",
    "ecmult_glv": "secp256k1_zkp_tpu_torch/csrc/ecmult_glv.cu",
}
MAIN_PATH_KERNELS = tuple(OPS)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def bound_ms(name: str, lanes: int, chain: int = 1):
    """Least time for ``lanes`` lanes of kernel ``name`` (``chain``
    multiplies a lane for mulmod_chain), and what sets it."""
    t_bytes = WORDS[name] * 4 * lanes / PEAK_BYTES_PER_S
    t_ops = OPS[name] * chain * 2 * lanes / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


# --- host-built signatures --------------------------------------------------


def _limbs(x: int):
    return [(x >> (16 * i)) & MASK16 for i in range(16)]


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
    """The tensors each kernel sees on the main path, from a batch."""
    from secp256k1_zkp_tpu_torch.ops import field as F
    from secp256k1_zkp_tpu_torch.ops import scalar as S
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
    f = cuda_group.ecmult_glv_ref if use_ref else cuda_group.ecmult_glv
    return f(t["digs"], t["flags"], t["px"], t["py"], t["pinf"], t["gjac"],
             rx=t["r"])


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
         ptxas=ptxas[-24:])

    # -- phase 3: kernels against their plain versions ----------------------
    # the verify kernels at both main-path batches and at a ragged one;
    # mulmod_chain on the selftest's own operands (its main-path shapes)
    # and, as a micro-benchmark, at the verify batches
    t0 = time.time()
    base = make_distinct(distinct, args.seed)
    batches = {n: make_batch(base, n) for n in (*sizes, ragged)}
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
    selftest_t = [dict(px=x, py=y, chain=n)
                  for x, y, n, _ in context.selftest_operands(dev)]
    for t in selftest_t:
        err, plain_ms = compare("mulmod_chain", t)
        record("mulmod_chain", f"selftest [16, {t['px'].shape[1]}], "
               f"n = {t['chain']}", err, plain_ms)
        results["mulmod_chain"]["plain_ms"] = plain_ms      # longest last
    for n in (*sizes, ragged):
        for name in MAIN_PATH_KERNELS:
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
    bad = [k for k, v in results.items() if not v["match"]]
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")

    # -- phase 4: main path --------------------------------------------------
    _build.reset_launch_counts()
    context.selftest(dev)
    per_call = {}
    for n in sizes:
        msgs, sigs, pub, expect = batches[n]
        before = dict(_build.LAUNCH_COUNTS)
        ok = ecdsa.verify(msgs, sigs, pub, device=dev)
        torch.cuda.synchronize()
        assert ok.shape == (n,) and ok.dtype == torch.bool and ok.is_cuda
        wrong = int((ok.cpu().numpy() != expect).sum())
        per_call[n] = {k: _build.LAUNCH_COUNTS[k] - before[k]
                       for k in before}
        emit("main_path", lanes=n, valid=int(expect.sum()),
             accepted=int(ok.sum()), wrong_lanes=wrong,
             launches=per_call[n])
        if wrong:
            raise SystemExit(f"verify mask wrong on {wrong} of {n} lanes")
    launches = dict(_build.LAUNCH_COUNTS)
    idle = [k for k in MAIN_PATH_KERNELS if launches[k] < 1]
    if idle:
        raise SystemExit(f"main path never launched: {idle}")
    for n in sizes:
        for k in ("ecdsa_prep", "fixedbase_digits", "ecmult_glv"):
            assert per_call[n][k] == 1, (n, k, per_call[n])

    # -- phase 5: timing -----------------------------------------------------
    for name in MAIN_PATH_KERNELS:
        results[name]["launches"] = launches[name]
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
        for n in sizes:
            ms = time_ms(lambda: run_pair(name, tensors[n], False))
            b_ms, b_by = bound_ms(name, n, CHAIN_N if chain64 else 1)
            pre = "chain64_" if chain64 else ""
            results[name][f"{pre}ms_{n}"] = ms
            results[name][f"{pre}bound_ms_{n}"] = b_ms
            if n == sizes[0] and not chain64:
                results[name].update(ms=ms, lanes=n, bound_ms=b_ms,
                                     bound_by=b_by)
            emit("timing", name=pre + name, lanes=n, ms=ms, bound_ms=b_ms,
                 bound_by=b_by, lanes_per_s=n / ms * 1e3)
    for n in sizes:
        msgs, sigs, pub, _ = batches[n]
        on_dev = (msgs.to(dev), sigs.to(dev), pub.to(dev))

        def whole():
            ecdsa.verify(*on_dev, device=dev)
            torch.cuda.synchronize()

        whole()
        walls = []
        for _ in range(5):
            t1 = time.perf_counter()
            whole()
            walls.append((time.perf_counter() - t1) * 1e3)
        ms = float(np.median(walls))
        emit("timing", name="verify", lanes=n, ms=ms,
             verifies_per_s=n / ms * 1e3)

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
