#!/usr/bin/env python3
"""Time the port's hashes, ``lift_x``, the kernels on a batched inverse
and the calls around them on one NVIDIA GPU.

    python3 time_sha.py              # from the root of a checkout

Runs whichever version of ``secp256k1_zkp_tpu_torch`` the checkout holds,
so that two checkouts can be compared on one card, run in turns (parent,
change, change, parent) within one session.  It uses the checkout's
``chip_smoke.py`` for its data and timers, so both versions time the same
data the same way, at 16,384 and 262,144 lanes:

- by CUDA events (median of 15), the whole step however the version runs
  it: ``ecdsa.rfc6979_nonce`` (ECDSA signing's DRBG),
  ``schnorrsig.challenge`` (the tagged challenge hash),
  ``schnorrsig._batch_digest`` (the batch tree), the ``lift_x`` kernel on
  n and on 2n lanes (batch verify's P and R), ``affine_meta`` and
  ``affine_xy`` (the affine conversions), ``ecdsa_prep`` (ECDSA verify's
  scalars) and ``ecdsa_finish`` (ECDSA sign's R, k, m, d), each at the K
  its wrapper picks;
- whole calls: ``ecdsa.sign``, ``ecdsa.verify``, ``schnorrsig.sign``,
  ``schnorrsig.verify``,
  ``schnorrsig.batch_verify``, ``generator.pedersen_commit_bytes`` and
  ``ecdsa.recover`` (of the version's own signatures), the host clock
  around a call that ends in ``torch.cuda.synchronize()`` (median of 5),
  and the device ms and kernel count of one call under
  ``torch.profiler``.

Prints one JSON line per number, the card's name and power limit, and a
last line ``{"ok": true, ...}``.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from secp256k1_zkp_tpu_torch import context
from secp256k1_zkp_tpu_torch.modules import ecdsa, generator, schnorrsig
from secp256k1_zkp_tpu_torch.ops import cuda_field, cuda_gen, cuda_scalar

SIZES = (16384, 262144)


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def whole(label, fn, **kw) -> None:
    def call():
        fn()
        torch.cuda.synchronize()

    call()
    walls = []
    for _ in range(5):
        t1 = time.perf_counter()
        call()
        walls.append((time.perf_counter() - t1) * 1e3)
    _, dev_ms, kernels, _ = cs.profile_call(call)
    emit(name=label, ms=float(np.median(walls)), device_ms=dev_ms,
         kernels=kernels, **kw)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_sha: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.time()
    base = cs.make_distinct(2048, 42)
    sbase = cs.make_schnorr_distinct(2048, 42)
    gbase = cs.make_sign_distinct(2048, 42)
    gsbase = cs.make_ssign_distinct(2048, 42)
    pbase = cs.make_pedersen_distinct(2048, 42)
    # the sign path's blinding (sign_inputs' blinded comb operands)
    blind = context.Context(dev).randomize(bytes(32)).blind
    emit(name="data", seconds=round(time.time() - t0, 1))
    for n in SIZES:
        gbatch = cs.make_sign_batch(gbase, n)
        msgs, secs = (torch.as_tensor(a).to(dev) for a in gbatch[:2])
        smsgs, ssecs, sauxs = (torch.as_tensor(a).to(dev)
                               for a in cs.make_ssign_batch(gsbase, n)[:3])
        vmsgs, vsigs, vpxs = (torch.as_tensor(a).to(dev)
                              for a in cs.make_schnorr_batch(sbase, n)[:3])
        bmsgs, bsigs, bpxs = (torch.as_tensor(a).to(dev) for a in
                              cs.make_batch_verify(sbase, n)[0]["valid"])
        emsgs, esigs, epub = (a.to(dev) for a in cs.make_batch(base, n)[:3])
        et = cs.kernel_inputs(emsgs, esigs, epub, dev)
        gt = cs.sign_inputs(msgs, secs, blind, dev)
        vt = cs.schnorr_inputs(vmsgs, vsigs, vpxs, dev)
        px, rx = vt["px"], vt["rx"]
        px2 = torch.cat([px, rx], 1)
        steps = {
            "rfc6979_nonce": lambda: ecdsa.rfc6979_nonce(msgs, secs),
            "challenge": lambda: schnorrsig.challenge(
                vsigs[:, :32], vpxs, vmsgs),
            "batch_digest": lambda: schnorrsig._batch_digest(
                bmsgs, bsigs, bpxs, n),
            "lift_x": lambda: cuda_field.lift_x(px),
            "lift_x_2n": lambda: cuda_field.lift_x(px2),
            "affine_meta": lambda: cuda_field.affine_meta(px, rx, px),
            "affine_xy": lambda: cuda_gen.affine_xy(px, rx, px),
            "ecdsa_prep": lambda: cuda_scalar.ecdsa_prep(
                et["m"], et["r"], et["s"]),
            "ecdsa_finish": lambda: cuda_gen.ecdsa_sign_finish(
                *gt["gjac"], gt["k"], gt["m"], gt["d"]),
        }
        for label, fn in steps.items():
            emit(name=label, lanes=n, ms=cs.time_ms(fn, reps=15))
        whole("ecdsa.sign", lambda: ecdsa.sign(msgs, secs, device=dev),
              lanes=n)
        whole("ecdsa.verify", lambda: ecdsa.verify(emsgs, esigs, epub,
                                                   device=dev), lanes=n)
        whole("schnorr.sign", lambda: schnorrsig.sign(
            smsgs, ssecs, sauxs, device=dev), lanes=n)
        whole("schnorr.verify", lambda: schnorrsig.verify(
            vmsgs, vsigs, vpxs, device=dev), lanes=n)
        whole("schnorr.batch_verify", lambda: schnorrsig.batch_verify(
            bmsgs, bsigs, bpxs, device=dev), lanes=n)
        commit = [a.to(dev) for a in cs.make_pedersen_batch(pbase, n)[:4]]
        whole("generator.pedersen_commit_bytes",
              lambda: generator.pedersen_commit_bytes(*commit, device=dev),
              lanes=n)
        sig, recid, _ = ecdsa.sign(msgs, secs, device=dev)
        rec = [a.to(dev) for a in cs.make_recover_batch(
            gbatch[0], sig, recid, gbatch[4], gbatch[5])[:3]]
        whole("ecdsa.recover", lambda: ecdsa.recover(*rec, device=dev),
              lanes=n)
    emit(name="total", seconds=round(time.time() - t0, 1))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
