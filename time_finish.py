#!/usr/bin/env python3
"""Time the MSM finish and the lane sum of the port on one NVIDIA GPU.

    python3 time_finish.py           # from the root of a checkout

Runs whichever version of ``secp256k1_zkp_tpu_torch`` the checkout holds,
so that two checkouts can be compared on one card, run in turns (parent,
change, change, parent) within one session.  It uses the checkout's
``chip_smoke.py`` for its data and timers, so both versions time the same
data the same way:

- the finish, by CUDA events (median of 15), on the window partials of
  batch verification's two MSMs (128- and 256-bit scalars) at 16,384 and
  262,144 signatures and of one 2^20-point MSM: ``cuda_msm.msm_finish``
  where it returns one point, and ``cuda_msm.msm_finish`` followed by
  ``cuda_msm.collapse`` (the seven ``gej_add`` launches that sum its 128
  lanes) where it returns 128 lanes;
- the lane sum ``ops.msm._tree_reduce`` on 65, 16,384 and 262,144 points
  (the tally's two sides);
- whole calls: ``schnorrsig.batch_verify`` at both sizes and
  ``msm.ecmult_multi`` at 2^20 points, the host clock around a call that
  ends in ``torch.cuda.synchronize()`` (median of 5) and the device ms and
  kernel count of one call under ``torch.profiler``.

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
from secp256k1_zkp_tpu_torch.modules import schnorrsig
from secp256k1_zkp_tpu_torch.ops import cuda_msm, msm
from secp256k1_zkp_tpu_torch.ops import group as G

SIZES = (16384, 262144)
SUM_LANES = (65, 16384, 262144)


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
        print("time_finish: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    one_point = not hasattr(cuda_msm, "collapse")

    def finish(args):
        out = cuda_msm.msm_finish(*args)
        return out if one_point else cuda_msm.collapse(*out)

    emit(name="version", finish_returns_one_point=one_point)
    t0 = time.time()
    sbase = cs.make_schnorr_distinct(2048, 42)
    target = {"msm_finish": (cuda_msm, "msm_finish")}
    for n in SIZES:
        inputs = cs.make_batch_verify(sbase, n)[0]["valid"]
        _, seen = cs.catch(lambda: schnorrsig.batch_verify(
            *inputs, device=dev), target)
        for args, _ in seen["msm_finish"]:
            ms = cs.time_ms(lambda: finish(args), reps=15)
            emit(name="finish", points=n, nwin=args[4],
                 nblk=args[0].shape[1] // args[4], ms=ms)
        whole("batch_verify", lambda: schnorrsig.batch_verify(
            *inputs, device=dev), lanes=n)
    ks, pts, _ = cs.make_msm(1 << 20, 42, dev)
    _, seen = cs.catch(lambda: msm.ecmult_multi(ks, pts, device=dev), target)
    args = seen["msm_finish"][0][0]
    emit(name="finish", points=1 << 20, nwin=args[4],
         nblk=args[0].shape[1] // args[4],
         ms=cs.time_ms(lambda: finish(args), reps=15))
    whole("ecmult_multi", lambda: msm.ecmult_multi(ks, pts, device=dev),
          points=1 << 20)
    gej = G.gej_from_ge(pts)
    for n in SUM_LANES:
        part = G.GEJ(*(type(c)(c.v[:n].contiguous(), c.bound)
                       for c in (gej.x, gej.y, gej.z)), gej.inf[:n])
        emit(name="tree_reduce", lanes=n,
             ms=cs.time_ms(lambda: msm._tree_reduce(part), reps=15))
    emit(name="total", seconds=round(time.time() - t0, 1))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
