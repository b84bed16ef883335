#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Drives the port's main paths through the entry points a user calls —
``context.selftest``, batched ECDSA verify (``modules.ecdsa.verify``),
batched BIP-340 Schnorr verify (``modules.schnorrsig.verify``), batched
ECDSA sign (``modules.ecdsa.sign``) and batched BIP-340 sign
(``modules.schnorrsig.sign``), blinded by a ``context.Context`` and not,
each at 16,384 and 262,144 lanes, BIP-340 batch verification
(``modules.schnorrsig.batch_verify``) at the same sizes, a 2^20-point
multi-scalar multiplication (``ops.msm.ecmult_multi``), blinded NUMS
generators from 64 asset tags (``modules.generator.generator_generate``
and ``generator_serialize``, at 16,384), Pedersen commitments to them
(``generator.pedersen_commit_bytes``), the tally check
(``generator.pedersen_verify_tally``) and ECDSA public-key recovery
(``modules.ecdsa.recover``) at both sizes — builds the hand-written
kernels from the sources in this checkout, holds each (and the comb's
blinded and public entries, and ``gej_add``'s lane sum ``gej_sum``)
against its plain PyTorch version on the card at every shape those paths
give it (exact equality: the values are integers, the tolerance is 0;
the MSM engine's window partials and finish result and the lane sum's
result as points, since their jacobian form depends on the order of the
additions, and so the comb's lanes, whose thread teams add the rows in
another order, and their words where a launch runs one thread a lane),
checks every signature, generator and
commitment byte against one made on the host with Python integers,
``hashlib`` and ``hmac``, feeds the port's own signatures to its verify
and recovers their keys, checks batch verification's verdicts and its
right-hand point, the MSM and the tally verdicts against Python integers,
times the kernels and the calls, and prints one JSON line per phase.  Any
failed phase raises: nothing is caught.  Without a CUDA device the script
exits non-zero and prints no result.

Bounds: ``bound_ms`` is the larger of bytes/3.35 TB/s (each operand read
once, each result written once) and operations/67 TOP/s, the card's
published float32 rate outside the tensor cores, with a 32-bit
multiply-add counted as two operations — so a 32-bit integer
multiply-add is priced as a float32 FMA.  Only the arithmetic the
function needs is counted (field multiplies per doubling and addition,
additions per window, divsteps per inverse; written out in ``OPS``
below).  The full-table select scans are a choice of the kernels, not
arithmetic of k*G, and are not in the bound.  SHA-256 is counted in
32-bit logic and add operations, one operation each (a rotate is one;
``SHA_BLOCK`` below), i.e. half a multiply-add.

For ``ecmult_glv`` and ``msm_winreduce`` a second figure,
``bound_int_ms``, prices the same multiply-adds (``OPS``) at the integer
multiply-add rate: 64 a clock on each SM for compute capability 9.0 (the
CUDA programming guide's table of arithmetic instructions), half the
float32 rate, i.e. 67/4 = 16.75 T multiply-adds/s.  Phase ``build``
(key ``sass``) reads from ``cuobjdump -sass`` of a probe of
``fe_mul_to`` / ``fe_sqr_to`` how many instructions this build spends on
one field multiply and one squaring: the true multiplies (``IMAD``,
``IMAD.WIDE``, ``IMAD.HI``), the whole IMAD family (which also carries
adds with carry and shifts) and all instructions, less the probe's loads
and stores.  ``bound_ms`` stays the column that ranks the kernels.

Phase ``build`` fails if a redesigned kernel (``STACK_FREE``: B3, B13,
the comb's kernels, ``msm_table_kernel``, ``msm_finish_kernel``,
``gej_sum_kernel``, ``gej_add_kernel``, ``lift_x_kernel``, the three
new SHA-256 kernels, ``affine_xy_kernel``, ``affine_meta_kernel``,
``ecdsa_prep_kernel`` and ``ecdsa_finish_kernel``) reports a stack or a
spill in
``ptxas -v``, or if the comb's secret row scan spends more than about one
instruction (LOP3 or SEL) a word on its selects (``sass["scan"]``);
phase ``timing`` gives the warps per SM of their launches
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), a sweep of
``msm_winreduce``'s lane chunks (nblk) with the ``msm_finish`` that
follows, at 16,384, 262,144 and 2^20 points, and a sweep of the comb's
threads a lane (T = 1, 2, 4, 8; each T's points checked) at both sizes
beside the T the wrapper's rule picks, and a sweep of the lanes a thread
of the kernels on a batched inverse — the affine conversions,
``ecdsa_prep`` and ``ecdsa_finish`` — (K = 1, 2, 4, 8, 16, one inverse
per K lanes; each K's outputs checked) at both sizes beside the K of
their wrappers' rules (``GROUP_RULES``).

``msm_finish`` and ``gej_sum`` are bound by latency: a chain of additions
in sequence that no design can shorten.  Beside ``bound_ms`` they carry
``bound_lat_ms``, that chain priced by ``csrc/msm_finish.cu``'s latency
probe (a dependent chain of doublings, of doublings by a pair of threads
and of complete adds, on the same inlined core; ``lat_double_ms``,
``lat_pair_double_ms``, ``lat_add_ms``, the faster doubling counting):
for the finish 4(nwin - 1) doublings and ceil(log2 nwin) + ceil(log2
nblk) adds, for the lane sum ceil(B / threads) + ceil(log2 min(B,
threads)) adds, threads those of its launch.

``fixedbase_public`` is the comb's gather entry for public scalars
(verify, recover, batch verify): it must never run on a secret-scalar
path, and ``PATHS`` holds that — the sign, commit and generator paths
must launch it zero times.

``mulmod_chain`` is on the main path only through ``context.selftest``
(one or two lanes, chains of 1 to 16 multiplies); its ``ms``, ``plain_ms``
and ``bound_ms`` are read at the longest of those.  The ``chain64_*`` keys
are a micro-benchmark of the field multiply at the verify batch sizes
(64 multiplies a lane), a shape the main path does not give it.
SHA-256 has four entries on one compression core (``csrc/sha256.cu``),
each counted apart.  ``sha256`` (word-major blocks) runs twice in
``context.selftest`` (one block each); it is also held and timed on the
Schnorr challenge's two padded blocks, a shape no path gives it now.
``sha256_msg`` (a byte message to its digest, padding in the kernel) is
the tagged hash of each Schnorr verify (the 96-byte challenge), of each
Schnorr sign (aux, nonce, challenge), batch verify's challenges and
randomizers and the blinded generator's hash; ``rfc6979`` is ECDSA
signing's nonce DRBG, one launch a call; ``batch_digest`` batch
verification's tree, one launch a call.  Each is held against its plain
version on the operands of every launch of those paths (and
``batch_digest`` also at n = 1, 2, 3 and 262,143), and timed at the
verify and sign shapes with a bound of this run's compressions.
``lift_x`` lifts batch verification's P and R in one launch of 2n lanes;
beside ``bound_ms`` it carries ``bound_int_ms`` and ``bound_lat_ms``, the
latency of its chain (255 squarings and 14 multiplies in sequence, the
check's squaring among them) by the probe's ``lat_sqr_ms`` and
``lat_mul_ms``, and ``sass_static`` / ``sass_per_lane``: the instructions
of its kernel from ``cuobjdump -sass``, and that count with each of the
chain's squaring loops taken as often as it runs (251 squarings in 12
loops; the squaring's instructions from the ``sass`` probe; the loops' own
counter and branch not counted).  The blinded comb is also held on the lanes
k = n - b, 0, 1 and n - 1, the special cases of its last complete add.  ``fixedbase_blinded`` is ``csrc/fixedbase.cu``'s blinded
entry point (one more mixed add of -b*G), counted apart from the
unblinded one so that each shows its launches.

``affine_meta`` is held on the commit pipeline's jacobian results with
z = 0, the weak z = p + 1, the weak zero z = p and y = 0 on lanes 0-3, and
on the generator serializer's (x, y, 1); ``inv_n`` on the r of a signed
batch with 0, 1, n - 1, n + 2 and 2^256 - 1 on lanes 0-4.  Both affine
conversions (K lanes a thread, ``csrc/affine.cuh``) are also held on an
edge set cut from the commit path's lanes to a ragged 262,109
(``affine_edge_set``: z = 0 at the first, a middle and the last slot of
one thread's group, a group all at z = 0, z = p and p + 1, y = 0) at the
wrapper's K and at K = 1, 2, 3 and 8.  ``affine_meta`` reads y's
character by a Jacobi symbol with a capped trip count; the lanes it left
undecided (they take the square-root chain) are counted over the checks
and over the main paths (``jacobi_undecided``).  Beside ``bound_ms`` both
carry ``bound_int_ms`` and ``bound_lat_ms``: one lane's chain, an inverse,
a squaring and three multiplies (and, for ``affine_meta``, a Jacobi
symbol), by the latency probe's ``lat_inv_ms``, ``lat_jacobi_ms``,
``lat_sqr_ms`` and ``lat_mul_ms``.

``ecdsa_prep`` and ``ecdsa_finish`` take K lanes a thread too, with one
inverse over n (of s) and, for the finish, one over p (of Z) and one
over n (of the secret k) for the K lanes (``csrc/batch_inv.cuh``).  Each
is also held on an edge set cut to the same ragged 262,109 lanes at the
wrapper's K and at K = 1, 2, 3 and 8: ``prep_edge_set`` (s = 0 at the
first, a middle and the last slot of one thread's group and on another
whole group, s = 1, n - 1, m = 0) from the verify path's scalars,
``finish_edge_set`` (z = 0 and k = 0 likewise, z = p and p + 1, m = 0,
an affine x in [n, p)) from the sign path's operands.  Their ``OPS``
price each inverse at the function's least work, Montgomery's trick
over 32 lanes; beside ``bound_ms`` they carry ``bound_int_ms`` and
``bound_lat_ms``: one lane's chain by the latency probe (an inverse and
``PREP_LAT_MUL`` products; an inverse, a squaring and
``FINISH_LAT_MUL`` products).

The MSM engine's bounds count this run's data: ``msm_winreduce`` one mixed
add per nonzero digit of a finite point (zero digits and infinite points
add nothing), reading the table, digits and flags once; ``msm_finish`` one
accumulator's 4(nwin - 1) doublings and one jacobian add per partial (the
window sums and the join of the windows); ``gej_sum`` one jacobian add per
lane.  ``gej_add`` is read at batch verify's right-hand add (one lane) and
at the blinded generator's adds (16,384 lanes); ``gej_sum`` at the tally's
sums (16,384 and 262,144 lanes).
"""

from __future__ import annotations

import argparse
import hashlib
import hmac
import json
import re
import subprocess
import sys
import time
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from secp256k1_zkp_tpu_torch import context
from secp256k1_zkp_tpu_torch.modules import ecdsa, generator, schnorrsig
from secp256k1_zkp_tpu_torch.ops import (_build, cuda_field, cuda_gen,
                                         cuda_group, cuda_msm, cuda_scalar,
                                         cuda_sha256, msm)
from secp256k1_zkp_tpu_torch.ops import field as F
from secp256k1_zkp_tpu_torch.ops import group as G
from secp256k1_zkp_tpu_torch.ops import scalar as S
from secp256k1_zkp_tpu_torch.ops import sha256 as H
from secp256k1_zkp_tpu_torch.ops.group import GE
from secp256k1_zkp_tpu_torch.ops.limb import LB, MASK16
from secp256k1_zkp_tpu_torch.utils import hostcurve as hc

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
CHAIN_N = 64                      # multiplies a lane in the chain64 timing

# --- operation model (32-bit multiply-adds per lane) -----------------------
# bound_of prices each at the 67 TOP/s float32 rate (2 operations); the
# integer multiply-add rate is half that (PEAK_IMAD_PER_S, bound_int_ms)
PEAK_IMAD_PER_S = PEAK_OPS_PER_S / 4   # 64 IMAD a clock an SM, not 128
MUL = 64 + 8                      # 8x8 words + the fold by 977
SQR = 28 + 8 + 8                  # off-diagonal once, diagonal, fold
DOUBLE = 5 * SQR + 2 * MUL        # gej_double
ADD_AFF = 5 * SQR + 7 * MUL       # complete mixed add (7M + 5S)
ADD_JAC = 6 * SQR + 11 * MUL      # complete jacobian add
# safegcd: 20 batches of (30 divsteps of ~13 integer operations, counted as
# 13/2 multiply-adds, and 90 wide multiplies in the two limb updates)
MODINV = 20 * (30 * 13 // 2 + 90)
# the Jacobi symbol: the same divsteps and the f, g half of the limb updates
JACOBI = 20 * (30 * 13 // 2 + 45)
SC_MUL = 64 + 3 * 40              # 8x8 words + three folds by the 129-bit red
# a lane's inverse at the function's least work: Montgomery's trick over
# 32 lanes (3 products and 1/32 of one safegcd inverse), over p and over n
INV_TRICK_P = MODINV / 32 + 3 * MUL
INV_TRICK_N = MODINV / 32 + 3 * SC_MUL
# the affine conversion's least work a lane: the inverse, Z^-2, Z^-3, x
# and y
AFFINE = INV_TRICK_P + SQR + 3 * MUL
# GLV split: k*g1, k*g2 (8x8 each), c1*(-b1) (4x4), c2*(-b2) (4x8), their
# two reductions and the modular multiply by lambda
GLV_SPLIT = 2 * 64 + 48 + 2 * 120 + SC_MUL
# SHA-256, one block: 64 rounds of 26 logic/add operations (Sigma1 5, Ch 4,
# t1 4, Sigma0 5, Maj 5, 3 more adds), 48 schedule words of 13 (sigma0 5,
# sigma1 5, 3 adds), 8 final adds — counted one each, so halved here
SHA_BLOCK = (64 * 26 + 48 * 13 + 8) / 2
OPS = {
    "mulmod_chain": MUL,          # per multiply of the chain
    # the inverse of s (the trick), u1, u2, split
    "ecdsa_prep": INV_TRICK_N + 2 * SC_MUL + GLV_SPLIT,
    # 37 rows, one mixed add each (the scan's selects are not counted; nor
    # are a T-thread team's log2(T) joining adds: a choice of the kernel)
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
    # the inverse of Z (the trick), Z^-2, Z^-3, x and y; the inverse of k
    # (the trick), r*d, k^-1*u
    "ecdsa_finish": INV_TRICK_P + SQR + 3 * MUL + INV_TRICK_N + 2 * SC_MUL,
    "affine_xy": AFFINE,
    # e*d, and the negation and the sum (two 8-word carry chains)
    "muladd_n": SC_MUL + 2 * 8,
    # the 37 rows and the blinding point, one mixed add each
    "fixedbase_blinded": 38 * ADD_AFF,
    "gej_add": ADD_JAC,
    # per lane joined (msm_bound: B - 1 adds)
    "gej_sum": ADD_JAC,
    # 2P, 13 mixed adds with z-ratios; the inverses of the last Z by
    # Montgomery's trick over 32 lanes (3 multiplies a lane and one safegcd
    # inverse: the function's least work; the kernel inverts each lane,
    # which measured faster than an inverse shared by a block); entry 15:
    # b^2, b^3, x, y; entries 14..2: b = b * ratio, b^2, b^3, x, y
    "msm_table": (DOUBLE + 13 * ADD_AFF + 3 * MUL + MODINV / 32
                  + SQR + 3 * MUL + 13 * (SQR + 4 * MUL)),
    # per nonzero digit of a finite point (msm_bound)
    "msm_winreduce": ADD_AFF,
    # per doubling of the one accumulator (msm_bound: 4(nwin - 1) of them,
    # plus one ADD_JAC per partial)
    "msm_finish": DOUBLE,
    # the affine conversion and y's character, a Jacobi symbol
    "affine_meta": AFFINE + JACOBI,
    "inv_n": MODINV,
    # the comb's gather entry for public scalars: the same 37 mixed adds
    "fixedbase_public": 37 * ADD_AFF,
    # the SHA-256 entries: per compression (sha_bound counts them)
    "sha256_msg": SHA_BLOCK,
    "rfc6979": SHA_BLOCK,
    "batch_digest": SHA_BLOCK,
}
# 32-bit elements read + written per lane (the SHA-256 entries' bytes:
# sha_bound)
WORDS = {
    "mulmod_chain": 3 * 16,
    "ecdsa_prep": 3 * 16 + 52 + 37 + 2,
    "fixedbase_digits": 37 + 3 * 16,
    "ecmult_glv": 52 + 3 + 6 * 16 + 3 * 16 + 2,
    "lift_x": 16 + 16 + 1,
    "glv_only": 16 + 52 + 2,
    "schnorr_check": 4 * 16 + 1 + 1,
    "ecdsa_finish": 6 * 16 + 2 * 16 + 2,
    "affine_xy": 3 * 16 + 2 * 16,
    "muladd_n": 3 * 16 + 1 + 16,
    "fixedbase_blinded": 37 + 3 * 16,   # -b*G: 16 words for all lanes
    "gej_add": 3 * (3 * 16 + 1),
    "gej_sum": 3 * 16 + 1,        # read; the one point out is negligible
    "msm_table": 2 * 16 + 1 + 15 * 16,
    "affine_meta": 3 * 16 + 2 * 16 + 1,
    "inv_n": 16 + 16,
    "fixedbase_public": 37 + 3 * 16,
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
    "ecdsa_finish": "secp256k1_zkp_tpu/ops/pallas_gen.py:294",
    "affine_xy": "secp256k1_zkp_tpu/ops/pallas_gen.py:384",
    "muladd_n": "secp256k1_zkp_tpu/ops/pallas_gen.py:438",
    "fixedbase_blinded": "secp256k1_zkp_tpu/ops/pallas_gen.py:114 "
                         "(blinded, tail at :162-165)",
    "gej_add": "secp256k1_zkp_tpu/ops/pallas_group.py:326",
    # the add kernel summing a batch: the JAX _tree_reduce's levels
    "gej_sum": "secp256k1_zkp_tpu/ops/pallas_group.py:326 (as the lane sum "
               "of ops/msm.py:46 _tree_reduce)",
    "msm_table": "secp256k1_zkp_tpu/ops/pallas_msm.py:58",
    "msm_winreduce": "secp256k1_zkp_tpu/ops/pallas_msm.py:131",
    "msm_finish": "secp256k1_zkp_tpu/ops/pallas_msm.py:224 "
                  "(+ _collapse128 at :324)",
    "affine_meta": "secp256k1_zkp_tpu/ops/pallas_field.py:431",
    "inv_n": "secp256k1_zkp_tpu/ops/pallas_scalar.py:157",
    "fixedbase_public": "secp256k1_zkp_tpu/ops/pallas_gen.py:114 "
                        "(public digits: the named entry, no scan)",
    "sha256_msg": "none: XLA glue (secp256k1_zkp_tpu/ops/sha256.py:279 "
                  "sha256_bytes, :304 tagged_hash_bytes; no Pallas kernel)",
    "rfc6979": "none: XLA glue (secp256k1_zkp_tpu/ops/sha256.py:201 "
               "RFC6979; no Pallas kernel)",
    "batch_digest": "none: XLA glue (secp256k1_zkp_tpu/modules/"
                    "schnorrsig.py:124 _batch_digest; no Pallas kernel)",
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
    "ecdsa_finish": "secp256k1_zkp_tpu_torch/csrc/ecdsa_finish.cu",
    "affine_xy": "secp256k1_zkp_tpu_torch/csrc/affine_xy.cu",
    "muladd_n": "secp256k1_zkp_tpu_torch/csrc/muladd_n.cu",
    "fixedbase_blinded": "secp256k1_zkp_tpu_torch/csrc/fixedbase.cu",
    "gej_add": "secp256k1_zkp_tpu_torch/csrc/gej_add.cu",
    "gej_sum": "secp256k1_zkp_tpu_torch/csrc/gej_add.cu",
    "msm_table": "secp256k1_zkp_tpu_torch/csrc/msm_table.cu",
    "msm_winreduce": "secp256k1_zkp_tpu_torch/csrc/msm_winreduce.cu",
    "msm_finish": "secp256k1_zkp_tpu_torch/csrc/msm_finish.cu",
    "affine_meta": "secp256k1_zkp_tpu_torch/csrc/affine_meta.cu",
    "inv_n": "secp256k1_zkp_tpu_torch/csrc/inv_n.cu",
    "fixedbase_public": "secp256k1_zkp_tpu_torch/csrc/fixedbase.cu",
    "sha256_msg": "secp256k1_zkp_tpu_torch/csrc/sha256.cu",
    "rfc6979": "secp256k1_zkp_tpu_torch/csrc/sha256.cu",
    "batch_digest": "secp256k1_zkp_tpu_torch/csrc/sha256.cu",
}
MAIN_PATH_KERNELS = tuple(OPS)
# the __global__ function of each redesigned kernel: its ptxas -v must read
# 0 bytes stack and 0 spills
KERNEL_FUNCS = {"ecmult_glv": "ecmult_glv_kernel",
                "msm_winreduce": "msm_winreduce_kernel",
                "fixedbase_digits": "fixedbase_kernel",
                "fixedbase_blinded": "fixedbase_blinded_kernel",
                "fixedbase_public": "fixedbase_public_kernel",
                "msm_table": "msm_table_kernel",
                "msm_finish": "msm_finish_kernel",
                "gej_sum": "gej_sum_kernel",
                "gej_add": "gej_add_kernel",
                "lift_x": "lift_x_kernel",
                "sha256_msg": "sha256_msg_kernel",
                "rfc6979": "rfc6979_kernel",
                "batch_digest": "batch_digest_kernel",
                "affine_xy": "affine_xy_kernel",
                "affine_meta": "affine_meta_kernel",
                "ecdsa_prep": "ecdsa_prep_kernel",
                "ecdsa_finish": "ecdsa_finish_kernel"}
STACK_FREE = tuple(KERNEL_FUNCS.values())
ECDSA_KERNELS = ("ecdsa_prep", "fixedbase_public", "ecmult_glv")
SCHNORR_KERNELS = ("sha256_msg", "lift_x", "glv_only", "fixedbase_public",
                   "ecmult_glv", "schnorr_check")
# the SHA-256 entries, timed apart (sha_bound); their warps an SM by
# secp_sha256_warps' op
SHA_KERNELS = ("sha256", "sha256_msg", "rfc6979", "batch_digest")
SHA_WARPS_OP = {"sha256_msg": 0, "rfc6979": 1, "batch_digest": 2}
# lift_x's chain: squarings and multiplies in sequence, and the squarings
# of its 12 loops
LIFT_SQR, LIFT_MUL, LIFT_LOOP_SQR, LIFT_LOOPS = 255, 14, 251, 12
# batch_digest's edge batches, cut from the operands of 262,144
DIGEST_EDGE_N = (1, 2, 3, 262143)
SIGN_KERNELS = ("ecdsa_finish", "affine_xy", "muladd_n", "fixedbase_blinded",
                "fixedbase_digits")
# the comb's three entries: (kernel mode, blinded)
COMB_KERNELS = {"fixedbase_digits": (cuda_gen.COMB_SCAN, False),
                "fixedbase_blinded": (cuda_gen.COMB_SCAN, True),
                "fixedbase_public": (cuda_gen.COMB_GATHER, False)}
MSM_KERNELS = ("msm_table", "msm_winreduce", "msm_finish")
COMMIT_RECOVER_KERNELS = ("affine_meta", "inv_n")
# the lanes a thread of the kernels on a batched inverse (the affine
# conversions, ecdsa_prep, ecdsa_finish): the edge sets' lanes (ragged for
# every K > 1 below), the K they run at beside the wrapper's, the K swept
AFFINE_EDGE_LANES = 262144 - 35
AFFINE_EDGE_GROUPS = (1, 2, 3, 8)
AFFINE_SWEEP = (1, 2, 4, 8, 16)
# the K rule of each batched-inverse kernel, and the warps an SM reported
# for its launches
GROUP_RULES = {"affine_xy": cuda_field.affine_group,
               "affine_meta": cuda_field.affine_group,
               "ecdsa_prep": cuda_scalar.prep_group,
               "ecdsa_finish": cuda_gen.finish_group}
# the ECDSA kernels' lane chains for bound_lat_ms: ecdsa_prep s^-1, u2 and
# the split's three products in sequence; ecdsa_finish the inverses (Z and
# k side by side), Z^-2, x, r*d and k^-1 (m + r d); scalar products priced
# as field products (the same 8x8 words, lighter folds: a floor)
PREP_LAT_MUL = 4
FINISH_LAT_MUL = 3
# gej_sum's edge sets: these lane counts, and two lanes P, -P
SUM_EDGE_LANES = (1, 2, 3, 65, 1024 + 37, 262144)
MSM_POINTS = 1 << 20              # bench.py's msm_points_per_s shape
# msm_winreduce chunk counts timed beside the chosen one: at 64 windows
# from about two warps an SM of 132 (one block an SM at most) to many waves
NBLK_SWEEP = (4, 8, 16, 33, 66, 132, 264, 528, 1056, 2112)
ASSET_TAGS = 64                   # generators made from this many tags
# the tally's negative side: one commitment per asset tag and one that
# carries the blinds
TALLY_NEG_LANES = ASSET_TAGS + 1
# the kernels each path must launch, and how often a call
PATHS = {"selftest": {"mulmod_chain": 4, "sha256": 2},
         "ecdsa": {k: 1 for k in ECDSA_KERNELS},
         "schnorr": {k: 1 for k in SCHNORR_KERNELS},
         # the RFC6979 DRBG (two candidates) in one launch
         "ecdsa_sign": {"rfc6979": 1, "fixedbase_digits": 1,
                        "ecdsa_finish": 1},
         "ecdsa_sign_blinded": {"rfc6979": 1, "fixedbase_blinded": 1,
                                "ecdsa_finish": 1},
         # the keypair's d*G and the nonce's k*G; tagged hashes aux, nonce
         # and challenge
         "schnorr_sign": {"fixedbase_digits": 2, "affine_xy": 2,
                          "sha256_msg": 3, "muladd_n": 1},
         "schnorr_sign_blinded": {"fixedbase_blinded": 2, "affine_xy": 2,
                                  "sha256_msg": 3, "muladd_n": 1},
         # BIP-340 batch verify of n signatures, whatever n: the lifts of P
         # and R in one launch; the tagged hashes of the challenges and of
         # the randomizers; the batch digest (leaves and every level); z*e
         # and z*s; two MSMs (table, window reduce, finish); rhs = their sum
         # by gej_add; (sum z s)*G by the comb's gather entry
         "schnorr_batch": {
             "sha256_msg": 2, "batch_digest": 1, "lift_x": 1,
             "muladd_n": 2, "fixedbase_public": 1, "msm_table": 2,
             "msm_winreduce": 2, "msm_finish": 2, "gej_add": 1},
         "msm": {"msm_table": 1, "msm_winreduce": 1, "msm_finish": 1},
         # b*G by the comb, v*H + b*G by GLV Strauss, the 33 bytes
         "pedersen": {"fixedbase_digits": 1, "ecmult_glv": 1,
                      "affine_meta": 1},
         # both hashes in one launch (svdw is eager glue), H1 + H2 and
         # + b*G, b*G by the comb, the affine point, its serialization
         "generator_blinded": {"sha256_msg": 1, "gej_add": 2,
                               "fixedbase_digits": 1, "affine_xy": 1,
                               "affine_meta": 1},
         # r^-1, R's y, u1 and u2 (one launch), u2's split, u1*G, Q, affine
         "recover": {"inv_n": 1, "lift_x": 1, "muladd_n": 1, "glv_only": 1,
                     "fixedbase_public": 1, "ecmult_glv": 1,
                     "affine_xy": 1},
         # one lane sum for each side
         "tally": {"gej_sum": 2}}


def path_launches(path: str, lanes: int) -> dict:
    want = PATHS[path]
    return want(lanes) if callable(want) else want


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def ptxas_summary(log: str) -> dict:
    """``nvcc -Xptxas -v`` output -> {kernel: {registers, stack (cumulative
    bytes), frame, spill_stores, spill_loads}} for each ``__global__``
    entry function."""
    out, cur, props, pending = {}, None, {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", ln)
        if m:
            cur = ("_Z" + m.group(1) + m.group(2),
                   m.group(2)[:int(m.group(1))])
            continue
        m = re.search(r"Function properties for (\w+)", ln)
        if m:
            pending = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and pending:
            props[pending] = tuple(int(g) for g in m.groups())
            pending = None
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes cumulative "
                      r"stack size)?", ln)
        if m and cur:
            frame, st, ld = props.get(cur[0], (0, 0, 0))
            out[cur[1]] = dict(registers=int(m.group(1)),
                               stack=int(m.group(2) or 0), frame=frame,
                               spill_stores=st, spill_loads=ld)
            cur = None
    return out


# the field multiply and squaring of fe.cuh and the comb's row scan of
# comb.cuh as they compile into a kernel, and the same loads and stores
# without them, for the SASS count
SASS_PROBE = r"""
#include "comb.cuh"
__global__ void probe_mul(const fe* a, const fe* b, fe* r) {
    int i = threadIdx.x;
    fe x = a[i], y = b[i], z;
    fe_mul_to(z, x, y);
    r[i] = z;
}
__global__ void probe_mul_base(const fe* a, const fe* b, fe* r) {
    int i = threadIdx.x;
    fe x = a[i], y = b[i], z;
    for (int w = 0; w < 8; ++w) z.v[w] = x.v[w] ^ y.v[w];
    r[i] = z;
}
__global__ void probe_sqr(const fe* a, fe* r) {
    int i = threadIdx.x;
    fe x = a[i], z;
    fe_sqr_to(z, x);
    r[i] = z;
}
__global__ void probe_sqr_base(const fe* a, fe* r) {
    int i = threadIdx.x;
    r[i] = a[i];
}
__global__ void probe_scan(const uint32_t* row, const uint32_t* mag, fe* r) {
    int i = threadIdx.x;
    fe x, y;
    comb_scan(row, mag[i], x, y);
    r[2 * i] = x;
    r[2 * i + 1] = y;
}
__global__ void probe_scan_base(const uint32_t* row, const uint32_t* mag,
                                fe* r) {
    int i = threadIdx.x;
    fe x, y;
    comb_gather(row, mag[i], x, y);
    r[2 * i] = x;
    r[2 * i + 1] = y;
}
"""


def sass_counts() -> dict:
    """Compile SASS_PROBE for sm_90a and count, from ``cuobjdump -sass``,
    the instructions of one field multiply and one squaring: true
    multiplies ("mul": IMAD, IMAD.U32, IMAD.WIDE*, IMAD.HI*), the IMAD
    family ("imad": those and IMAD.X, IMAD.SHL, IMAD.IADD, ...; not
    IMAD.MOV, a register move) and all ("all").  For the comb's row scan
    (``scan``): its word selects (LOP3 and SEL) per word of the entries it
    scans past the first (four words a 16-byte load), and its branches
    (the loop's own; none may test a digit).  For ``lift_x`` its kernel's
    instructions (``sass_static``) and an estimate of those a lane runs
    (``sass_per_lane``: module docstring)."""
    nvcc = _build.find_nvcc()
    work = _build.BUILD_DIR / "sass_probe"
    work.mkdir(parents=True, exist_ok=True)
    src, cubin = work / "probe.cu", work / "probe.cubin"
    src.write_text(SASS_PROBE)
    subprocess.run([nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-I", str(_build.SRC_DIR), str(src),
                    "-o", str(cubin)], check=True, capture_output=True)
    counts = _sass_by_function(nvcc, cubin)
    # lift_x's kernel as the build compiles it
    lcubin = work / "lift_x.cubin"
    subprocess.run([nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-I", str(_build.SRC_DIR),
                    str(_build.SRC_DIR / "lift_x.cu"), "-o", str(lcubin)],
                   check=True, capture_output=True)
    lift = _sass_by_function(nvcc, lcubin)["lift_x_kernel"]["all"]
    out = {k: {c: counts[f"probe_{k}"][c] - counts[f"probe_{k}_base"][c]
               for c in ("mul", "imad", "all")} for k in ("mul", "sqr")}
    scan, base = counts["probe_scan"], counts["probe_scan_base"]
    words = 4 * (scan["ldg128"] - base["ldg128"])
    out["scan"] = dict(selects=scan["select"] - base["select"],
                       words=words, branches=scan["branch"],
                       selects_per_word=(scan["select"] - base["select"])
                       / max(words, 1))
    out["lift_x"] = dict(sass_static=lift, sass_per_lane=lift + (
        LIFT_LOOP_SQR - LIFT_LOOPS) * out["sqr"]["all"])
    return out


def _sass_by_function(nvcc: str, cubin: Path) -> dict:
    """``cuobjdump -sass`` of ``cubin`` -> {function: counts} (module
    docstring, :func:`sass_counts`)."""
    dump = subprocess.run(
        [str(Path(nvcc).with_name("cuobjdump")), "-sass", str(cubin)],
        check=True, capture_output=True, text=True).stdout
    counts, cur = {}, None
    for ln in dump.splitlines():
        m = re.search(r"Function : _Z(\d+)(\w+)", ln)
        if m:
            name = m.group(2)[:int(m.group(1))]
            cur = counts.setdefault(name, dict.fromkeys(
                ("mul", "imad", "all", "select", "ldg128", "branch"), 0))
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", ln)
        if m and cur is not None and m.group(1) != "NOP":
            cur["all"] += 1
            op = m.group(1)
            cur["imad"] += op.startswith("IMAD") and not op.startswith(
                "IMAD.MOV")
            cur["mul"] += op in ("IMAD", "IMAD.U32") or op.startswith(
                ("IMAD.WIDE", "IMAD.HI"))
            cur["select"] += op.startswith(("LOP3", "SEL"))
            cur["ldg128"] += op.startswith("LDG") and ".128" in op
            cur["branch"] += op.startswith(("BRA", "BRX", "JMP"))
    return counts


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


def bound_of(madds: float, nbytes: float):
    """Least time in ms for ``madds`` 32-bit multiply-adds and ``nbytes``
    of traffic, and what sets it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = madds * 2 / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def bound_ms(name: str, lanes: int, chain: int = 1):
    """Least time for ``lanes`` lanes of kernel ``name`` (``chain``
    multiplies a lane for mulmod_chain), and what sets it."""
    return bound_of(OPS[name] * chain * lanes, WORDS[name] * 4 * lanes)


def int_bound(name: str, units: int) -> float:
    """Least ms for ``units`` lanes (adds, for msm_winreduce) of kernel
    ``name``'s multiply-adds (``OPS``) at the integer multiply-add rate."""
    return units * OPS[name] / PEAK_IMAD_PER_S * 1e3


def sha_compressions(name: str, t: dict) -> int:
    """Compressions of one launch of a SHA-256 entry on the operands
    ``t``, counted from this run's data."""
    if name == "sha256":
        return t["sha_blocks"].shape[0] // 16 * t["sha_blocks"].shape[1]
    if name == "sha256_msg":
        lanes, L = t["sha_msg"].shape
        return lanes * ((L + 9 + 63) // 64)
    if name == "rfc6979":
        r = t["rounds"]
        return t["keydata"].shape[0] * (14 + 2 * r + 6 * (r - 1))
    n, nodes, k = t["px"].shape[0], 0, t["px"].shape[0]
    while k > 1:
        k = (k + 1) // 2
        nodes += k
    return 3 * n + 2 * nodes


def sha_bound(name: str, t: dict):
    """Least time of one launch of a SHA-256 entry on ``t``: its
    compressions (``SHA_BLOCK`` each) and the bytes it must read and
    write."""
    if name == "sha256":
        nbytes = 4 * (t["sha_blocks"].numel() + 2 * t["sha_state"].numel())
    elif name == "sha256_msg":
        lanes, L = t["sha_msg"].shape
        nbytes = lanes * (L + 32 + (32 if t.get("sha_lane") is not None
                                    else 0))
    elif name == "rfc6979":
        nbytes = t["keydata"].shape[0] * (64 + 32 * t["rounds"])
    else:
        nbytes = 128 * t["px"].shape[0] + 32
    return bound_of(sha_compressions(name, t) * SHA_BLOCK, nbytes)


def msm_bound(name: str, t: dict):
    """Least time of one MSM-engine launch on the operands ``t``, from
    what this run's data needs (module docstring)."""
    if name == "msm_winreduce":
        nwin, lanes = t["digs"].shape
        nnz = int(((t["digs"] != 0) & ~t["pinf"][None, :]).sum())
        parts = nwin * t["nblk"]
        return bound_of(nnz * OPS[name],
                        4 * (lanes * (15 * 16 + 1) + nwin * lanes
                             + parts * 49))
    if name == "msm_finish":
        parts = t["x"].shape[1]
        return bound_of(4 * (t["nwin"] - 1) * OPS[name] + parts * ADD_JAC,
                        4 * 49 * (parts + 1))
    if name == "gej_sum":
        lanes = t["x"].shape[1]
        return bound_of((lanes - 1) * OPS[name], 4 * 49 * (lanes + 1))
    if name == "gej_add":
        return bound_ms(name, t["a"][0].shape[1])
    return bound_ms(name, t["px"].shape[1])


def _log2_ceil(n: int) -> int:
    return (n - 1).bit_length()


def latency_ms(lib, dev) -> dict:
    """ms of one operation in a dependent chain on one thread
    (``secp_latency_probe``, the inlined core): a doubling, a complete
    add, a doubling by a pair of threads, a field squaring, a field
    multiply, a safegcd inverse and a Jacobi symbol (of G's x and of it
    with bit 0 flipped).  The slope of CUDA-event times of chains of 256
    and 2,048, from G."""
    io = torch.tensor([w - (1 << 32) if w >= 1 << 31 else w for c in (
        hc.GX, hc.GY, 1) for w in ((c >> (32 * i)) & 0xFFFFFFFF
                                   for i in range(8))] + [0],
        dtype=torch.int32, device=dev)
    out = {}
    for op, key in ((0, "lat_double_ms"), (1, "lat_add_ms"),
                    (2, "lat_pair_double_ms"), (3, "lat_sqr_ms"),
                    (4, "lat_mul_ms"), (5, "lat_inv_ms"),
                    (6, "lat_jacobi_ms")):
        def chain(n):
            _build.check(lib.secp_latency_probe(io.data_ptr(), op, n,
                                                _build.stream_ptr()),
                         "latency_probe")
        lo, hi = (time_ms(lambda: chain(n), reps=9) for n in (256, 2048))
        out[key] = (hi - lo) / (2048 - 256)
    return out


def bound_lat_ms(name: str, t: dict, lat: dict) -> float:
    """The least time of the chain of additions in sequence that ``name``
    must run on ``t`` (module docstring), priced by :func:`latency_ms`;
    for the affine conversions one lane's chain."""
    if name in ("affine_xy", "affine_meta"):
        chain = lat["lat_inv_ms"] + lat["lat_sqr_ms"] + 3 * lat["lat_mul_ms"]
        return chain + (lat["lat_jacobi_ms"] if name == "affine_meta" else 0)
    if name == "ecdsa_prep":
        return lat["lat_inv_ms"] + PREP_LAT_MUL * lat["lat_mul_ms"]
    if name == "ecdsa_finish":
        return (lat["lat_inv_ms"] + lat["lat_sqr_ms"]
                + FINISH_LAT_MUL * lat["lat_mul_ms"])
    if name == "msm_finish":
        nwin = t["nwin"]
        nblk = t["x"].shape[1] // nwin
        double = min(lat["lat_double_ms"], lat["lat_pair_double_ms"])
        return (4 * (nwin - 1) * double
                + (_log2_ceil(nwin) + _log2_ceil(nblk)) * lat["lat_add_ms"])
    lanes = t["x"].shape[1]
    threads = cuda_group.SUM_THREADS * cuda_group.sum_blocks(
        lanes, torch.cuda.get_device_properties(0).multi_processor_count)
    return ((-(-lanes // threads) + _log2_ceil(min(lanes, threads)))
            * lat["lat_add_ms"])


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
    its R's odd y with its msg and key, the secrets (d, k) with even-y
    points behind each signature)."""
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
    secrets = []
    for i in range(distinct):
        d = ds[i] if Pa[i][1] % 2 == 0 else hc.N - ds[i]
        k = ks[i] if Ra[i][1] % 2 == 0 else hc.N - ks[i]
        secrets.append((d, k))
        r32, px32, msg = _i32(Ra[i][0]), _i32(Pa[i][0]), bytes(msgs[i])
        s = (k + _challenge(r32, px32, msg) * d) % hc.N
        sigs[i] = np.frombuffer(r32 + _i32(s), np.uint8)
        pxs[i] = np.frombuffer(px32, np.uint8)
        if odd_r is None and Ra[i][1] % 2:
            # the nonce left unnegated: s*G - e*P is R itself, odd y
            s_odd = (ks[i] + _challenge(r32, px32, msg) * d) % hc.N
            odd_r = (msg, r32 + _i32(s_odd), px32)
    return msgs, sigs, pxs, odd_r, secrets


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
    msgs, sigs, pxs, odd_r, _ = base
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


# --- batch verification: batches, verdicts and the right-hand point -------


def host_randomizers(msgs, sigs, pxs):
    """The batch randomizers z_i with ``hashlib`` (zero seed): leaf hashes
    of pk || msg || sig, a tree of node hashes with a zero node padding each
    odd level, z_i = H_tag(seed || root || i) mod 2^128, z_0 = 1."""
    nodes = [_tagged("BIP0340/batch/leaf", p.tobytes() + m.tobytes()
                     + s.tobytes()) for p, m, s in zip(pxs, msgs, sigs)]
    while len(nodes) > 1:
        if len(nodes) % 2:
            nodes.append(bytes(32))
        nodes = [_tagged("BIP0340/batch/node", a + b)
                 for a, b in zip(nodes[::2], nodes[1::2])]
    pre = bytes(32) + nodes[0]
    z = [int.from_bytes(_tagged("BIP0340/batch", pre + i.to_bytes(4, "big")),
                        "big") % (1 << 128) for i in range(len(msgs))]
    z[0] = 1
    return z


def make_batch_verify(base, lanes: int):
    """Batches of ``lanes`` BIP-340 signatures tiled from ``base``: the valid
    one and one broken in each way (a flipped s byte, a flipped message
    byte, a key x off the curve, r >= p, and the two-lane cancellation
    forgery s_0 += z_1 t, s_1 -= t with z of the valid batch), as
    {label: (msg32, sig64, px32 on the CPU)}, and the point the valid
    batch's right-hand side must be, (sum z_i k_i + z_i e_i d_i) * G, from
    Python ints and ``hashlib``."""
    msgs, sigs, pxs, _, secrets = base
    msgs, sigs, pxs = (_tile(a, lanes) for a in (msgs, sigs, pxs))
    z = host_randomizers(msgs, sigs, pxs)
    acc = 0
    for i in range(lanes):
        d, k = secrets[i % len(secrets)]
        e = _challenge(sigs[i, :32].tobytes(), pxs[i].tobytes(),
                       msgs[i].tobytes())
        acc += z[i] * (k + e * d)
    rhs = hc.mul(acc % hc.N)
    out = {"valid": (msgs, sigs, pxs)}

    def broken(label, lane, fn):
        m, s, p = msgs.copy(), sigs.copy(), pxs.copy()
        fn(m, s, p, lane)
        out[label] = (m, s, p)

    def flip_s(m, s, p, j):
        s[j, 40] ^= 1

    def flip_msg(m, s, p, j):
        m[j, 0] ^= 1

    def off_curve(m, s, p, j):
        p[j] = np.frombuffer(_i32(_not_on_curve_x()), np.uint8)

    def r_ge_p(m, s, p, j):
        r = hc.P + int.from_bytes(s[j, :32].tobytes(), "big") \
            % (2 ** 256 - hc.P)
        s[j, :32] = np.frombuffer(_i32(r), np.uint8)

    def forgery(m, s, p, j):
        t = 0xDEADBEEF
        s0 = int.from_bytes(sigs[j, 32:].tobytes(), "big")
        s1 = int.from_bytes(sigs[j + 1, 32:].tobytes(), "big")
        s[j, 32:] = np.frombuffer(_i32((s0 + z[j + 1] * t) % hc.N), np.uint8)
        s[j + 1, 32:] = np.frombuffer(_i32((s1 - t) % hc.N), np.uint8)

    for label, lane, fn in (("flipped s byte", lanes // 2, flip_s),
                            ("flipped msg", lanes - 1, flip_msg),
                            ("key x off the curve", 3, off_curve),
                            ("r >= p", 5, r_ge_p), ("forgery", 0, forgery)):
        broken(label, lane, fn)
    return {k: tuple(torch.from_numpy(a) for a in v)
            for k, v in out.items()}, rhs


def make_msm(points: int, seed: int, dev):
    """``points`` points P_i = a_i * G made on the card by the comb and
    ``affine_xy`` (one of them infinite), 256-bit scalars k_i (one 0, a few
    with zero digits), and the sum (sum k_i a_i mod n) * G in Python ints.
    Returns (ks ``LB``, pts ``GE`` on the card, affine sum)."""
    rng = np.random.default_rng(seed + 4)
    a = rng.integers(0, 1 << 16, (points, 16), dtype=np.int64)
    a[:, 15] &= 0x7FFF                       # a_i < 2^255 < n
    k = rng.integers(0, 1 << 16, (points, 16), dtype=np.int64)
    k[: points // 8, 3] &= 0xF00F            # zero digits
    k[1] = 0
    inf = 2
    ax, ay = cuda_gen.affine_xy(*cuda_gen.ecmult_gen(
        torch.from_numpy(a.T.astype(np.int32)).to(dev).contiguous()))
    pinf = torch.zeros(points, dtype=torch.bool, device=dev)
    pinf[inf] = True
    pts = GE(ecdsa.from_rows(ax), ecdsa.from_rows(ay), pinf)
    ai = [int.from_bytes(r.astype("<u2").tobytes(), "little") for r in a]
    ki = [int.from_bytes(r.astype("<u2").tobytes(), "little") for r in k]
    want = sum(kk * aa for i, (kk, aa) in enumerate(zip(ki, ai))
               if i != inf) % hc.N
    return (LB(torch.from_numpy(k).to(dev), MASK16), pts,
            hc.mul(want) if want else None)


# --- Pedersen commitments, generators, recovery: what the port must make ---

_SVDW_C = pow(hc.P - 3, (hc.P + 1) // 4, hc.P)      # sqrt(-3)
_SVDW_D = (_SVDW_C - 1) * pow(2, -1, hc.P) % hc.P


def _host_svdw(t: int):
    """The SvdW map with the reference's tie-breaking: x1 if its x^3 + 7 is
    a square, else x2, else x3; y the principal root, negated for odd t
    (modules/generator/main_impl.h:94-202)."""
    P = hc.P
    t2 = t * t % P
    wd = (8 + t2) % P
    x3d = -3 * t2 % P
    jinv = pow(wd * x3d % P, P - 2, P)          # 0 at t = 0
    x1 = (_SVDW_D - _SVDW_C * t2 % P * x3d % P * jinv) % P
    x2 = -(x1 + 1) % P
    x3 = (1 + wd * wd % P * wd % P * jinv) % P
    for x in (x1, x2, x3):
        y = pow((x ** 3 + 7) % P, (P + 1) // 4, P)
        if y * y % P == (x ** 3 + 7) % P:
            break
    return x, (P - y if t & 1 else y)


def _host_generator(key32: bytes):
    """The NUMS generator of a key: svdw(SHA256("1st generation: " || key))
    + svdw(SHA256("2nd generation: " || key))."""
    ts = [int.from_bytes(hashlib.sha256(pre + key32).digest(), "big")
          for pre in (b"1st generation: ", b"2nd generation: ")]
    assert max(ts) < hc.P
    return hc.add(_host_svdw(ts[0]), _host_svdw(ts[1]))


def _ser33(pt, prefix: int) -> bytes:
    """The 33-byte form: prefix, + 1 where y is no square, || x; infinity
    as the commit pipeline writes it (prefix + 1, zeros)."""
    if pt is None:
        return bytes([prefix + 1]) + bytes(32)
    square = pow(pt[1], (hc.P - 1) // 2, hc.P) == 1
    return bytes([prefix + (not square)]) + _i32(pt[0])


def _mul_jac(k: int, pt):
    """k*P for any point, jacobian, by double-and-add on Python ints."""
    acc, q = None, hc.jlift(pt)
    for bit in bin(k)[2:]:
        acc = hc.jdouble(acc)
        if bit == "1":
            acc = hc.jadd(acc, q)
    return acc


def make_pedersen_distinct(distinct: int, seed: int):
    """``distinct`` commitment jobs from ``seed``: lane i commits a blind b_i
    and a 40-bit value v_i to the generator H_i = A_(i mod 64) + r_i*G,
    A_t the NUMS generator of asset tag t, r_i a generator blind.  What
    committing must give, with Python ints and ``hashlib``: a dict of the
    tags, the A_t, r_i, b_i, v_i, the H_i and the commitments' bytes."""
    comb = _comb_ints()
    rng = np.random.default_rng(seed + 5)
    seedb = rng.bytes(32)
    tags = [hashlib.sha256(seedb + b"tag%d" % j).digest()
            for j in range(ASSET_TAGS)]
    assets = [_host_generator(t) for t in tags]
    rs = [int.from_bytes(hashlib.sha256(seedb + b"r%d" % i).digest(), "big")
          % hc.N or 1 for i in range(distinct)]
    bs = [int.from_bytes(hashlib.sha256(seedb + b"b%d" % i).digest(), "big")
          % hc.N or 1 for i in range(distinct)]
    vs = [int(v) for v in rng.integers(1, 1 << 40, distinct)]
    gens = hc.batch_affine([hc.jadd(hc.jlift(assets[i % ASSET_TAGS]),
                                    _mul_g(r, comb))
                            for i, r in enumerate(rs)])
    commits = hc.batch_affine([hc.jadd(_mul_g(b, comb), _mul_jac(v, g))
                               for b, v, g in zip(bs, vs, gens)])
    for i in range(0, distinct, max(distinct // 4, 1)):
        assert gens[i] == hc.add(assets[i % ASSET_TAGS], hc.mul(rs[i]))
        assert commits[i] == hc.add(hc.mul(bs[i]), hc.mul(vs[i], gens[i]))
    return dict(tags=tags, assets=assets, rs=rs, bs=bs, vs=vs, gens=gens,
                commits=np.array([np.frombuffer(_ser33(c, 8), np.uint8)
                                  for c in commits]))


def _ge_of(pts) -> GE:
    """Affine Python-int points -> a ``GE`` on the CPU."""
    return GE(LB(torch.tensor([_limbs(p[0]) for p in pts]), MASK16),
              LB(torch.tensor([_limbs(p[1]) for p in pts]), MASK16),
              torch.zeros(len(pts), dtype=torch.bool))


def _u64_halves(vals):
    v = torch.tensor(vals, dtype=torch.int64)
    return v >> 32, v & 0xFFFFFFFF


def make_generator_batch(base, lanes: int):
    """``lanes`` blinded-generator jobs tiled from ``base``: (asset tag
    bytes, generator blinds, on the CPU; the expected 33-byte forms of the
    H_i as numpy)."""
    idx = np.arange(lanes) % len(base["rs"])
    tags = torch.tensor(np.array([np.frombuffer(base["tags"][i % ASSET_TAGS],
                                                np.uint8) for i in idx]))
    blinds = torch.tensor(np.array([np.frombuffer(_i32(base["rs"][i]),
                                                  np.uint8) for i in idx]))
    want = np.array([np.frombuffer(_ser33(base["gens"][i], 10), np.uint8)
                     for i in range(len(base["rs"]))])
    return tags, blinds, want[idx]


def make_pedersen_batch(base, lanes: int, edges: bool = True):
    """``lanes`` commitment jobs tiled from ``base``.  With ``edges``, lanes
    1-5 are b = 0, v = 0, b >= n, an infinite generator and b = v = 0.
    Returns (blind32, value hi, value lo, generators ``GE``, on the CPU;
    expected bytes and ok as numpy)."""
    d = len(base["bs"])
    idx = np.arange(lanes) % d
    bs = [base["bs"][i] for i in idx]
    vs = [base["vs"][i] for i in idx]
    gens = _ge_of([base["gens"][i] for i in range(d)])
    gens = GE(LB(gens.x.v[idx], MASK16), LB(gens.y.v[idx], MASK16),
              torch.zeros(lanes, dtype=torch.bool))
    want = base["commits"][idx].copy()
    ok = np.ones(lanes, bool)
    if edges:
        H = [base["gens"][i] for i in idx[:6]]
        bs[1] = 0                                              # b = 0
        vs[2] = 0                                              # v = 0
        bs[3] = hc.N + 7                                       # b >= n
        gens.inf[4] = True                                     # H infinite
        bs[5] = vs[5] = 0                                      # infinity
        for lane in range(1, 6):
            pt = hc.add(hc.mul(bs[lane] % hc.N),
                        None if lane == 4 else hc.mul(vs[lane], H[lane]))
            want[lane] = np.frombuffer(_ser33(pt, 8), np.uint8)
        ok[3:6] = False
    blinds = torch.tensor(np.array([np.frombuffer(_i32(b), np.uint8)
                                    for b in bs]))
    hi, lo = _u64_halves(vs)
    return blinds, hi, lo, gens, want, ok


def make_tally(base, lanes: int):
    """The negative side of a tally against the ``lanes`` commitments tiled
    from ``base`` (no edge lanes): per asset tag t a commitment of the sum
    of its values to A_t with blind 0, and one of value 0 whose blind is
    sum(b_i + v_i r_i) mod n, so both sides sum to the same point; and the
    same side off by one (tag 0's sum + 1).  Returns ((blind32, hi, lo,
    generators ``GE``) balanced, the same off by one), on the CPU."""
    d = len(base["bs"])
    reps, rest = divmod(lanes, d)
    count = [reps + (i < rest) for i in range(d)]
    sums = [0] * ASSET_TAGS
    beta = 0
    for i in range(d):
        sums[i % ASSET_TAGS] += count[i] * base["vs"][i]
        beta += count[i] * (base["bs"][i] + base["vs"][i] * base["rs"][i])
    blinds = torch.zeros((TALLY_NEG_LANES, 32), dtype=torch.uint8)
    blinds[-1] = torch.tensor(list(_i32(beta % hc.N)), dtype=torch.uint8)
    gens = _ge_of(base["assets"] + base["assets"][:1])
    out = []
    for extra in (0, 1):
        vals = [sums[0] + extra] + sums[1:] + [0]
        out.append((blinds, *_u64_halves(vals), gens))
    return out


def _bit1_r() -> int:
    """The least r with r + n the x of a curve point: a signature whose
    x(R) >= n, recovery id 2 or 3 (a random nonce gives one with
    probability about 2^-128)."""
    r = 1
    while pow((pow(r + hc.N, 3, hc.P) + 7) % hc.P, (hc.P - 1) // 2,
              hc.P) != 1:
        r += 1
    return r


def _host_recover(msg32: bytes, r: int, s: int, recid: int):
    """Q = r^-1 (s R - m G) with Python ints, or None where recovery must
    refuse (modules/recovery/main_impl.h:87-121)."""
    x = r + hc.N if recid & 2 else r
    if not (0 < r < hc.N and 0 < s < hc.N) or x >= hc.P:
        return None
    y2 = (x ** 3 + 7) % hc.P
    y = pow(y2, (hc.P + 1) // 4, hc.P)
    if y * y % hc.P != y2:
        return None
    if (y & 1) != (recid & 1):
        y = hc.P - y
    m = int.from_bytes(msg32, "big") % hc.N
    rinv = pow(r, -1, hc.N)
    return hc.add(hc.mul(s * rinv % hc.N, (x, y)),
                  hc.mul(-m * rinv % hc.N))


# recovery's edge lanes, on lanes 3-7 of a signed batch: (what to set,
# its value); the r = 0 / s = 0 of the refused keys are on lanes 0-2
RECOVER_EDGES = (("s", 0), ("r", None), ("r", hc.P - hc.N + 3),
                 ("r", None), ("r", hc.N + 1))


def make_recover_batch(msgs, sig, recid, want_ok, pub):
    """Recovery jobs from a signed batch (the port's own signatures): lanes
    0-2 are the refused keys' zero signatures; lane 3 gets s = 0, lane 4
    an x off the curve for r, lane 5 bit 1 with r >= p - n, lane 6 bit 1
    with the least r whose r + n is on the curve (it recovers a key), lane
    7 r >= n.  Returns (msg32, sig64, recid on the CPU; expected ok and
    keys as numpy limbs)."""
    sig, recid = sig.cpu().clone(), recid.cpu().clone()
    ok = want_ok.copy()
    kx, ky = pub.x.v.numpy().copy(), pub.y.v.numpy().copy()
    bits = (0, 0, 2, 2, 0)
    for j, ((what, val), rid) in enumerate(zip(RECOVER_EDGES, bits)):
        lane = 3 + j
        if val is None:
            val = _not_on_curve_x() if j == 1 else _bit1_r()
        cols = slice(32, 64) if what == "s" else slice(0, 32)
        sig[lane, cols] = torch.tensor(list(_i32(val)), dtype=torch.uint8)
        recid[lane] = rid
        q = _host_recover(bytes(msgs[lane].tolist()),
                          int.from_bytes(bytes(sig[lane, :32].tolist()),
                                         "big"),
                          int.from_bytes(bytes(sig[lane, 32:].tolist()),
                                         "big"), rid)
        ok[lane] = q is not None
        if q is not None:
            kx[lane], ky[lane] = _limbs(q[0]), _limbs(q[1])
    assert ok[3:8].tolist() == [False, False, False, True, False]
    return msgs, sig, recid, ok, kx, ky


# --- host-made signatures: what the sign paths must return ------------------

# the BIP-340 sign vectors (index, seckey, pubkey, aux, msg, sig): data from
# the BIP, as the reference embeds them in modules/schnorrsig/tests_impl.h
BIP340_SIGN_VECTORS = [
    (0, "0000000000000000000000000000000000000000000000000000000000000003",
     "F9308A019258C31049344F85F89D5229B531C845836F99B08601F113BCE036F9",
     "0000000000000000000000000000000000000000000000000000000000000000",
     "0000000000000000000000000000000000000000000000000000000000000000",
     "E907831F80848D1069A5371B402410364BDF1C5F8307B0084C55F1CE2DCA8215"
     "25F66A4A85EA8B71E482A74F382D2CE5EBEEE8FDB2172F477DF4900D310536C0"),
    (1, "B7E151628AED2A6ABF7158809CF4F3C762E7160F38B4DA56A784D9045190CFEF",
     "DFF1D77F2A671C5F36183726DB2341BE58FEAE1DA2DECED843240F7B502BA659",
     "0000000000000000000000000000000000000000000000000000000000000001",
     "243F6A8885A308D313198A2E03707344A4093822299F31D0082EFA98EC4E6C89",
     "6896BD60EEAE296DB48A229FF71DFE071BDE413E6D43F917DC8DCF8C78DE3341"
     "8906D11AC976ABCCB20B091292BFF4EA897EFCB639EA871CFA95F6DE339E4B0A"),
    (2, "C90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74020BBEA63B14E5C9",
     "DD308AFEC5777E13121FA72B9CC1B7CC0139715309B086C960E18FD969774EB8",
     "C87AA53824B4D7AE2EB035A2B5BBBCCC080E76CDC6D1692C4B0B62D798E6D906",
     "7E2D58D8B3BCDF1ABADEC7829054F90DDA9805AAB56C77333024B9D0A508B75C",
     "5831AAEED7B44BB74E5EAB94BA9D4294C49BCF2A60728D8B4C200F50DD313C1B"
     "AB745879A5AD954A72C45A91C3A51D3C7ADEA98D82F8481E0E1E03674A6F3FB7"),
    (3, "0B432B2677937381AEF05BB02A66ECD012773062CF3FA2549E44F58ED2401710",
     "25D1DFF95105F5253C4022F628A996AD3A0D95FBF21D468A1B33F8C160D8F517",
     "FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF",
     "FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF",
     "7EB0509757E246F19449885651611CB965ECC1A187DD51B64FDA1EDC9637D5EC"
     "97582B9CB13DB3933705B32BA982AF5AF25FD78881EBB32771FC5922EFC66EA3"),
]
# secret keys the sign paths must refuse (ok false, zero signature):
# 0, n and a value above n
BAD_KEYS = (0, hc.N, hc.N + 5)


def _hmac(key: bytes, msg: bytes) -> bytes:
    return hmac.new(key, msg, hashlib.sha256).digest()


def _rfc6979_k(sec32: bytes, msg32: bytes) -> int:
    """The first of two RFC6979 candidates in [1, n-1] (the reference's
    nonce_function_rfc6979 with no extra data), 0 if neither is."""
    v, k = b"\x01" * 32, b"\x00" * 32
    k = _hmac(k, v + b"\x00" + sec32 + msg32)
    v = _hmac(k, v)
    k = _hmac(k, v + b"\x01" + sec32 + msg32)
    v = _hmac(k, v)
    for _ in range(2):
        v = _hmac(k, v)
        cand = int.from_bytes(v, "big")
        if 0 < cand < hc.N:
            return cand
        k = _hmac(k, v + b"\x00")
        v = _hmac(k, v)
    return 0


def _mul_g_affine(ks, comb):
    """k*G for a list of scalars in [1, n-1], affine, with spot checks of
    the table-driven multiples against plain double-and-add."""
    pts = hc.batch_affine([_mul_g(k, comb) for k in ks])
    for i in range(0, len(ks), max(len(ks) // 4, 1)):
        assert pts[i] == hc.mul(ks[i])
    return pts


def make_sign_distinct(distinct: int, seed: int):
    """``distinct`` ECDSA keys and messages from ``seed`` and what signing
    them must give, with Python ints and ``hmac``: (secs, msgs, sigs,
    recids, key x limbs, key y limbs)."""
    comb = _comb_ints()
    rng = np.random.default_rng(seed + 2)
    secs = [int.from_bytes(rng.bytes(32), "big") % hc.N or 1
            for _ in range(distinct)]
    msgs = rng.integers(0, 256, (distinct, 32), dtype=np.uint8)
    ks = [_rfc6979_k(_i32(d), bytes(m)) for d, m in zip(secs, msgs)]
    Ra = _mul_g_affine(ks, comb)
    Pa = _mul_g_affine(secs, comb)
    sigs = np.zeros((distinct, 64), np.uint8)
    recids = np.zeros(distinct, np.int64)
    pkx = np.zeros((distinct, 16), np.int64)
    pky = np.zeros((distinct, 16), np.int64)
    for i in range(distinct):
        m = int.from_bytes(bytes(msgs[i]), "big") % hc.N
        r = Ra[i][0] % hc.N
        s = pow(ks[i], -1, hc.N) * (m + r * secs[i]) % hc.N
        recid = (2 if Ra[i][0] >= hc.N else 0) | (Ra[i][1] & 1)
        if s > hc.N // 2:
            s, recid = hc.N - s, recid ^ 1
        assert r and s
        sigs[i] = np.frombuffer(_i32(r) + _i32(s), np.uint8)
        recids[i] = recid
        pkx[i], pky[i] = _limbs(Pa[i][0]), _limbs(Pa[i][1])
    sec_b = np.array([np.frombuffer(_i32(d), np.uint8) for d in secs])
    return sec_b, msgs, sigs, recids, pkx, pky


def _tile(a, lanes):
    return np.tile(a, (-(-lanes // len(a)),) + (1,) * (a.ndim - 1))[:lanes] \
        .copy()


def make_sign_batch(base, lanes: int):
    """``lanes`` ECDSA sign jobs tiled from ``base``, the ``BAD_KEYS`` on
    lanes 0-2.  Returns (msg32, sec32 on the CPU, expected sig64, recid
    and ok as numpy, the keys as a GE for verify)."""
    secs, msgs, sigs, recids, pkx, pky = (_tile(a, lanes) for a in base)
    ok = np.ones(lanes, bool)
    for lane, d in enumerate(BAD_KEYS):
        secs[lane] = np.frombuffer(_i32(d), np.uint8)
        sigs[lane] = 0
        ok[lane] = False
    pub = GE(LB(torch.from_numpy(pkx), MASK16),
             LB(torch.from_numpy(pky), MASK16),
             torch.zeros(lanes, dtype=torch.bool))
    return (torch.from_numpy(msgs), torch.from_numpy(secs), sigs, recids,
            ok, pub)


def _schnorr_sig(d: int, P, k: int, R, aux: bytes, msg: bytes) -> bytes:
    """BIP-340 signature from the keypair (d, P = d*G) and the nonce
    (k, R = k*G) the default nonce function gave."""
    d = d if P[1] % 2 == 0 else hc.N - d
    k = k if R[1] % 2 == 0 else hc.N - k
    s = (k + _challenge(_i32(R[0]), _i32(P[0]), msg) * d) % hc.N
    return _i32(R[0]) + _i32(s)


def _schnorr_nonce(d: int, P, aux: bytes, msg: bytes) -> int:
    d = d if P[1] % 2 == 0 else hc.N - d
    t = d ^ int.from_bytes(_tagged("BIP0340/aux", aux), "big")
    return int.from_bytes(_tagged("BIP0340/nonce",
                                  _i32(t) + _i32(P[0]) + msg), "big") % hc.N


def make_ssign_distinct(distinct: int, seed: int):
    """``distinct`` BIP-340 keys, messages and aux data from ``seed`` and
    the signatures they must give: (secs, msgs, auxs, sigs, x-only keys)."""
    comb = _comb_ints()
    rng = np.random.default_rng(seed + 3)
    secs = [int.from_bytes(rng.bytes(32), "big") % hc.N or 1
            for _ in range(distinct)]
    msgs = rng.integers(0, 256, (distinct, 32), dtype=np.uint8)
    auxs = rng.integers(0, 256, (distinct, 32), dtype=np.uint8)
    Pa = _mul_g_affine(secs, comb)
    ks = [_schnorr_nonce(d, P, bytes(a), bytes(m))
          for d, P, a, m in zip(secs, Pa, auxs, msgs)]
    Ra = _mul_g_affine(ks, comb)
    sigs = np.array([np.frombuffer(_schnorr_sig(
        secs[i], Pa[i], ks[i], Ra[i], bytes(auxs[i]), bytes(msgs[i])),
        np.uint8) for i in range(distinct)])
    pxs = np.array([np.frombuffer(_i32(P[0]), np.uint8) for P in Pa])
    sec_b = np.array([np.frombuffer(_i32(d), np.uint8) for d in secs])
    return sec_b, msgs, auxs, sigs, pxs


def make_ssign_batch(base, lanes: int):
    """``lanes`` BIP-340 sign jobs tiled from ``base``, the ``BAD_KEYS`` on
    lanes 0-2 and the four BIP-340 sign vectors on lanes 3-6 (their
    signatures made by the host code above too, as a check of it).
    Returns (msg32, sec32, aux32 on the CPU, expected sig64 and ok as
    numpy, x-only keys on the CPU)."""
    secs, msgs, auxs, sigs, pxs = (_tile(a, lanes) for a in base)
    ok = np.ones(lanes, bool)
    for lane, d in enumerate(BAD_KEYS):
        secs[lane] = np.frombuffer(_i32(d), np.uint8)
        sigs[lane] = 0
        ok[lane] = False
    for j, (_, sk, pk, aux, msg, sig) in enumerate(BIP340_SIGN_VECTORS):
        d = int(sk, 16)
        P, aux_b, msg_b = hc.mul(d), bytes.fromhex(aux), bytes.fromhex(msg)
        k = _schnorr_nonce(d, P, aux_b, msg_b)
        assert _schnorr_sig(d, P, k, hc.mul(k), aux_b, msg_b) \
            == bytes.fromhex(sig) and _i32(P[0]) == bytes.fromhex(pk)
        lane = 3 + j
        secs[lane] = np.frombuffer(bytes.fromhex(sk), np.uint8)
        auxs[lane] = np.frombuffer(aux_b, np.uint8)
        msgs[lane] = np.frombuffer(msg_b, np.uint8)
        sigs[lane] = np.frombuffer(bytes.fromhex(sig), np.uint8)
        pxs[lane] = np.frombuffer(bytes.fromhex(pk), np.uint8)
    return (torch.from_numpy(msgs), torch.from_numpy(secs),
            torch.from_numpy(auxs), sigs, ok, torch.from_numpy(pxs))


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
    t["gjac"] = cuda_gen.fixedbase_public(t["gdigs"])
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
             sha_msg=ch, sha_start=H.tag_midstate("BIP0340/challenge"),
             sha_consumed=64,
             px=rows(pkx), rx=rows(F.normalize(rx)),
             pinf=torch.zeros(len(msgs), dtype=torch.bool, device=dev))
    e = schnorrsig.challenge(sigs[:, :32], pxs, msgs)
    t["e"] = rows(S.normalize(e))
    t["py"], _ = cuda_field.lift_x(t["px"])
    t["digs"], eflags = cuda_scalar.glv_only(t["e"])
    t["flags"] = eflags ^ 1
    t["gdigs"] = cuda_gen.gen_digits(rows(s))
    t["gjac"] = cuda_gen.fixedbase_public(t["gdigs"])
    t["check_rx"] = None
    t["R"] = cuda_group.ecmult_glv(t["digs"], t["flags"], t["px"], t["py"],
                                   t["pinf"], t["gjac"], rx=None)[:4]
    return t


def sign_inputs(msgs, secs, blind, dev):
    """The tensors each ECDSA-sign kernel sees on the main path: the steps
    of ``ecdsa.sign`` one by one, and the blinded comb's operands."""
    msgs, secs = msgs.to(dev), secs.to(dev)
    rows = ecdsa.kernel_rows
    d, _ = S.from_bytes_be(secs)
    m, _ = S.from_bytes_be(msgs)
    k, _ = ecdsa._pick_nonce(ecdsa.rfc6979_nonce(msgs, secs))
    t = dict(k=rows(k), m=rows(m), d=rows(d), rounds=2,
             keydata=torch.cat([secs, msgs], -1))
    t["gdigs"] = cuda_gen.gen_digits(t["k"])
    t["gjac"] = cuda_gen.fixedbase_digits(t["gdigs"])
    # the blinded comb also on the lanes of its complete add's special
    # cases: k = n - b (k' = 0, the accumulator still at infinity when
    # -b*G is added), k = 0 (k' = b, the last add is P + (-P)), k = 1 and
    # k = n - 1
    kedge = t["k"].clone()
    for lane, v in enumerate((hc.N - blind.b, 0, 1, hc.N - 1)):
        kedge[:, lane] = torch.tensor(_limbs(v), dtype=torch.int32)
    t["bdigs"], t["gb"] = cuda_gen.blinded_digits(kedge, blind)
    return t


def catch(fn, targets):
    """Run ``fn()`` with each ``(module, attribute)`` of ``targets``
    ({name: (module, attribute)}) wrapped to record its calls — the real
    function still runs, so nothing extra is launched.  Returns (fn's
    result, {name: [(args, result), ...]})."""
    seen = {name: [] for name in targets}
    real = {name: getattr(mod, attr) for name, (mod, attr) in
            targets.items()}

    def spy(name):
        def call(*args):
            out = real[name](*args)
            seen[name].append((args, out))
            return out
        return call

    for name, (mod, attr) in targets.items():
        setattr(mod, attr, spy(name))
    try:
        out = fn()
    finally:
        for name, (mod, attr) in targets.items():
            setattr(mod, attr, real[name])
    return out, seen


# where the batch-verify and MSM paths call their kernel wrappers
MSM_TARGETS = {"msm_table": (cuda_msm, "msm_table"),
               "msm_winreduce": (cuda_msm, "msm_winreduce"),
               "msm_finish": (cuda_msm, "msm_finish"),
               "gej_add": (cuda_group, "gej_add")}
SHA_TARGETS = {"sha256_msg": (cuda_sha256, "sha256_msg"),
               "rfc6979": (cuda_sha256, "rfc6979"),
               "batch_digest": (cuda_sha256, "batch_digest")}
BATCH_TARGETS = {**MSM_TARGETS, **SHA_TARGETS,
                 "lift_x": (cuda_field, "lift_x"),
                 "muladd_n": (cuda_gen, "muladd_n"),
                 "fixedbase_public": (cuda_gen, "fixedbase_public")}
# the comb's entries, caught on the recover, commit and generator paths
PUBLIC_COMB_TARGET = {"fixedbase_public": (cuda_gen, "fixedbase_public")}
SECRET_COMB_TARGET = {"fixedbase_digits": (cuda_gen, "fixedbase_digits")}
# the tally's lane sums (ops/msm.py calls gej_sum by its own name)
SUM_TARGET = {"gej_sum": (msm, "gej_sum")}


def sha_msg_sets(seen):
    """The operand sets of the ``sha256_msg`` launches caught by
    :func:`catch`."""
    return [dict(sha_msg=a[0], sha_start=a[1], sha_consumed=a[2],
                 sha_lane=a[3] if len(a) > 3 else None)
            for a, _ in seen.get("sha256_msg", [])]


def msm_sets(seen, off_curve: bool = False):
    """The operands of every launch caught by :func:`catch`, as tensor
    sets for :func:`compare`, by kernel; for ``gej_add`` also the last
    MSM's window partials added to themselves with P + P, P + (-P) and
    infinity lanes mixed in; with ``off_curve``, the first table's
    operands with a point off the curve on lane 1."""
    sets = {k: [] for k in (*MSM_KERNELS, "gej_add", "sha256_msg",
                            "batch_digest", "lift_x", "muladd_n",
                            "fixedbase_public")}
    sets["sha256_msg"] = sha_msg_sets(seen)
    for (px, msg, sig), _ in seen.get("batch_digest", []):
        sets["batch_digest"].append(dict(px=px, msg=msg, sig=sig))
    for (px,), _ in seen.get("lift_x", []):
        sets["lift_x"].append(dict(px=px))
    for (k, e, d, neg), _ in seen.get("muladd_n", []):
        sets["muladd_n"].append(dict(k=k, e=e, d=d, neg=neg))
    for (gdigs,), _ in seen.get("fixedbase_public", []):
        sets["fixedbase_public"].append(dict(gdigs=gdigs))
    for (px, py, pinf), _ in seen["msm_table"]:
        sets["msm_table"].append(dict(px=px, py=py, pinf=pinf))
    for (digs, tab, pinf, nblk), _ in seen["msm_winreduce"]:
        sets["msm_winreduce"].append(dict(digs=digs, tab=tab, pinf=pinf,
                                          nblk=nblk, nwin=digs.shape[0]))
    for (x, y, z, inf, nwin), _ in seen["msm_finish"]:
        sets["msm_finish"].append(dict(x=x, y=y, z=z, inf=inf, nwin=nwin))
    for (a, b), _ in seen["gej_add"]:
        sets["gej_add"].append(dict(a=a, b=b))
    if off_curve:
        # msm_table on (0, 0), off the curve: its chain's Z is 0, its
        # inverse 0, its entries all 0 in the plain version
        t = sets["msm_table"][0]
        px, py = t["px"].clone(), t["py"].clone()
        px[:, 1] = 0
        py[:, 1] = 0
        sets["msm_table"].append(dict(px=px, py=py, pinf=t["pinf"]))
    # degenerate adds on a wide operand, the last MSM's window partials:
    # b = a (doubling) on even lanes, b = -a on odd lanes, infinity on
    # every fifth
    f = sets["msm_finish"][-1]
    a = (f["x"], f["y"], f["z"], f["inf"])
    x, y, z, inf = (t.clone() for t in a)
    y[:, 1::2] = cuda_field._neg_canon(y[:, 1::2].to(torch.int64)) \
        .to(y.dtype)
    inf[::5] = True
    sets["gej_add"].append(dict(a=a, b=(x, y, z, inf)))
    return sets


def finish_edge_sets(f128, f256):
    """msm_finish's edge partial sets, from batch verify's two finish
    operands at 262,144 lanes (32 windows of 33 partials, 64 of 16; both
    shapes are also checked as they are): the 64 windows with window 5's
    partials P, -P and nothing else; 32 windows of one partial each
    (nblk = 1); the same with every partial infinite (the MSM of all-zero
    scalars).  Three sets, as each plain finish takes seconds on the card.
    (label, operand set) pairs."""
    x, y, z, inf = (f256[k].clone() for k in ("x", "y", "z", "inf"))
    nblk = x.shape[1] // 64
    c = 5 * nblk
    if bool(inf[c]):
        raise SystemExit("finish edge set: partial 0 of window 5 is "
                         "infinite")
    for t in (x, y, z):
        t[:, c + 1] = t[:, c]
    y[:, c + 1] = cuda_field._neg_canon(y[:, c:c + 1].to(torch.int64)) \
        .to(y.dtype)[:, 0]
    inf[c + 2:c + nblk] = True
    inf[c + 1] = False
    one = torch.arange(32, device=x.device) * (f128["x"].shape[1] // 32)
    single = {k: f128[k][..., one].contiguous()
              for k in ("x", "y", "z", "inf")}
    return [(f"64 windows of {nblk} partials, window 5 = P + (-P)",
             dict(nwin=64, x=x, y=y, z=z, inf=inf)),
            ("32 windows of 1 partial", dict(nwin=32, **single)),
            ("32 windows of 1 partial, all infinite", dict(
                single, nwin=32, inf=torch.ones_like(single["inf"])))]


def affine_edge_set(R, group: int) -> dict:
    """The affine conversions' operands for one K: the jacobian lanes R
    cut to AFFINE_EDGE_LANES, with z = 0 at the first, a middle and the
    last slot of thread 5's group (its lanes 5, 5 + S, ... for S =
    ceil(B / K) threads), thread 7's whole group at z = 0, z = p on lane 9
    and p + 1 in thread 9's next slot (lane 10 for K = 1), y = 0 on lane
    11."""
    x, y, z = (c[:, :AFFINE_EDGE_LANES].contiguous() for c in R)
    lanes = x.shape[1]
    S = -(-lanes // group)
    col = {v: torch.tensor(_limbs(v), dtype=torch.int32, device=x.device)
           for v in (0, hc.P, hc.P + 1)}
    for slot in (0, group // 2, group - 1):
        z[:, 5 + slot * S] = col[0]
    for lane in range(7, lanes, S):
        z[:, lane] = col[0]
    z[:, 9] = col[hc.P]
    z[:, 9 + S if 9 + S < lanes else 10] = col[hc.P + 1]
    y[:, 11] = col[0]
    return dict(R=(x, y, z), group=group)


def prep_edge_set(t, group: int) -> dict:
    """ecdsa_prep's operands for one K: the verify path's m, r, s cut to
    AFFINE_EDGE_LANES, with s = 0 at the first, a middle and the last slot
    of thread 5's group (its lanes 5, 5 + S, ... for S = ceil(B / K)
    threads) and on thread 7's whole group, s = 1 on lane 9, n - 1 on lane
    10, m = 0 on lane 11."""
    m, r, s = (t[k][:, :AFFINE_EDGE_LANES].contiguous()
               for k in ("m", "r", "s"))
    lanes = s.shape[1]
    S = -(-lanes // group)
    col = {v: torch.tensor(_limbs(v), dtype=torch.int32, device=s.device)
           for v in (0, 1, hc.N - 1)}
    for slot in (0, group // 2, group - 1):
        s[:, 5 + slot * S] = col[0]
    for lane in range(7, lanes, S):
        s[:, lane] = col[0]
    s[:, 9], s[:, 10], m[:, 11] = col[1], col[hc.N - 1], col[0]
    return dict(m=m, r=r, s=s, group=group)


def finish_edge_set(t, group: int) -> dict:
    """ecdsa_finish's operands for one K: the sign path's R, k, m, d cut to
    AFFINE_EDGE_LANES, with z = 0 at the first, a middle and the last slot
    of thread 5's group and on thread 7's whole group, z = p on lane 9 and
    p + 1 in thread 9's next slot (lane 10 for K = 1); k = 0 at thread 6's
    three slots and on thread 8's whole group; m = 0 on lane 11; R = (x, y,
    1) with x in [n, p) on lane 12 (r's overflow: recovery id bit 1)."""
    x, y, z, k, m, d = (c[:, :AFFINE_EDGE_LANES].contiguous()
                        for c in (*t["gjac"], t["k"], t["m"], t["d"]))
    lanes = z.shape[1]
    S = -(-lanes // group)
    bx = _bit1_r() + hc.N
    by = pow((bx ** 3 + 7) % hc.P, (hc.P + 1) // 4, hc.P)
    col = {v: torch.tensor(_limbs(v), dtype=torch.int32, device=z.device)
           for v in (0, 1, hc.P, hc.P + 1, bx, by)}
    for slot in (0, group // 2, group - 1):
        z[:, 5 + slot * S] = col[0]
        k[:, 6 + slot * S] = col[0]
    for lane in range(7, lanes, S):
        z[:, lane] = col[0]
    for lane in range(8, lanes, S):
        k[:, lane] = col[0]
    z[:, 9] = col[hc.P]
    z[:, 9 + S if 9 + S < lanes else 10] = col[hc.P + 1]
    m[:, 11] = col[0]
    x[:, 12], y[:, 12], z[:, 12] = col[bx], col[by], col[1]
    return dict(gjac=(x, y, z), k=k, m=m, d=d, group=group)


def sum_edge_sets(x, y, z, inf):
    """gej_sum's edge sets from a tally operand of 262,144 lanes: the first
    B lanes for each of SUM_EDGE_LANES, with lane 1 = lane 0 (P + P),
    the last lane the negation of the one before it (a cancelling pair),
    infinity on lanes 6, 13, 20, ...; where B exceeds the launch's
    threads, lane `threads` = lane 0 and lane `threads` + 2 = -(lane 2),
    pairs a thread's fold meets; and the two lanes P, -P.  (label,
    operand set) pairs."""
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    out = []

    def neg(t):
        return cuda_field._neg_canon(t.to(torch.int64)).to(t.dtype)

    for lanes in SUM_EDGE_LANES:
        t = dict(x=x[:, :lanes].clone(), y=y[:, :lanes].clone(),
                 z=z[:, :lanes].clone(), inf=inf[:lanes].clone())
        t["inf"][6::7] = True
        threads = cuda_group.SUM_THREADS * cuda_group.sum_blocks(lanes, sms)
        pairs = [(0, 1, False)]
        if lanes > threads:
            pairs += [(0, threads, False), (2, threads + 2, True)]
        if lanes >= 3:
            pairs.append((lanes - 2, lanes - 1, True))
        for src, dst, negate in pairs:
            if dst >= lanes:
                continue
            for k in ("x", "y", "z"):
                t[k][:, dst] = t[k][:, src]
            if negate:
                t["y"][:, dst] = neg(t["y"][:, src:src + 1])[:, 0]
            t["inf"][dst] = t["inf"][src] = False
        out.append((f"{lanes} lanes, P + P, a cancelling pair, infinite "
                    "lanes", t))
    t = {k: v[..., :2].clone() for k, v in (("x", x), ("y", y), ("z", z),
                                            ("inf", inf))}
    t["y"][:, 1] = neg(t["y"][:, :1])[:, 0]
    t["x"][:, 1], t["z"][:, 1] = t["x"][:, 0], t["z"][:, 0]
    t["inf"][:] = False
    out.append(("2 lanes, P + (-P)", t))
    return out


def ssign_inputs(msgs, secs, auxs, dev):
    """The tensors each Schnorr-sign kernel sees on the main path: the
    steps of ``schnorrsig.sign`` one by one (R = k*G for ``affine_xy``)."""
    msgs, secs, auxs = msgs.to(dev), secs.to(dev), auxs.to(dev)
    rows = ecdsa.kernel_rows
    d_even, px32, _, _ = schnorrsig.keypair_xonly(secs, device=dev)
    aux_hash = H.words_to_bytes32(H.tagged_hash_bytes("BIP0340/aux", auxs))
    nonce = torch.cat([S.to_bytes_be(d_even) ^ aux_hash, px32, msgs], -1)
    k, _ = S.from_bytes_be(H.words_to_bytes32(
        H.tagged_hash_bytes("BIP0340/nonce", nonce)))
    t = dict(k=rows(k), d=rows(d_even))
    t["R"] = cuda_gen.ecmult_gen(t["k"])
    xa, ya = cuda_gen.affine_xy(*t["R"])
    e = schnorrsig.challenge(F.to_bytes_be(ecdsa.from_rows(xa)), px32, msgs)
    t["e"] = rows(S.normalize(e))
    t["neg"] = (ya[0] & 1) == 1
    return t


def run_pair(name, t, use_ref: bool):
    """One kernel (or its plain version) on the tensors ``t``; returns a
    tuple of result tensors."""
    if name == "mulmod_chain":
        f = cuda_field.mulmod_chain_ref if use_ref else cuda_field.mulmod_chain
        return (f(t["px"], t["py"], t.get("chain", CHAIN_N)),)
    if name == "ecdsa_prep":
        if use_ref:
            return cuda_scalar.ecdsa_prep_ref(t["m"], t["r"], t["s"])
        return cuda_scalar.ecdsa_prep(t["m"], t["r"], t["s"],
                                      group=t.get("group"))
    if name == "fixedbase_digits":
        f = (cuda_gen.fixedbase_digits_ref if use_ref
             else cuda_gen.fixedbase_digits)
        return f(t["gdigs"])
    if name == "fixedbase_public":
        f = (cuda_gen.fixedbase_digits_ref if use_ref
             else cuda_gen.fixedbase_public)
        return f(t["gdigs"])
    if name == "ecmult_glv":
        f = cuda_group.ecmult_glv_ref if use_ref else cuda_group.ecmult_glv
        return f(t["digs"], t["flags"], t["px"], t["py"], t["pinf"],
                 t["gjac"], rx=t["check_rx"])
    if name == "sha256":
        f = (cuda_sha256.sha256_blocks_ref if use_ref
             else cuda_sha256.sha256_blocks)
        return (f(t["sha_state"], t["sha_blocks"]),)
    if name == "sha256_msg":
        f = cuda_sha256.sha256_msg_ref if use_ref else cuda_sha256.sha256_msg
        return (f(t["sha_msg"], t["sha_start"], t["sha_consumed"],
                  t.get("sha_lane")),)
    if name == "rfc6979":
        f = cuda_sha256.rfc6979_ref if use_ref else cuda_sha256.rfc6979
        return (f(t["keydata"], t["rounds"]),)
    if name == "batch_digest":
        f = (cuda_sha256.batch_digest_ref if use_ref
             else cuda_sha256.batch_digest)
        return (f(t["px"], t["msg"], t["sig"]),)
    if name == "lift_x":
        f = cuda_field.lift_x_ref if use_ref else cuda_field.lift_x
        return f(t["px"])
    if name == "glv_only":
        f = cuda_scalar.glv_only_ref if use_ref else cuda_scalar.glv_only
        return f(t["e"])
    if name == "ecdsa_finish":
        if use_ref:
            return cuda_gen.ecdsa_sign_finish_ref(*t["gjac"], t["k"], t["m"],
                                                  t["d"])
        return cuda_gen.ecdsa_sign_finish(*t["gjac"], t["k"], t["m"], t["d"],
                                          group=t.get("group"))
    if name == "affine_xy":
        if use_ref:
            return cuda_gen.affine_xy_ref(*t["R"])
        return cuda_gen.affine_xy(*t["R"], group=t.get("group"))
    if name == "muladd_n":
        f = cuda_gen.muladd_n_ref if use_ref else cuda_gen.muladd_n
        return (f(t["k"], t["e"], t["d"], t["neg"]),)
    if name == "fixedbase_blinded":
        f = (cuda_gen.fixedbase_digits_ref if use_ref
             else cuda_gen.fixedbase_digits)
        return f(t["bdigs"], t["gb"])
    if name == "gej_add":
        f = cuda_group.gej_add_ref if use_ref else cuda_group.gej_add
        return f(t["a"], t["b"])
    if name == "msm_table":
        f = cuda_msm.msm_table_ref if use_ref else cuda_msm.msm_table
        return (f(t["px"], t["py"], t["pinf"]),)
    if name == "msm_winreduce":
        f = cuda_msm.msm_winreduce_ref if use_ref else cuda_msm.msm_winreduce
        return f(t["digs"], t["tab"], t["pinf"], t["nblk"])
    if name == "msm_finish":
        f = cuda_msm.msm_finish_ref if use_ref else cuda_msm.msm_finish
        return f(t["x"], t["y"], t["z"], t["inf"], t["nwin"])
    if name == "gej_sum":
        f = cuda_group.gej_sum_ref if use_ref else cuda_group.gej_sum
        return f(t["x"], t["y"], t["z"], t["inf"])
    if name == "affine_meta":
        if use_ref:
            return cuda_field.affine_meta_ref(*t["R"])
        return cuda_field.affine_meta(*t["R"], group=t.get("group"))
    if name == "inv_n":
        f = cuda_scalar.inv_n_ref if use_ref else cuda_scalar.inv_n
        return (f(t["x"]),)
    f = cuda_field.schnorr_check_ref if use_ref else cuda_field.schnorr_check
    return (f(*t["R"], t["rx"]),)


# results compared as points, made affine: each window's partials summed
# (their jacobian form depends on the order of the additions), the finish's
# and the lane sum's one point, and the comb's lanes where a team of T > 1
# threads adds the rows in another order than the plain version (with
# T = 1 the words are equal and are compared)
AS_POINTS = {
    "msm_winreduce": lambda out, t: cuda_msm.points_affine(*out, t["nwin"]),
    "msm_finish": lambda out, t: cuda_msm.points_affine(*out, 1),
    "gej_sum": lambda out, t: cuda_msm.points_affine(*out, 1),
    **{k: lambda out, t: cuda_gen.affine_xy_ref(*out) for k in COMB_KERNELS}}


def comb_digits(name, t):
    return t["bdigs"] if name == "fixedbase_blinded" else t["gdigs"]


def comb_team(name, gdigs):
    """The threads a lane the comb's wrapper takes for ``gdigs``."""
    return cuda_gen.comb_team(gdigs.shape[1], _build.sm_count(
        str(gdigs.device)), COMB_KERNELS[name][0])


# weak and carry-heavy field operands (p <= x < 2^256, all-ones words, and
# words where 3 * a carries everywhere) for the field multiply's PTX chains
FE_EDGES = (0, 1, 2, hc.P - 1, hc.P, hc.P + 1, 2 ** 256 - 1, 2 ** 256 - 2,
            2 ** 256 - 2 ** 32 - 978, 2 ** 255,
            int("55555555FFFFFFFF" * 4, 16), 0x55555555FFFFFFFF << 192)


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
    if name in AS_POINTS and not (
            name in COMB_KERNELS
            and comb_team(name, comb_digits(name, t)) == 1):
        got, want = AS_POINTS[name](got, t), AS_POINTS[name](want, t)
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
    kinfo = ptxas_summary(_build.build_log())
    sass = sass_counts()
    emit("build", seconds=round(time.time() - t0, 2),
         nvcc_seconds=_build.BUILD_SECONDS, sources=len(_build.sources()),
         kernels={k: f"{v['registers']} registers, {v['stack']} B stack, "
                  f"{v['spill_stores']}/{v['spill_loads']} B spill "
                  f"stores/loads" for k, v in kinfo.items()},
         sass=sass,
         spills=[ln for ln in ptxas if "spill" in ln
                 and not ln.startswith("0 bytes stack frame, 0 bytes spill")])
    # the redesigned kernels run on the stack-free core (csrc/fe.cuh)
    for k in STACK_FREE:
        v = kinfo.get(k)
        if v is None or v["stack"] or v["frame"] or v["spill_stores"] \
                or v["spill_loads"]:
            raise SystemExit(f"{k}: ptxas reports a stack or a spill: {v}")
    # the comb's secret scan: one select instruction a word
    if not 0.9 <= sass["scan"]["selects_per_word"] <= 1.25:
        raise SystemExit(f"comb scan: {sass['scan']} selects a word")

    # -- phase 3: kernels against their plain versions ----------------------
    # the verify kernels at both main-path batches and at a ragged one, on
    # each path's own tensors (fixedbase_digits and ecmult_glv on both:
    # ecmult_glv with the fused r check on the ECDSA path, rx=None on the
    # Schnorr path); mulmod_chain and sha256 also on the selftest's own
    # operands, and mulmod_chain as a micro-benchmark at the verify batches
    t0 = time.time()
    cuda_field.jacobi_undecided(dev, reset=True)
    base = make_distinct(distinct, args.seed)
    sbase = make_schnorr_distinct(distinct, args.seed)
    batches = {n: make_batch(base, n) for n in (*sizes, ragged)}
    sbatches = {n: make_schnorr_batch(sbase, n) for n in (*sizes, ragged)}
    gbase = make_sign_distinct(distinct, args.seed)
    gsbase = make_ssign_distinct(distinct, args.seed)
    gbatches = {n: make_sign_batch(gbase, n) for n in (*sizes, ragged)}
    gsbatches = {n: make_ssign_batch(gsbase, n) for n in (*sizes, ragged)}
    # batch verification reuses the distinct BIP-340 signatures, tiled
    bbatches = {n: make_batch_verify(sbase, n) for n in (*sizes, ragged)}
    emit("data", seconds=round(time.time() - t0, 2),
         lanes=sorted(batches), distinct=distinct)
    # the blinding of the sign paths, from the seed (Context creation runs
    # the selftest on the card: outside the counted runs)
    blind_seed = hashlib.sha256(b"blind %d" % args.seed).digest()
    ctx = context.Context(dev).randomize(blind_seed)
    results = {k: {"name": k, "route": "cuda", "source": SOURCES[k],
                   "replaces": REPLACES[k], "match": True,
                   "max_abs_err": 0, "library_ms": None}
               for k in MAIN_PATH_KERNELS}
    for name, func in KERNEL_FUNCS.items():
        results[name]["registers"] = kinfo[func]["registers"]

    def record(name, shape, err, plain_ms):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        results[name]["match"] &= err == 0
        emit("kernel_check", name=name, shape=shape, match=err == 0,
             max_abs_err=err, plain_ms=round(plain_ms, 3))

    tensors = {n: kernel_inputs(*batches[n][:3], dev) for n in batches}
    stensors = {n: schnorr_inputs(*sbatches[n][:3], dev) for n in sbatches}
    gtensors = {n: sign_inputs(*gbatches[n][:2], ctx.blind, dev)
                for n in gbatches}
    gstensors = {n: ssign_inputs(*gsbatches[n][:3], dev) for n in gsbatches}
    # which tensors each sign kernel is held and timed on
    sign_sets = {"ecdsa_finish": gtensors, "fixedbase_blinded": gtensors,
                 "fixedbase_digits": gtensors, "affine_xy": gstensors,
                 "muladd_n": gstensors}
    selftest_t = [dict(px=x, py=y, chain=n)
                  for x, y, n, _ in context.selftest_operands(dev)]
    for t in selftest_t:
        err, plain_ms = compare("mulmod_chain", t)
        record("mulmod_chain", f"selftest [16, {t['px'].shape[1]}], "
               f"n = {t['chain']}", err, plain_ms)
        results["mulmod_chain"]["plain_ms"] = plain_ms      # longest last
    for chain in (1, 3):
        edge_t = dict(chain=chain, **{k: torch.tensor(
            [_limbs(v) for v in vals], dtype=torch.int32, device=dev).T
            .contiguous() for k, vals in (
                ("px", [a for a in FE_EDGES for _ in FE_EDGES]),
                ("py", [b for _ in FE_EDGES for b in FE_EDGES]))})
        err, _ = compare("mulmod_chain", edge_t)
        record("mulmod_chain", f"{len(FE_EDGES) ** 2} pairs of weak and "
               f"carry-heavy operands, n = {chain}", err, 0.0)
    sha_selftest = dict(
        sha_state=cuda_sha256.words_to_rows(torch.tensor(
            [list(H._INIT)], dtype=torch.int64, device=dev)),
        sha_blocks=cuda_sha256.words_to_rows(H._pad_bytes_to_blocks(
            torch.zeros((1, 32), dtype=torch.uint8, device=dev))))
    err, plain_ms = compare("sha256", sha_selftest)
    record("sha256", "selftest shape [8, 1], 1 block", err, plain_ms)
    btensors = {}                 # the MSM kernels' operands, for timing
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
        for name in SIGN_KERNELS:
            err, plain_ms = compare(name, sign_sets[name][n])
            record(name, f"{n} lanes, sign path", err, plain_ms)
            if n == sizes[0]:
                results[name]["plain_ms"] = plain_ms
            elif n in sizes:
                results[name][f"plain_ms_{n}"] = plain_ms
        # the word-major blocks on the Schnorr challenge's two blocks
        err, plain_ms = compare("sha256", stensors[n])
        record("sha256", f"{n} lanes, the Schnorr challenge's 2 blocks",
               err, plain_ms)
        if n in sizes:
            results["sha256"]["plain_ms" if n == sizes[0]
                              else f"plain_ms_{n}"] = plain_ms
        # rfc6979 and sha256_msg on the operands of every launch of the two
        # sign paths (the DRBG; the tagged hashes from their midstates),
        # caught from one call each
        msgs, secs = gbatches[n][:2]
        smsgs, ssecs, sauxs = gsbatches[n][:3]
        _, seen = catch(lambda: ecdsa.sign(msgs, secs, device=dev),
                        SHA_TARGETS)
        for (kd, rounds), _ in seen["rfc6979"]:
            err, plain_ms = compare("rfc6979", dict(keydata=kd,
                                                    rounds=rounds))
            record("rfc6979", f"{n} lanes, ECDSA sign, {rounds} candidates",
                   err, plain_ms)
            if n in sizes:
                results["rfc6979"]["plain_ms" if n == sizes[0]
                                   else f"plain_ms_{n}"] = plain_ms
        _, seen = catch(lambda: schnorrsig.sign(smsgs, ssecs, sauxs,
                                                device=dev), SHA_TARGETS)
        checks = [compare("sha256_msg", t) for t in sha_msg_sets(seen)]
        record("sha256_msg", f"{n} lanes, Schnorr sign: {len(checks)} "
               "launches", max(e for e, _ in checks),
               sum(ms for _, ms in checks))
        del seen
        # batch verify: every kernel of the path on the operands of one
        # call, caught at the wrappers — both MSMs (128- and 256-bit
        # scalars) and the rhs add, the hashes (leaves, node levels,
        # randomizers, challenges), the lifts, z*e and z*s, and
        # (sum z s)*G; the finish also on edge partial sets
        _, seen = catch(lambda: schnorrsig.batch_verify(
            *bbatches[n][0]["valid"], device=dev), BATCH_TARGETS)
        bsets = msm_sets(seen, off_curve=n == ragged)
        del seen
        for name, tsets in bsets.items():
            checks = [compare(name, t) for t in tsets]
            record(name, f"{n} lanes, batch verify: {len(checks)} launches",
                   max(e for e, _ in checks), sum(ms for _, ms in checks))
            if name in MSM_KERNELS:
                # read at the 256-bit MSM's launch
                if n == sizes[0]:
                    results[name]["plain_ms"] = checks[1][1]
                elif n in sizes:
                    results[name][f"plain_ms_{n}"] = checks[1][1]
            elif name == "gej_add" and n in sizes:
                results[name][f"rhs_plain_ms_{n}"] = checks[0][1]
            elif name == "batch_digest" and n in sizes:
                results[name]["plain_ms" if n == sizes[0]
                              else f"plain_ms_{n}"] = checks[0][1]
        if n == sizes[1]:
            for label, t in finish_edge_sets(*bsets["msm_finish"]):
                err, plain_ms = compare("msm_finish", t)
                record("msm_finish", label, err, plain_ms)
            # the tree's edges: one leaf, two, three, 2^18 - 1
            whole_batch = bsets["batch_digest"][0]
            for k in DIGEST_EDGE_N:
                err, plain_ms = compare("batch_digest", {
                    c: v[:k] for c, v in whole_batch.items()})
                record("batch_digest", f"{k} signatures", err, plain_ms)
        if n in sizes:
            btensors[n] = {k: bsets[k] for k in (*MSM_KERNELS, "gej_add",
                                                  "batch_digest", "lift_x",
                                                  "sha256_msg")}
        del bsets
    # commitments and recovery: affine_meta on the commit pipeline's
    # jacobian result (caught from one pedersen_commit_bytes call) with
    # z = 0, the weak z = p + 1, the weak zero z = p and y = 0 on lanes 0-3,
    # and on the serializer's (x, y, 1); inv_n on the r of a signed batch
    # with 0, 1, n - 1, n + 2 and 2^256 - 1 on lanes 0-4
    t0 = time.time()
    pbase = make_pedersen_distinct(distinct, args.seed)
    pbatches = {n: make_pedersen_batch(pbase, n) for n in (*sizes, ragged)}
    emit("data", what="pedersen", seconds=round(time.time() - t0, 2))
    ptensors, rtensors = {}, {}
    meta_target = {"affine_meta": (cuda_field, "affine_meta"),
                   **SECRET_COMB_TARGET}
    for n in (*sizes, ragged):
        blinds, hi, lo, gens = pbatches[n][:4]
        _, seen = catch(lambda: generator.pedersen_commit_bytes(
            blinds, hi, lo, gens, device=dev), meta_target)
        if n == ragged:
            # the secret comb on the commit path's blinds
            err, plain_ms = compare("fixedbase_digits", dict(
                gdigs=seen["fixedbase_digits"][0][0][0]))
            record("fixedbase_digits", f"{n} lanes, commit path's b", err,
                   plain_ms)
        x, y, z = (c.clone() for c in seen["affine_meta"][0][0])
        for lane, v in ((0, 0), (1, hc.P + 1), (2, hc.P)):
            z[:, lane] = torch.tensor(_limbs(v), dtype=torch.int32)
        y[:, 3] = 0
        ptensors[n] = dict(R=(x, y, z))
        _, seen = catch(lambda: generator.generator_serialize(gens.to(dev)),
                        meta_target)
        r, _, _ = ecdsa.sig_parse_compact(
            torch.from_numpy(gbatches[n][2]).to(dev))
        xr = ecdsa.kernel_rows(r)
        for lane, v in enumerate((0, 1, hc.N - 1, hc.N + 2, 2 ** 256 - 1)):
            xr[:, lane] = torch.tensor(_limbs(v), dtype=torch.int32)
        rtensors[n] = dict(x=xr)
        for name, t, shape in (
                ("affine_meta", ptensors[n], "commit path, edge lanes 0-3"),
                ("affine_meta", dict(R=seen["affine_meta"][0][0]),
                 "generator serializer, z = 1"),
                ("inv_n", rtensors[n], "recovery's r, edge lanes 0-4")):
            err, plain_ms = compare(name, t)
            record(name, f"{n} lanes, {shape}", err, plain_ms)
            if shape.startswith("generator"):
                continue
            if n == sizes[0]:
                results[name]["plain_ms"] = plain_ms
            elif n in sizes:
                results[name][f"plain_ms_{n}"] = plain_ms
        del seen
    # the affine conversions' thread groups (cuda_field.affine_group): the
    # edge set at the wrapper's K and at K = 1, 2, 3 and 8
    sms = _build.sm_count(str(dev))
    chosen = cuda_field.affine_group(AFFINE_EDGE_LANES, sms)
    for group in sorted({chosen, *AFFINE_EDGE_GROUPS}):
        t = affine_edge_set(ptensors[sizes[1]]["R"], group)
        for name in ("affine_xy", "affine_meta"):
            err, plain_ms = compare(name, t)
            record(name, f"{AFFINE_EDGE_LANES} lanes, edge set, K = {group}"
                   + (" (the wrapper's)" if group == chosen else ""), err,
                   plain_ms)
    # ecdsa_prep and ecdsa_finish (K lanes a thread on a batched inverse,
    # csrc/batch_inv.cuh): their edge sets at the wrapper's K and at K = 1,
    # 2, 3 and 8
    for name, make, t in (("ecdsa_prep", prep_edge_set, tensors[sizes[1]]),
                          ("ecdsa_finish", finish_edge_set,
                           gtensors[sizes[1]])):
        chosen = GROUP_RULES[name](AFFINE_EDGE_LANES, sms)
        for group in sorted({chosen, *AFFINE_EDGE_GROUPS}):
            err, plain_ms = compare(name, make(t, group))
            record(name, f"{AFFINE_EDGE_LANES} lanes, edge set, K = {group}"
                   + (" (the wrapper's)" if group == chosen else ""), err,
                   plain_ms)
    for name, rule in GROUP_RULES.items():
        results[name].update({f"group_{n}": rule(n, sms)
                              for n in (*sizes, ragged)})
    undecided = cuda_field.jacobi_undecided(dev, reset=True)
    results["affine_meta"]["jacobi_undecided_checks"] = undecided
    emit("kernel_check", name="affine_meta", jacobi_undecided=undecided)
    emit("kernel_check", name="batched_inverse_groups",
         groups={name: {n: rule(n, sms)
                        for n in (*sizes, ragged, AFFINE_EDGE_LANES)}
                 for name, rule in GROUP_RULES.items()})
    bad = [k for k, v in results.items() if not v["match"]]
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")

    # -- phase 4: main paths -------------------------------------------------
    # each call runs with the counts set to 0 just before it and read just
    # after; it must launch exactly the kernels of its path, as often as
    # PATHS says, and nothing else
    launches = {k: 0 for k in MAIN_PATH_KERNELS}
    by_path = {p: {k: 0 for k in MAIN_PATH_KERNELS} for p in PATHS}

    def counted(path, fn, lanes=None):
        _build.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = dict(_build.LAUNCH_COUNTS)
        want = {k: path_launches(path, lanes).get(k, 0) for k in got}
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
    def wrong_lanes(sig, ok, want_sig, want_ok, recid=None, want_recid=None):
        """Lanes whose ok, signature bytes or (on ok lanes) recid differ
        from the host's."""
        sig, ok = sig.cpu().numpy(), ok.cpu().numpy()
        bad = (ok != want_ok) | (sig != want_sig).any(1)
        if recid is not None:
            bad |= want_ok & (recid.cpu().numpy() != want_recid)
        return int(bad.sum())

    port_sigs = {}                # the port's ECDSA signatures, to recover
    for n in sizes:
        msgs, secs, want_sig, want_recid, want_ok, pub = gbatches[n]
        sig, recid, ok = counted("ecdsa_sign",
                                 lambda: ecdsa.sign(msgs, secs, device=dev))
        assert sig.shape == (n, 64) and sig.dtype == torch.uint8 \
            and sig.is_cuda and recid.shape == (n,) and ok.shape == (n,)
        wrong = wrong_lanes(sig, ok, want_sig, want_ok, recid, want_recid)
        port_sigs[n] = sig, recid
        vok = counted("ecdsa", lambda: ecdsa.verify(msgs, sig, pub,
                                                    device=dev))
        unverified = int((ok & ~vok).sum())
        bsig, brecid, bok = counted("ecdsa_sign_blinded", lambda: ecdsa.sign(
            msgs, secs, blind=ctx.blind, device=dev))
        blind_diff = int(((bsig != sig).any(1) | (brecid != recid)
                          | (bok != ok)).sum())
        emit("main_path", path="ecdsa_sign", lanes=n, ok=int(ok.sum()),
             wrong_lanes=wrong, ok_lanes_not_verified=unverified,
             blinded_lanes_differing=blind_diff,
             launches=PATHS["ecdsa_sign"],
             launches_blinded=PATHS["ecdsa_sign_blinded"])
        if wrong or unverified or blind_diff:
            raise SystemExit(f"ecdsa sign wrong at {n} lanes: {wrong} "
                             f"against the host, {unverified} not verified, "
                             f"{blind_diff} changed by the blinding")
        msgs, secs, auxs, want_sig, want_ok, pxs = gsbatches[n]
        sig, ok = counted("schnorr_sign", lambda: schnorrsig.sign(
            msgs, secs, auxs, device=dev))
        assert sig.shape == (n, 64) and sig.is_cuda and ok.shape == (n,)
        wrong = wrong_lanes(sig, ok, want_sig, want_ok)
        vectors = int((sig[3:3 + len(BIP340_SIGN_VECTORS)].cpu().numpy()
                       != want_sig[3:3 + len(BIP340_SIGN_VECTORS)]).any(1)
                      .sum())
        vok = counted("schnorr", lambda: schnorrsig.verify(msgs, sig, pxs,
                                                           device=dev))
        unverified = int((ok & ~vok).sum())
        bsig, bok = counted("schnorr_sign_blinded", lambda: schnorrsig.sign(
            msgs, secs, auxs, blind=ctx.blind, device=dev))
        blind_diff = int(((bsig != sig).any(1) | (bok != ok)).sum())
        emit("main_path", path="schnorr_sign", lanes=n, ok=int(ok.sum()),
             wrong_lanes=wrong, bip340_vectors_wrong=vectors,
             ok_lanes_not_verified=unverified,
             blinded_lanes_differing=blind_diff,
             launches=PATHS["schnorr_sign"],
             launches_blinded=PATHS["schnorr_sign_blinded"])
        if wrong or vectors or unverified or blind_diff:
            raise SystemExit(f"schnorr sign wrong at {n} lanes: {wrong} "
                             f"against the host, {unverified} not verified, "
                             f"{blind_diff} changed by the blinding")
    def affine_ints(r):
        """0-d GEJ -> affine Python ints, None at infinity."""
        a = G.ge_from_gej(r)
        if bool(a.inf):
            return None
        return tuple(sum(int(v) << (16 * i) for i, v in
                         enumerate(c.v.tolist())) for c in (a.x, a.y))

    for n in sizes:
        cases, rhs_want = bbatches[n]
        verdicts = {}
        for label, inputs in cases.items():
            ok, seen = catch(lambda: counted(
                "schnorr_batch", lambda: schnorrsig.batch_verify(
                    *inputs, device=dev), n), {"rhs": (G, "gej_add")})
            assert ok.shape == () and ok.dtype == torch.bool and ok.is_cuda
            verdicts[label] = bool(ok)
            if label == "valid":
                rhs_ok = affine_ints(seen["rhs"][0][1]) == rhs_want
        wrong = [k for k, v in verdicts.items() if v != (k == "valid")]
        emit("main_path", path="schnorr_batch", lanes=n, verdicts=verdicts,
             rhs_matches_host=rhs_ok,
             launches=path_launches("schnorr_batch", n))
        if wrong or not rhs_ok:
            raise SystemExit(f"batch verify wrong at {n} lanes: verdicts "
                             f"{wrong}, rhs right: {rhs_ok}")
    t0 = time.time()
    mks, mpts, msm_want = make_msm(MSM_POINTS, args.seed, dev)
    msm_data_s = time.time() - t0
    rsum, seen = catch(lambda: counted("msm", lambda: msm.ecmult_multi(
        mks, mpts, device=dev)), MSM_TARGETS)
    msets = {k: v for k, v in msm_sets(seen).items() if k in MSM_KERNELS}
    del seen
    msm_ok = affine_ints(rsum) == msm_want
    emit("main_path", path="msm", points=MSM_POINTS, matches_host=msm_ok,
         data_seconds=round(msm_data_s, 2), launches=PATHS["msm"])
    if not msm_ok:
        raise SystemExit(f"ecmult_multi of {MSM_POINTS} points is wrong")
    # the engine's kernels against their plain versions on the operands of
    # that call (after its counts were read)
    for name, tsets in msets.items():
        checks = [compare(name, t) for t in tsets]
        record(name, f"{MSM_POINTS} points, msm: {len(checks)} launches",
               max(e for e, _ in checks), sum(ms for _, ms in checks))
        results[name][f"plain_ms_{MSM_POINTS}"] = checks[0][1]
    bad = [k for k in MSM_KERNELS if not results[k]["match"]]
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions at "
                         f"{MSM_POINTS} points: {bad}")
    # blinded generators from the 64 asset tags (at the first size only:
    # svdw is eager glue, ~2 x 10^5 launches a call whatever the batch),
    # commitments to them, the tally, recovery of the signers' keys
    gtags, gblinds, gwant = make_generator_batch(pbase, sizes[0])

    def generate_and_serialize():
        h, ok = generator.generator_generate(gtags, gblinds, device=dev)
        return h, ok, generator.generator_serialize(h)

    t1 = time.perf_counter()
    (hgen, hok, hser), seen = catch(lambda: counted(
        "generator_blinded", generate_and_serialize),
        {**SECRET_COMB_TARGET, "gej_add": (cuda_group, "gej_add"),
         "sha256_msg": (cuda_sha256, "sha256_msg")})
    gen_s = time.perf_counter() - t1
    for t in sha_msg_sets(seen):
        err, plain_ms = compare("sha256_msg", t)
        record("sha256_msg", f"{sizes[0]} keys, generator: "
               f"{t['sha_msg'].shape[0]} messages", err, plain_ms)
    err, plain_ms = compare("fixedbase_digits", dict(
        gdigs=seen["fixedbase_digits"][0][0][0]))
    record("fixedbase_digits", f"{sizes[0]} lanes, generator blind", err,
           plain_ms)
    # gej_add at full width: H1 + H2 and + b*G
    gen_adds = [dict(a=a, b=b) for (a, b), _ in seen["gej_add"]]
    checks = [compare("gej_add", t) for t in gen_adds]
    record("gej_add", f"{sizes[0]} lanes, generator: {len(checks)} "
           "launches", max(e for e, _ in checks),
           sum(ms for _, ms in checks))
    results["gej_add"]["plain_ms"] = checks[0][1]
    del seen
    wrong = int(((hser.cpu().numpy() != gwant).any(1)
                 | ~hok.cpu().numpy()).sum())
    emit("main_path", path="generator_blinded", lanes=sizes[0],
         wrong_lanes=wrong, seconds=gen_s,
         launches=PATHS["generator_blinded"])
    if wrong:
        raise SystemExit(f"generator_generate wrong on {wrong} lanes")
    rdata, sum_sets = {}, {}
    for n in sizes:
        blinds, hi, lo, pgens, want, want_ok = pbatches[n]
        # the port's generators, tiled as the jobs are; lane 4 infinite
        idx = torch.arange(n, device=dev) % sizes[0]
        gens = GE(LB(hgen.x.v[idx], MASK16), LB(hgen.y.v[idx], MASK16),
                  pgens.inf.to(dev))
        c33, cok = counted("pedersen", lambda: generator.pedersen_commit_bytes(
            blinds, hi, lo, gens, device=dev))
        assert c33.shape == (n, 33) and c33.is_cuda and cok.shape == (n,)
        wrong = int(((c33.cpu().numpy() != want).any(1)
                     | (cok.cpu().numpy() != want_ok)).sum())
        pt, pok = generator.pedersen_commitment_parse(c33[cok], device=dev)
        unparsed = int((~pok).sum() + (generator.pedersen_commitment_serialize(
            pt) != c33[cok]).any(1).sum())
        # the tally: the commitments without edge lanes against one per
        # asset tag and one carrying the blinds, balanced and off by one
        pos, pos_ok = generator.pedersen_commit(
            *make_pedersen_batch(pbase, n, edges=False)[:4], device=dev)
        verdicts, sums = [], []
        for side in make_tally(pbase, n):
            neg, neg_ok = generator.pedersen_commit(*side, device=dev)
            if not (pos_ok.all() and neg_ok.all()):
                raise SystemExit(f"tally inputs at {n} lanes not committed")
            ok, seen = catch(lambda: counted(
                "tally", lambda: generator.pedersen_verify_tally(pos, neg)),
                SUM_TARGET)
            assert ok.shape == () and ok.dtype == torch.bool and ok.is_cuda
            verdicts.append(bool(ok))
            # the positive side once: both calls sum the same commitments
            sums += [dict(x=x, y=y, z=z, inf=inf) for (x, y, z, inf), _
                     in seen["gej_sum"][1 if sums else 0:]]
        emit("main_path", path="pedersen", lanes=n, ok=int(cok.sum()),
             wrong_lanes=wrong, parse_roundtrip_wrong=unparsed,
             tally_balanced=verdicts[0], tally_off_by_one=verdicts[1],
             launches=PATHS["pedersen"], launches_tally=PATHS["tally"])
        if wrong or unparsed or verdicts != [True, False]:
            raise SystemExit(f"pedersen wrong at {n} lanes: {wrong} "
                             f"commitments, {unparsed} parsed, tally "
                             f"{verdicts}")
        # the lane sum on the tally's operands (after the counts were
        # read), and at 262,144 on the edge sets made from them
        checks = [compare("gej_sum", t) for t in sums]
        record("gej_sum", f"{n} lanes, tally: {len(checks)} launches "
               f"of {sorted({t['x'].shape[1] for t in sums})} lanes",
               max(e for e, _ in checks), sum(ms for _, ms in checks))
        results["gej_sum"]["plain_ms" if n == sizes[0]
                           else f"plain_ms_{n}"] = checks[0][1]
        sum_sets[n] = sums[0]
        if n == sizes[1]:
            for label, t in sum_edge_sets(*(sums[0][k] for k in
                                            ("x", "y", "z", "inf"))):
                err, plain_ms = compare("gej_sum", t)
                record("gej_sum", label, err, plain_ms)
        del pos, neg, sums
        msgs, _, _, _, sign_ok, pub = gbatches[n]
        rm, rs, rr, rok, kx, ky = make_recover_batch(msgs, *port_sigs[n],
                                                     sign_ok, pub)
        rdata[n] = rm, rs, rr
        (q, qok), seen = catch(lambda: counted(
            "recover", lambda: ecdsa.recover(rm, rs, rr, device=dev)),
            PUBLIC_COMB_TARGET)
        err, plain_ms = compare("fixedbase_public", dict(
            gdigs=seen["fixedbase_public"][0][0][0]))
        record("fixedbase_public", f"{n} lanes, recover's u1", err, plain_ms)
        assert qok.shape == (n,) and qok.is_cuda and q.x.v.shape == (n, 16)
        qok = qok.cpu().numpy()
        bad_key = ((q.x.v.cpu().numpy() != kx).any(1)
                   | (q.y.v.cpu().numpy() != ky).any(1))
        wrong = int(((qok != rok) | (rok & bad_key)).sum())
        emit("main_path", path="recover", lanes=n, ok=int(qok.sum()),
             wrong_lanes=wrong, launches=PATHS["recover"])
        if wrong:
            raise SystemExit(f"recover wrong on {wrong} of {n} lanes")
    idle = [k for k in MAIN_PATH_KERNELS if launches[k] < 1]
    if idle:
        raise SystemExit(f"main path never launched: {idle}")
    undecided = cuda_field.jacobi_undecided(dev, reset=True)
    results["affine_meta"]["jacobi_undecided_main_path"] = undecided
    emit("main_path", name="affine_meta", jacobi_undecided=undecided)
    bad = [k for k, v in results.items() if not v["match"]]
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions on "
                         f"the recover, commit or generator path: {bad}")

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
        if name in SCHNORR_KERNELS and name not in SHA_KERNELS:
            runs.append(("schnorr_" if name in ECDSA_KERNELS else "",
                         stensors))
        if name in SIGN_KERNELS:
            runs.append(("", sign_sets[name]))
        if name in COMMIT_RECOVER_KERNELS:
            runs.append(("", {"affine_meta": ptensors,
                              "inv_n": rtensors}[name]))
        for pre, tset in runs:
            chain = CHAIN_N if chain64 else 1
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
    # the latency floor of the finish and the lane sum: one doubling and
    # one complete add in a dependent chain on one thread
    lib = _build.lib()
    lat = latency_ms(lib, dev)
    emit("timing", name="latency_probe", **lat)
    # the SHA-256 entries at the verify and sign shapes: word-major blocks
    # and sha256_msg on the Schnorr challenge, rfc6979 on ECDSA sign's key
    # material, batch_digest on batch verify's operands
    for name in SHA_KERNELS:
        for n in sizes:
            t = {"rfc6979": gtensors[n],
                 "batch_digest": btensors[n]["batch_digest"][0]}.get(
                     name, stensors[n])
            ms = time_ms(lambda: run_pair(name, t, False), reps=15)
            b_ms, b_by = sha_bound(name, t)
            results[name].update({f"ms_{n}": ms, f"bound_ms_{n}": b_ms,
                                  f"compressions_{n}":
                                      sha_compressions(name, t)})
            if n == sizes[0]:
                results[name].update(ms=ms, lanes=n, bound_ms=b_ms,
                                     bound_by=b_by)
            emit("timing", name=name, lanes=n, ms=ms, bound_ms=b_ms,
                 bound_by=b_by, compressions=sha_compressions(name, t))
        if name in SHA_WARPS_OP:
            results[name]["warps_per_sm"] = lib.secp_sha256_warps(
                SHA_WARPS_OP[name])
    # lift_x: batch verify's one launch of 2n lanes beside the Schnorr
    # verify's n; its integer-rate bound and its chain's latency floor
    lx = results["lift_x"]
    lx["warps_per_sm"] = lib.secp_lift_x_warps()
    lx.update(sass["lift_x"])
    lx["bound_lat_ms"] = LIFT_SQR * lat["lat_sqr_ms"] \
        + LIFT_MUL * lat["lat_mul_ms"]
    for n in sizes:
        t = btensors[n]["lift_x"][0]
        lanes = t["px"].shape[1]
        ms = time_ms(lambda: run_pair("lift_x", t, False), reps=15)
        lx.update({f"bound_int_ms_{n}": int_bound("lift_x", n),
                   f"batch_ms_{lanes}": ms,
                   f"batch_bound_ms_{lanes}": bound_ms("lift_x", lanes)[0],
                   f"batch_bound_int_ms_{lanes}": int_bound("lift_x",
                                                            lanes)})
        emit("timing", name="lift_x", lanes=lanes, path="batch verify",
             ms=ms, bound_int_ms=int_bound("lift_x", lanes),
             bound_lat_ms=lx["bound_lat_ms"])
    # the MSM engine: the 256-bit MSM's launch of each kernel at both
    # batch-verify sizes and on the 2^20-point MSM; the 128-bit MSM's
    # launches beside them; the finish's latency floor beside its bound
    for name in MSM_KERNELS:
        for n, tsets in ((sizes[0], btensors[sizes[0]]),
                         (sizes[1], btensors[sizes[1]]),
                         (MSM_POINTS, msets)):
            picks = [("", tsets[name][0])]
            if n in sizes:
                picks = [("", tsets[name][1]), ("128bit_", tsets[name][0])]
            for pre, t in picks:
                ms = time_ms(lambda: run_pair(name, t, False))
                b_ms, b_by = msm_bound(name, t)
                results[name][f"{pre}ms_{n}"] = ms
                results[name][f"{pre}bound_ms_{n}"] = b_ms
                lat_ms = {}
                if name == "msm_finish":
                    lat_ms["bound_lat_ms"] = bound_lat_ms(name, t, lat)
                    results[name][f"{pre}bound_lat_ms_{n}"] = \
                        lat_ms["bound_lat_ms"]
                if n == sizes[0] and not pre:
                    results[name].update(ms=ms, lanes=n, bound_ms=b_ms,
                                         bound_by=b_by, **lat_ms)
                emit("timing", name=pre + name, points=n, ms=ms,
                     bound_ms=b_ms, bound_by=b_by, **lat_ms)
    results["msm_finish"].update(lat)
    # gej_add on its main-path operands: the blinded generator's adds
    # (16,384 lanes) and batch verify's rhs (one lane) at both sizes, 15
    # timings a point (a launch is ~0.1 ms, most of it the wrapper's)
    for pre, n, t in (("", sizes[0], gen_adds[0]),
                      *(("rhs_", n, btensors[n]["gej_add"][0])
                        for n in sizes)):
        ms = time_ms(lambda: run_pair("gej_add", t, False), reps=15)
        b_ms, b_by = msm_bound("gej_add", t)
        lanes = t["a"][0].shape[1]
        results["gej_add"][f"{pre}ms_{n}"] = ms
        if not pre:
            results["gej_add"].update(ms=ms, lanes=lanes, bound_ms=b_ms,
                                      bound_by=b_by)
        emit("timing", name=pre + "gej_add", points=n, lanes=lanes, ms=ms,
             bound_ms=b_ms, bound_by=b_by)
    # gej_sum at the tally's sizes (its first operand: the commitments),
    # 15 timings a point (a launch is ~0.1 ms)
    for n in sizes:
        t = sum_sets[n]
        ms = time_ms(lambda: run_pair("gej_sum", t, False), reps=15)
        b_ms, b_by = msm_bound("gej_sum", t)
        b_lat = bound_lat_ms("gej_sum", t, lat)
        results["gej_sum"].update({f"ms_{n}": ms, f"bound_ms_{n}": b_ms,
                                   f"bound_lat_ms_{n}": b_lat})
        if n == sizes[0]:
            results["gej_sum"].update(ms=ms, lanes=n, bound_ms=b_ms,
                                      bound_by=b_by, bound_lat_ms=b_lat)
        emit("timing", name="gej_sum", lanes=n, ms=ms, bound_ms=b_ms,
             bound_by=b_by, bound_lat_ms=b_lat)
    results["gej_sum"].update(lat)
    # the warps an SM holds for the launches of the finish, the lane sum
    # and the elementwise add
    for name, warps in (("msm_finish", lib.secp_msm_finish_warps()),
                        ("gej_sum", lib.secp_gej_warps(1)),
                        ("gej_add", lib.secp_gej_warps(0))):
        results[name]["warps_per_sm"] = warps
        emit("timing", name=name, warps_per_sm=warps)
    # the warps an SM holds for ecmult_glv's and msm_winreduce's launches;
    # both kernels' integer-rate figure beside the bound
    for n in sizes:
        warps = lib.secp_ecmult_glv_warps(n)
        results["ecmult_glv"][f"warps_per_sm_{n}"] = warps
        results["ecmult_glv"][f"bound_int_ms_{n}"] = int_bound(
            "ecmult_glv", n)
        emit("timing", name="ecmult_glv", lanes=n, warps_per_sm=warps)
    results["msm_winreduce"]["warps_per_sm"] = lib.secp_msm_winreduce_warps()
    for n, tsets in ((sizes[0], btensors[sizes[0]]),
                     (sizes[1], btensors[sizes[1]]), (MSM_POINTS, msets)):
        for pre, t in ((("", tsets["msm_winreduce"][0]),) if n == MSM_POINTS
                       else (("", tsets["msm_winreduce"][1]),
                             ("128bit_", tsets["msm_winreduce"][0]))):
            nnz = int(((t["digs"] != 0) & ~t["pinf"][None, :]).sum())
            results["msm_winreduce"][f"{pre}bound_int_ms_{n}"] = int_bound(
                "msm_winreduce", nnz)
    results["msm_table"]["warps_per_sm"] = lib.secp_msm_table_warps()
    for n, tsets in ((sizes[0], btensors[sizes[0]]), (sizes[1],
                     btensors[sizes[1]]), (MSM_POINTS, msets)):
        results["msm_table"][f"bound_int_ms_{n}"] = int_bound(
            "msm_table", tsets["msm_table"][0]["px"].shape[1])
    # the comb: its kernels' warps an SM; the threads a lane (T) swept at
    # both sizes, each T's points held against those of the launch phase 3
    # held against the plain version (the T the wrapper picks), 15 runs
    # each (a launch at 16,384 lanes is ~0.2 ms)
    for name, (mode, blinded) in COMB_KERNELS.items():
        warps = lib.secp_fixedbase_warps(int(mode == cuda_gen.COMB_GATHER),
                                         int(blinded))
        results[name]["warps_per_sm"] = warps
        for n in sizes:
            t = (tensors if name == "fixedbase_public" else sign_sets[name])[n]
            gd = comb_digits(name, t)
            gb = t["gb"] if blinded else None
            chosen = comb_team(name, gd)

            def launch(team):
                return cuda_gen._comb_launch(gd, gb, mode, team)

            want = cuda_gen.affine_xy_ref(*launch(chosen))

            def timed(team):
                got = want if team == chosen else cuda_gen.affine_xy_ref(
                    *launch(team))
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise SystemExit(f"{name} at {n} lanes, T = {team}: "
                                     f"wrong points")
                return time_ms(lambda: launch(team), reps=15)

            by_team = {team: timed(team) for team in cuda_gen.COMB_TEAMS}
            best = min(by_team.values())
            results[name][f"team_{n}"] = chosen
            results[name][f"ms_by_team_{n}"] = by_team
            results[name][f"bound_int_ms_{n}"] = int_bound(name, n)
            emit("timing", name=name + "_teams", lanes=n, warps_per_sm=warps,
                 ms_by_team=by_team, chosen=chosen,
                 chosen_within_10pct=by_team[chosen] <= 1.1 * best)
    # the kernels on a batched inverse (the affine conversions, ecdsa_prep,
    # ecdsa_finish): their warps an SM, integer-rate and latency bounds, and
    # the lanes a thread (K) swept at both sizes on their main-path
    # operands, each K's outputs held against those of the K the wrapper
    # picks (held against the plain version in phase 3), 15 runs each
    for name, tsets, warps in (
            ("affine_xy", sign_sets["affine_xy"], lib.secp_affine_xy_warps()),
            ("affine_meta", ptensors, lib.secp_affine_meta_warps()),
            ("ecdsa_prep", tensors, lib.secp_ecdsa_prep_warps()),
            ("ecdsa_finish", sign_sets["ecdsa_finish"],
             lib.secp_ecdsa_finish_warps())):
        res = results[name]
        res["warps_per_sm"] = warps
        res["bound_lat_ms"] = bound_lat_ms(name, {}, lat)
        for n in sizes:
            t = tsets[n]
            want = run_pair(name, t, False)

            def timed(group):
                tk = dict(t, group=group)
                got = run_pair(name, tk, False)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise SystemExit(f"{name} at {n} lanes, K = {group}: "
                                     f"wrong outputs")
                return time_ms(lambda: run_pair(name, tk, False), reps=15)

            by_group = {group: timed(group) for group in AFFINE_SWEEP}
            chosen = res[f"group_{n}"]
            res[f"ms_by_group_{n}"] = by_group
            res[f"bound_int_ms_{n}"] = int_bound(name, n)
            emit("timing", name=name + "_groups", lanes=n, warps_per_sm=warps,
                 ms_by_group=by_group, chosen=chosen,
                 chosen_within_10pct=by_group[chosen]
                 <= 1.1 * min(by_group.values()),
                 bound_int_ms=res[f"bound_int_ms_{n}"],
                 bound_lat_ms=res["bound_lat_ms"])
    # msm_winreduce's lane chunks (cuda_msm.winreduce_blocks): ms of the
    # window reduce and of the msm_finish after it by nblk, from two warps
    # an SM up, on both MSMs of batch verify and on the 2^20-point MSM
    for n, t in ((sizes[0], btensors[sizes[0]]["msm_winreduce"][1]),
                 (sizes[0], btensors[sizes[0]]["msm_winreduce"][0]),
                 (sizes[1], btensors[sizes[1]]["msm_winreduce"][1]),
                 (sizes[1], btensors[sizes[1]]["msm_winreduce"][0]),
                 (MSM_POINTS, msets["msm_winreduce"][0])):
        nwin, lanes = t["digs"].shape
        most = -(-lanes // cuda_msm.WR_THREADS)
        sweep = {}
        for want in sorted({t["nblk"], *(k for k in NBLK_SWEEP if k <= most)}):
            chunk = -(-lanes // want)
            nblk = -(-lanes // chunk)
            parts = cuda_msm.msm_winreduce(t["digs"], t["tab"], t["pinf"],
                                           nblk)
            sweep[nblk] = [
                time_ms(lambda: cuda_msm.msm_winreduce(
                    t["digs"], t["tab"], t["pinf"], nblk)),
                time_ms(lambda: cuda_msm.msm_finish(*parts, nwin))]
        emit("timing", name="msm_winreduce_nblk", points=n, nwin=nwin,
             chosen=t["nblk"], ms_winreduce_finish_by_nblk=sweep)
    # whole calls: (name, entry point, batches, tensor arguments, rate key)
    calls = (("ecdsa.verify", ecdsa.verify, batches, 3, "verifies_per_s"),
             ("schnorr.verify", schnorrsig.verify, sbatches, 3,
              "verifies_per_s"),
             ("ecdsa.sign", ecdsa.sign, gbatches, 2, "signatures_per_s"),
             ("schnorr.sign", schnorrsig.sign, gsbatches, 3,
              "signatures_per_s"),
             ("schnorr.batch_verify", schnorrsig.batch_verify,
              {n: bbatches[n][0]["valid"] for n in sizes}, 3,
              "verifies_per_s"),
             ("generator.pedersen_commit_bytes",
              generator.pedersen_commit_bytes, pbatches, 4,
              "commitments_per_s"),
             ("ecdsa.recover", ecdsa.recover, rdata, 3, "recoveries_per_s"))
    rates = {}
    for label, entry, data, nargs, rate in calls:
        for n in sizes:
            on_dev = [x.to(dev) for x in data[n][:nargs]]

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
            rates[label, n] = n / ms * 1e3
            emit("timing", name=label, lanes=n, ms=ms,
                 **{rate: n / ms * 1e3})
            # where the call's time goes: the card's kernels, by name
            wall, dev_ms, nkern, top = profile_call(whole)
            emit("profile", name=label, lanes=n,
                 profiled_wall_ms=wall, device_ms=dev_ms, kernels=nkern,
                 device_busy_share=dev_ms / ms, top=top)

    for n in sizes:
        emit("timing", name="batch_vs_single", lanes=n,
             batch_verifies_per_s=rates["schnorr.batch_verify", n],
             verify_verifies_per_s=rates["schnorr.verify", n],
             ratio=rates["schnorr.batch_verify", n]
             / rates["schnorr.verify", n])

    def whole_msm():
        msm.ecmult_multi(mks, mpts, device=dev)
        torch.cuda.synchronize()

    whole_msm()
    walls = []
    for _ in range(5):
        t1 = time.perf_counter()
        whole_msm()
        walls.append((time.perf_counter() - t1) * 1e3)
    ms = float(np.median(walls))
    emit("timing", name="ecmult_multi", points=MSM_POINTS, ms=ms,
         points_per_s=MSM_POINTS / ms * 1e3)
    wall, dev_ms, nkern, top = profile_call(whole_msm)
    emit("profile", name="ecmult_multi", points=MSM_POINTS,
         profiled_wall_ms=wall, device_ms=dev_ms, kernels=nkern,
         device_busy_share=dev_ms / ms, top=top)

    # one blinded generator_generate at the first size (its cost is the
    # eager svdw: the profile counts its launches)
    on_dev = (gtags.to(dev), gblinds.to(dev))

    def whole_gen():
        generator.generator_generate(*on_dev, device=dev)
        torch.cuda.synchronize()

    t1 = time.perf_counter()
    whole_gen()
    ms = (time.perf_counter() - t1) * 1e3
    emit("timing", name="generator.generator_generate_blinded",
         lanes=sizes[0], ms=ms, generators_per_s=sizes[0] / ms * 1e3)
    wall, dev_ms, nkern, top = profile_call(whole_gen)
    emit("profile", name="generator.generator_generate_blinded",
         lanes=sizes[0], profiled_wall_ms=wall, device_ms=dev_ms,
         kernels=nkern, device_busy_share=dev_ms / ms, top=top)

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
