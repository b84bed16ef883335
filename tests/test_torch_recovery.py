"""ECDSA public-key recovery of the port and the scalar inverse it takes,
on the CPU.

* ``inv_n_ref`` (B15b) against the JAX kernel body ``_inv_kernel`` (numpy
  arrays as its refs, under ``jax.disable_jit()``) and Python integers on
  0, 1, 2, n - 1, n - 2 and random scalars; the JAX body's output is weak
  and is compared after reduction mod n.
* ``scalar.inv`` and ``scalar.cond_negate`` against the JAX functions
  (``inv`` is Fermat there: x^(n-2) by fixed windows) and Python ints.
* ``ecdsa.recover`` / ``recovery.recover`` against ``oracle.ecdsa_recover``
  on signatures of every recovery id 0-3 (ids 2 and 3 at the least r with
  r + n on the curve: x(R) >= n, too rare to come from a random nonce) and
  on the lanes that must be refused: r = 0, s = 0, r or s >= n, R off the
  curve, bit 1 with r >= p - n, bit 1 with r + n = p - 1 (not on the
  curve).  The compact 65-byte codec,
  ``to_standard``, ``recover_verify_consistency``, ``sign_recoverable``
  (sign, then recover the signer) and ``signature_normalize``.  Recovery
  reaches the comb's public gather entry alone (u1 is public).

Tolerance: 0 (integers, limbs, bytes).  On CPU tensors every wrapper takes
its plain version; the launch counters must not move.  These checks are
:func:`check_recover_and_the_scalar_inverse`, run by
``test_torch_sign.py::test_ecdsa_sign`` (sign, then recover), so the
number of items collected — on which pytest-xdist's initial chunk size
depends — stays as it was.  The port's recover against the JAX package's
``ecdsa.recover`` (its portable ``ecmult``, jitted) is this file's
``slow`` item.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from secp256k1_zkp_tpu.modules import ecdsa as JE
from secp256k1_zkp_tpu.ops import pallas_scalar as JPS
from secp256k1_zkp_tpu.ops import scalar as JS
from secp256k1_zkp_tpu.ops.limb import LB as JLB
from secp256k1_zkp_tpu_torch.modules import ecdsa as TE
from secp256k1_zkp_tpu_torch.modules import recovery as TR
from secp256k1_zkp_tpu_torch.ops import _build, cuda_scalar
from secp256k1_zkp_tpu_torch.ops import group as TGR
from secp256k1_zkp_tpu_torch.ops import scalar as TS
from secp256k1_zkp_tpu_torch.utils import hostcurve as hc

from test_torch_kernels import trows32
from test_torch_ops import ints, rand, rows_np

P, N = hc.P, hc.N


def lanes_np(vals):
    return rows_np(vals).T.copy()


def tlb(vals):
    return TS.LB(torch.from_numpy(lanes_np(vals).astype(np.int64)), 0xFFFF)


def lb_ints(a):
    return ints(np.asarray(a.v).T)


def bytes_t(bs):
    return torch.tensor(np.array([list(b) for b in bs], np.uint8))


def i32(x):
    return x.to_bytes(32, "big")


def _off_curve_x():
    x = 5
    while pow((x ** 3 + 7) % P, (P - 1) // 2, P) == 1:
        x += 1
    return x


def _bit1_r():
    """The least r with r + n the x of a curve point: a signature with x(R)
    >= n (recovery id 2 or 3; a random nonce gives one with probability
    about 2^-128)."""
    r = 1
    while pow((pow(r + N, 3, P) + 7) % P, (P - 1) // 2, P) != 1:
        r += 1
    return r


def recovery_lanes(rng):
    """(msgs, r, s, recid, the key oracle.ecdsa_recover gives or None):
    six oracle signatures (recovery ids 0 and 1), two with x(R) >= n (ids 2
    and 3, signatures of the key they recover), then the lanes to refuse."""
    msgs, rs, ss, rids = [], [], [], []
    for _ in range(6):
        m = rng.bytes(32)
        r, s, rid = oracle.ecdsa_sign(m, rand(rng, N, 1)[0] or 1)
        msgs.append(m); rs.append(r); ss.append(s); rids.append(rid)
    assert set(rids) == {0, 1}
    m0, r0, s0 = msgs[0], rs[0], ss[0]
    rb = _bit1_r()
    for r, s, rid in ((rb, s0, 2), (rb, s0, 3),       # x(R) = r + n
                      (0, s0, 0),                     # r = 0
                      (r0, 0, 1),                     # s = 0
                      (_off_curve_x(), s0, 0),        # R off the curve
                      (P - N + 3, s0, 2),             # bit 1, r >= p - n
                      (P - N - 1, s0, 3)):            # bit 1, r + n = p - 1
        msgs.append(m0); rs.append(r); ss.append(s); rids.append(rid)
    want = []
    for m, r, s, rid in zip(msgs, rs, ss, rids):
        fits = not rid & 2 or r + N < P
        q = oracle.ecdsa_recover(m, r, s, rid) if r and s and fits else None
        want.append(q)
    return msgs, rs, ss, rids, want


def check_recover_and_the_scalar_inverse():
    rng = np.random.default_rng(91)
    before = dict(_build.LAUNCH_COUNTS)

    # -- B15b: inv_n against the JAX kernel body and Python ints ------------
    xs = [0, 1, 2, N - 1, N - 2] + rand(rng, N, 6)
    out = cuda_scalar.inv_n(trows32(xs))
    assert out.dtype == torch.int32 and out.shape == (16, len(xs))
    want = [pow(x, N - 2, N) for x in xs]
    assert ints(out) == want
    jo = np.zeros((16, len(xs)), np.uint32)
    with jax.disable_jit():
        JPS._inv_kernel(rows_np(xs), jo)
    assert [v % N for v in ints(jo)] == want
    # inputs >= n are reduced first
    assert ints(cuda_scalar.inv_n(trows32([N + 2, 2 ** 256 - 1]))) \
        == [pow(2, N - 2, N), pow(2 ** 256 - 1 - N, N - 2, N)]

    # -- scalar.inv, cond_negate against the JAX functions -----------------
    tinv = TS.inv(tlb(xs))
    assert lb_ints(tinv) == want                      # canonical
    jinv = JS.inv(JLB(jnp.asarray(lanes_np(xs)), 0xFFFF))
    assert [v % N for v in lb_ints(jinv)] == want
    mask = np.array([i % 2 == 0 for i in range(len(xs))])
    tneg = TS.cond_negate(tlb(xs), torch.from_numpy(mask))
    jneg = JS.cond_negate(JLB(jnp.asarray(lanes_np(xs)), 0xFFFF),
                          jnp.asarray(mask))
    assert [v % N for v in lb_ints(tneg)] == [v % N for v in lb_ints(jneg)] \
        == [(-x if f else x) % N for x, f in zip(xs, mask)]

    # -- recover against the oracle ------------------------------------------
    msgs, rs, ss, rids, want = recovery_lanes(rng)
    L = len(msgs)
    sigs = [i32(r) + i32(s) for r, s in zip(rs, ss)]
    sigs.append(i32(N + 1) + i32(ss[0]))              # r >= n
    sigs.append(i32(rs[0]) + i32(N))                  # s >= n
    msgs += [msgs[0]] * 2
    rids += [rids[0]] * 2
    want += [None, None]
    assert want[:8] == [w for w in want if w] and None not in want[:8]
    from test_torch_sign import comb_entries
    (q, ok), comb = comb_entries(lambda: TE.recover(
        bytes_t(msgs), bytes_t(sigs), torch.tensor(rids), device="cpu"))
    assert comb == {"public"}                   # u1: the comb's gather
    assert q.x.v.shape == (L + 2, 16) and ok.dtype == torch.bool
    got = [(x, y) if k else None for x, y, k in
           zip(lb_ints(q.x), lb_ints(q.y), ok.tolist())]
    assert got == want
    # rejected lanes still carry their Q: infinity for r = 0, u1*G for R
    # off the curve
    assert bool(q.inf[8]) and not bool(q.inf[10])
    q2, ok2 = TR.recover(bytes_t(msgs), bytes_t(sigs), torch.tensor(rids),
                         device="cpu")
    assert ok2.tolist() == ok.tolist() and lb_ints(q2.x) == lb_ints(q.x)

    # compact 65-byte form, recover_verify_consistency
    sig65 = TR.serialize_compact(bytes_t(sigs), torch.tensor(rids))
    assert sig65.shape == (L + 2, 65) and sig65[:, 64].tolist() == rids
    p64, prid, pok = TR.parse_compact(sig65, device="cpu")
    assert torch.equal(p64, bytes_t(sigs)) and prid.tolist() == rids
    assert pok.tolist() == [True] * L + [False, False]
    bad = sig65.clone()
    bad[:, 64] = 4
    assert not TR.parse_compact(bad, device="cpu")[2].any()
    assert torch.equal(TR.to_standard(p64, prid), p64)
    keys = [w or (hc.GX, hc.GY) for w in want]
    pub = TGR.GE(tlb([k[0] for k in keys]), tlb([k[1] for k in keys]),
                 torch.zeros(L + 2, dtype=torch.bool))
    assert TR.recover_verify_consistency(
        bytes_t(msgs), bytes_t(sigs), torch.tensor(rids), pub,
        device="cpu").tolist() == ok.tolist()

    # sign_recoverable, then recover the signer; signature_normalize
    ds = rand(rng, N, 3)
    sm = [rng.bytes(32) for _ in ds]
    sig, rid, sok = TR.sign_recoverable(bytes_t(sm),
                                        bytes_t([i32(d) for d in ds]),
                                        device="cpu")
    assert sok.all()
    q, qok = TR.recover(bytes_t(sm), sig, rid, device="cpu")
    assert qok.all()
    assert list(zip(lb_ints(q.x), lb_ints(q.y))) == [hc.mul(d) for d in ds]
    high = torch.cat([sig[:, :32], TS.to_bytes_be(TS.normalize(
        TS.neg(TS.from_bytes_be(sig[:, 32:])[0])))], -1)
    norm, was = TE.signature_normalize(torch.cat([sig, high]), device="cpu")
    assert was.tolist() == [False] * 3 + [True] * 3
    assert torch.equal(norm, torch.cat([sig, sig]))

    with pytest.raises(RuntimeError, match="cuda"):
        TE.recover(bytes_t(sm), sig, rid)
    assert _build.LAUNCH_COUNTS == before


@pytest.mark.slow
def test_recover_equals_the_jax_package():
    """The port's recover against the JAX package's ``ecdsa.recover``
    (jitted; its cold XLA:CPU compile is the reason for the mark), on the
    same lanes as the tier-1 item: keys, ok and infinity flags."""
    msgs, rs, ss, rids, _ = recovery_lanes(np.random.default_rng(92))
    sigs = [i32(r) + i32(s) for r, s in zip(rs, ss)]
    jq, jok = jax.jit(JE.recover)(
        jnp.asarray(np.array([list(m) for m in msgs], np.uint8)),
        jnp.asarray(np.array([list(s) for s in sigs], np.uint8)),
        jnp.asarray(np.array(rids, np.int32)))
    tq, tok = TE.recover(bytes_t(msgs), bytes_t(sigs), torch.tensor(rids),
                         device="cpu")
    assert tok.tolist() == np.asarray(jok).tolist()
    assert tq.inf.tolist() == np.asarray(jq.inf).tolist()
    fin = [i for i, f in enumerate(tq.inf.tolist()) if not f]
    jx, jy = lb_ints(jq.x), lb_ints(jq.y)
    tx, ty = lb_ints(tq.x), lb_ints(tq.y)
    assert [(tx[i], ty[i]) for i in fin] == [(jx[i] % P, jy[i] % P)
                                             for i in fin]
