"""The fourth slice on the CPU: the MSM engine (B11-B14) and BIP-340 batch
verification of ``secp256k1_zkp_tpu_torch``, against the JAX package and
Python integers.

* ``gej_add`` (B11): the plain version against the JAX kernel body
  ``pallas_group._gej_add_kernel`` (numpy refs, ``jax.disable_jit()``) and
  ``hostcurve``, on random jacobian representatives with inf + P, P + inf,
  inf + inf, P + P and P + (-P) lanes; the portable ``group.gej_add``,
  ``gej_eq`` and ``ge_from_gej`` beside it.  ``msm_table`` (B12) against
  ``hostcurve.mul(d, P)`` for every entry, G on an infinite lane.
* ``msm_winreduce`` (B13): the window sums against Python integers, and
  against the JAX ``_winreduce_kernel`` body for one window of two blocks
  (``pl.program_id`` and ``pl.when`` stood in for by ``monkeypatch``);
  ``msm_finish`` (B14, one point) through ``msm_windowed`` and
  ``ops.msm.ecmult_multi`` against the analytic oracle P_i = a_i*G at
  nbits 128 and 256, on 13 lanes (no multiple of a block) with an
  infinite lane, k = 0, repeated points and a P, -P pair; its plain
  version on its own against sum_w 16^w S_w in Python ints (32 windows
  of 3 partials, an infinite partial and a window that cancels; all
  partials infinite).  ``gej_sum``'s plain version (the lane sum of the
  tally) against Python ints and the JAX ``ops/msm._tree_reduce``
  (``jax.disable_jit()``) on 13 lanes with an infinite lane and a P, -P
  pair, and ``msm._tree_reduce`` through it.
* ``_batch_digest`` and ``_batch_randomizers`` against the JAX functions
  and ``hashlib`` for n = 1, 3 and 8, the ``batch_digest`` kernel's plain
  version against the JAX ``_batch_digest`` under ``jax.disable_jit()``
  at n = 3; ``batch_verify`` against
  ``oracle.schnorr_verify`` lane by lane: valid batches of 3 and 1, the
  two-lane cancellation forgery of tests/test_pallas_tpu.py, and a flipped
  s byte (the valid batches reach the comb's public gather entry alone,
  for the sum of z*s); a flipped message byte, a key x off the curve and r >= p are
  checked broken by the oracle here and rejected by the port in the
  ``slow`` item (a CPU ``batch_verify`` takes seconds, most of it the
  plain ``msm_finish``'s 376 doublings in sequence).

Tolerance: 0 (limbs, integers, points, booleans).  Jacobian results of the
engine depend on the order of the additions and are compared as points.
The whole-path comparison with the JAX ``schnorrsig.batch_verify`` is in
the ``slow`` tier (its cold XLA:CPU compile takes minutes); run it with
``pytest tests/test_torch_batch.py -m slow``.
"""


import jax
import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from secp256k1_zkp_tpu.modules import schnorrsig as jschnorr
from secp256k1_zkp_tpu.ops import group as JGRP
from secp256k1_zkp_tpu.ops import msm as JMSMOPS
from secp256k1_zkp_tpu.ops import pallas_group as JPG
from secp256k1_zkp_tpu.ops import pallas_msm as JMSM
from secp256k1_zkp_tpu.ops.limb import LB as JLB
from secp256k1_zkp_tpu_torch.modules import schnorrsig
from secp256k1_zkp_tpu_torch.ops import _build, msm
from secp256k1_zkp_tpu_torch.ops import cuda_group as TG
from secp256k1_zkp_tpu_torch.ops import cuda_msm as TM
from secp256k1_zkp_tpu_torch.ops import cuda_sha256 as TC
from secp256k1_zkp_tpu_torch.ops import group as TGRP
from secp256k1_zkp_tpu_torch.ops.limb import LB, kernel_rows
from secp256k1_zkp_tpu_torch.utils import hostcurve as hc

from test_torch_kernels import trows32
from test_torch_ops import ints, rand, rows_np

P, N = hc.P, hc.N


def _jac(pt, z):
    """Affine point -> a jacobian representative with Z = z."""
    return pt[0] * z * z % P, pt[1] * pow(z, 3, P) % P, z


def _affine(x, y, z, inf):
    """Canonical jacobian ints -> affine ints (None at infinity)."""
    if inf:
        return None
    zi = pow(z, -1, P)
    return x * zi * zi % P, y * zi ** 3 % P


def _lb(vals):
    return LB(torch.tensor([[(v >> (16 * i)) & 0xFFFF for i in range(16)]
                            for v in vals], dtype=torch.int64), 0xFFFF)


def _ge(pts):
    """Affine points (None = infinity) -> a port ``GE``."""
    return TGRP.GE(_lb([p[0] if p else 0 for p in pts]),
                   _lb([p[1] if p else 0 for p in pts]),
                   torch.tensor([p is None for p in pts]))


def _gej_int(g):
    """0-d port ``GEJ`` -> affine ints or None."""
    return _affine(*(sum(int(v) << (16 * i) for i, v in enumerate(c.v))
                     for c in (g.x, g.y, g.z)), bool(g.inf))


def _gej_add_and_msm_table_vs_jax_and_ints():
    rng = np.random.default_rng(80)
    pts = [hc.mul(k) for k in rand(rng, N, 8)]
    bpts = [hc.mul(k) for k in rand(rng, N, 8)]
    bpts[3] = pts[3]                                   # P + P
    bpts[4] = hc.neg(pts[4])                           # P + (-P)
    ainf = [False, True, False, False, False, True, False, False]
    binf = [False, False, True, False, False, True, False, False]
    zs = rand(rng, P - 1, 16)
    A = [_jac(p, z + 1) for p, z in zip(pts, zs)]
    B = [_jac(p, z + 1) for p, z in zip(bpts, zs[8:])]
    a = tuple(trows32([t[k] for t in A]) for k in range(3)) \
        + (torch.tensor(ainf),)
    b = tuple(trows32([t[k] for t in B]) for k in range(3)) \
        + (torch.tensor(binf),)
    before = dict(_build.LAUNCH_COUNTS)
    x, y, z, inf = TG.gej_add(a, b)
    assert x.dtype == torch.int32 and x.shape == (16, 8)
    assert inf.dtype == torch.bool and inf.shape == (8,)
    got = [_affine(*v) for v in zip(ints(x), ints(y), ints(z), inf.tolist())]
    want = [hc.add(None if ai else p, None if bi else q)
            for p, q, ai, bi in zip(pts, bpts, ainf, binf)]
    assert got == want and want[4] is None and want[5] is None
    out = [np.zeros((16, 8), np.uint32) for _ in range(3)] \
        + [np.zeros((1, 8), np.uint32)]
    with jax.disable_jit():
        JPG._gej_add_kernel(
            *(rows_np([t[k] for t in A]) for k in range(3)),
            np.array([ainf], np.uint32),
            *(rows_np([t[k] for t in B]) for k in range(3)),
            np.array([binf], np.uint32), *out)
    # the JAX body stores weak limbs; compare the residues and the flags
    for mine, theirs in zip((x, y, z), out[:3]):
        assert ints(mine) == [v % P for v in ints(theirs)]
    assert inf.tolist() == (out[3][0] != 0).tolist()

    # the portable helpers of ops/group.py on the same points
    ga = TGRP.GEJ(*(_lb([t[k] for t in A]) for k in range(3)),
                  torch.tensor(ainf))
    gb = TGRP.GEJ(*(_lb([t[k] for t in B]) for k in range(3)),
                  torch.tensor(binf))
    s = TGRP.gej_add(ga, gb)
    aff = TGRP.ge_from_gej(s)
    assert [None if i else (xx, yy) for xx, yy, i in zip(
        ints(aff.x.v.T), ints(aff.y.v.T), aff.inf.tolist())] == want
    assert TGRP.gej_eq(s, s).all()
    # the same points at other Z are equal; P + P is not P
    ga2 = TGRP.GEJ(*(_lb([_jac(p, 7)[k] for p in pts]) for k in range(3)),
                   torch.tensor(ainf))
    assert TGRP.gej_eq(ga, ga2).tolist() == [True] * 8
    assert TGRP.gej_eq(s, ga).tolist() == [
        False, False, True, False, False, True, False, False]

    # B12: every entry of the table against d*P, G on the infinite lane
    tpts = pts[:5]
    tinf = torch.tensor([False, False, True, False, False])
    tab = TM.msm_table(trows32([p[0] for p in tpts]),
                       trows32([p[1] for p in tpts]), tinf)
    assert tab.dtype == torch.int32 and tab.shape == (5, TM.NENT, 16)
    limbs = TM._unpack_words(tab)
    for i, p in enumerate(tpts):
        base = hc.G if tinf[i] else p
        for d in range(1, TM.NENT + 1):
            xy = [sum(int(v) << (16 * j) for j, v in
                      enumerate(limbs[i, d - 1, 16 * h:16 * h + 16]))
                  for h in (0, 1)]
            assert tuple(xy) == hc.mul(d, base), (i, d)
    assert _build.LAUNCH_COUNTS == before


def _msm_lanes(rng, lanes, nbits):
    """Points a_i*G with an infinite lane, repeated points and a P, -P
    pair; scalars below 2^nbits with a zero."""
    a = rand(rng, N, lanes)
    a[2] = a[1]
    a[3] = N - a[1]
    a[6] = a[5]
    k = [v % (1 << nbits) for v in rand(rng, N, lanes)]
    k[4] = 0
    pts = [hc.mul(v) for v in a]
    pts[7] = None
    want = sum(kk * aa for kk, aa, p in zip(k, a, pts) if p) % N
    return k, pts, (hc.mul(want) if want else None)


def _jax_table_rows(tab):
    """Port table ``[N, 15, 16]`` words -> the TPU kernel's ``[480, N]``
    layout: entry t at rows [32t, 32t + 32), x limbs then y limbs."""
    limbs = TM._unpack_words(tab)                   # [N, 15, 32]
    return limbs.permute(1, 2, 0).reshape(32 * TM.NENT, -1).numpy() \
        .astype(np.uint32)


def _msm_engine_vs_ints_and_jax_winreduce(monkeypatch):
    rng = np.random.default_rng(81)
    before = dict(_build.LAUNCH_COUNTS)

    # B13 on 8 lanes, 2 chunks: window sums vs ints and the JAX body
    k, pts, _ = _msm_lanes(rng, 8, 256)
    g = _ge(pts)
    px, py = kernel_rows(g.x), kernel_rows(g.y)
    tab = TM.msm_table(px, py, g.inf)
    nwin = 64
    digs = TM.digits_u4(kernel_rows(_lb(k)), nwin)
    parts = TM.msm_winreduce(digs, tab, g.inf, 2)
    assert parts[0].shape == (16, 2 * nwin) and parts[3].shape == (2 * nwin,)
    ax, ay, winf = TM.points_affine(*parts, nwin)
    for w in range(nwin):
        want = None
        for kk, p in zip(k, pts):
            d = (kk >> (4 * w)) & 15
            if p and d:
                want = hc.add(want, hc.mul(d, p))
        got = None if winf[w] else (ints(ax[:, w:w + 1])[0],
                                    ints(ay[:, w:w + 1])[0])
        assert got == want, w

    # the JAX kernel body: window 5, two blocks of 4 lanes into its
    # per-lane accumulator, then the 4 lanes summed as points
    w, tb = 5, 4
    state = {"b": 0}
    monkeypatch.setattr(jpl, "program_id", lambda axis: state["b"])
    monkeypatch.setattr(jpl, "when",
                        lambda cond: (lambda f: f() if cond else None))
    jtab = _jax_table_rows(tab)
    jd = digs.numpy().astype(np.uint32)
    jinf = g.inf.numpy().astype(np.uint32)
    acc = [np.zeros((16, tb), np.uint32) for _ in range(3)] \
        + [np.zeros((1, tb), np.uint32)]
    with jax.disable_jit():
        for blk in range(2):
            state["b"] = blk
            lanes = slice(blk * tb, (blk + 1) * tb)
            JMSM._winreduce_kernel(jd[w:w + 1, lanes], jtab[:, lanes],
                                   jinf[None, lanes], *acc, nblk=2)
    # the JAX body stores weak limbs: canonicalise before the sum
    jsum = TM.points_affine(*(TG.canon_p(torch.from_numpy(
        v.astype(np.int64))).to(torch.int32) for v in acc[:3]),
        torch.from_numpy(acc[3][0] != 0), 1)
    assert [ints(jsum[0]), ints(jsum[1]), jsum[2].tolist()] == \
        [ints(ax[:, w:w + 1]), ints(ay[:, w:w + 1]), [bool(winf[w])]]

    # B14 through msm_windowed / ecmult_multi
    for nbits in (128, 256):
        k, pts, want = _msm_lanes(rng, 13, nbits)
        if nbits == 128:
            got = TM.msm_windowed(_lb(k), _ge(pts), nbits=128)
        else:
            got = msm.ecmult_multi(_lb(k), _ge(pts), device="cpu")
        assert got.x.v.shape == (16,) and got.inf.shape == ()
        assert _gej_int(got) == want, nbits
    with pytest.raises(ValueError, match="128 or 256"):
        TM.msm_windowed(_lb(k), _ge(pts), nbits=200)
    with pytest.raises(ValueError, match="exceeds 128 bits"):
        TM.msm_windowed(_lb([1 << 200] * 13), _ge(pts), nbits=128)
    empty = msm.ecmult_multi(LB(torch.zeros((0, 16), dtype=torch.int64),
                                0xFFFF), _ge([]), device="cpu")
    assert bool(empty.inf)
    with pytest.raises(NotImplementedError):
        msm.ecmult_multi(LB(torch.zeros((2, 3, 16), dtype=torch.int64),
                            0xFFFF), _ge(pts), device="cpu")
    assert _build.LAUNCH_COUNTS == before


def _jac_rows(rng, pts):
    """Affine points (None = infinity) -> int32 x, y, z ``[16, B]`` of
    jacobian representatives with random Z, and the ``[B]`` flags."""
    zs = rand(rng, P - 1, len(pts))
    cols = [(0, 1, 1) if p is None else _jac(p, z + 1)
            for p, z in zip(pts, zs)]
    return tuple(trows32([c[k] for c in cols]) for k in range(3)) \
        + (torch.tensor([p is None for p in pts]),)


def _finish_and_lane_sum_vs_ints_and_jax():
    rng = np.random.default_rng(85)
    before = dict(_build.LAUNCH_COUNTS)
    # B14's plain version (the kernel's order) on 32 windows of 3
    # partials: an infinite partial, window 4 = P + (-P) + infinity
    nwin, nblk = 32, 3
    pts = [hc.mul(k) for k in rand(rng, N, nwin * nblk)]
    pts[10] = None
    pts[12:15] = [pts[0], hc.neg(pts[0]), None]
    want = None
    for w in reversed(range(nwin)):
        for _ in range(4):
            want = hc.add(want, want)
        for p in pts[w * nblk:(w + 1) * nblk]:
            want = hc.add(want, p)
    for parts, expect in ((pts, want), ([None] * len(pts), None)):
        out = TM.msm_finish_ref(*_jac_rows(rng, parts), nwin)
        assert out[0].shape == (16, 1) and out[3].shape == (1,)
        assert _affine(*(ints(c)[0] for c in out[:3]), bool(out[3][0])) \
            == expect
    # gej_sum's plain version, the JAX _tree_reduce and the port's
    # _tree_reduce on 13 lanes: lane 5 infinite, lanes 8 and 9 P and -P
    pts = [hc.mul(k) for k in rand(rng, N, 13)]
    pts[5] = None
    pts[9] = hc.neg(pts[8])
    want = None
    for p in pts:
        want = hc.add(want, p)
    x, y, z, inf = _jac_rows(rng, pts)
    out = TG.gej_sum_ref(x, y, z, inf)
    assert out[0].shape == (16, 1) and out[3].shape == (1,)
    assert _affine(*(ints(c)[0] for c in out[:3]), bool(out[3][0])) == want
    jgej = JGRP.GEJ(*(JLB(jnp.asarray(c.numpy().T.astype(np.uint32)), 0xFFFF)
                      for c in (x, y, z)), jnp.asarray(inf.numpy()))
    with jax.disable_jit():
        jr = JMSMOPS._tree_reduce(jgej)
    jint = [sum(int(v) << (16 * i) for i, v in enumerate(
        np.asarray(c.v).tolist())) % P for c in (jr.x, jr.y, jr.z)]
    assert _affine(*jint, bool(jr.inf)) == want
    port = msm._tree_reduce(TGRP.GEJ(*(LB(c.T.to(torch.int64), 0xFFFF)
                                       for c in (x, y, z)), inf))
    assert port.x.v.shape == (16,) and _gej_int(port) == want
    assert _build.LAUNCH_COUNTS == before


def _signed_batch(rng, n):
    """n valid BIP-340 signatures from ``oracle.schnorr_sign``."""
    msgs = np.zeros((n, 32), np.uint8)
    sigs = np.zeros((n, 64), np.uint8)
    pxs = np.zeros((n, 32), np.uint8)
    for i in range(n):
        d = rand(rng, N, 1)[0] or 1
        msg = rng.bytes(32)
        msgs[i] = np.frombuffer(msg, np.uint8)
        sigs[i] = np.frombuffer(oracle.schnorr_sign(msg, d), np.uint8)
        pxs[i] = np.frombuffer(hc.mul(d)[0].to_bytes(32, "big"), np.uint8)
    return msgs, sigs, pxs


def _host_randomizers(msgs, sigs, pxs, seed=bytes(32)):
    """(root, z) of the batch with ``hashlib``: leaf hashes of pk || msg ||
    sig, a node tree padding odd levels with a zero node, z_i =
    H_tag(seed || root || i) mod 2^128, z_0 = 1."""
    nodes = [oracle.tagged_hash("BIP0340/batch/leaf", bytes(p) + bytes(m)
                                + bytes(s))
             for p, m, s in zip(pxs, msgs, sigs)]
    while len(nodes) > 1:
        if len(nodes) % 2:
            nodes.append(bytes(32))
        nodes = [oracle.tagged_hash("BIP0340/batch/node", a + b)
                 for a, b in zip(nodes[::2], nodes[1::2])]
    z = [int.from_bytes(oracle.tagged_hash(
        "BIP0340/batch", seed + nodes[0] + i.to_bytes(4, "big")), "big")
        % (1 << 128) for i in range(len(msgs))]
    z[0] = 1
    return nodes[0], z


def _port_args(msgs, sigs, pxs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (msgs, sigs, pxs))


def _batch_randomizers_and_valid_batches_vs_jax_and_oracle():
    rng = np.random.default_rng(82)
    msgs, sigs, pxs = _signed_batch(rng, 8)
    seed = bytes(range(32))
    for n in (1, 3, 8):
        args = _port_args(msgs[:n], sigs[:n], pxs[:n])
        jargs = tuple(jnp.asarray(a[:n]) for a in (msgs, sigs, pxs))
        root, z = _host_randomizers(msgs[:n], sigs[:n], pxs[:n])
        digest = schnorrsig._batch_digest(*args, n)
        assert bytes(digest.numpy()) == root
        zp = schnorrsig._batch_randomizers(*args, None, n)
        assert ints(zp.v.T) == z
        # jitted (two seconds of compile each; eager takes 6-9 s a call)
        jdig = jax.jit(jschnorr._batch_digest, static_argnums=3)(*jargs, n)
        jz = jax.jit(jschnorr._batch_randomizers,
                     static_argnums=(3, 4))(*jargs, None, n)
        assert np.asarray(jdig).tolist() == digest.tolist()
        assert np.asarray(jz.v).astype(np.int64).tolist() == zp.v.tolist()
    # the batch_digest kernel's plain version against the JAX function run
    # eagerly (n = 3: a padded level)
    with jax.disable_jit():
        jdig = jschnorr._batch_digest(
            *(jnp.asarray(a[:3]) for a in (msgs, sigs, pxs)), 3)
    assert np.asarray(jdig).tolist() == TC.batch_digest_ref(
        *_port_args(pxs[:3], msgs[:3], sigs[:3])).tolist()
    # a caller's seed, n = 3
    jzs = jax.jit(jschnorr._batch_randomizers, static_argnums=4)(
        *(jnp.asarray(a[:3]) for a in (msgs, sigs, pxs)),
        jnp.asarray(np.frombuffer(seed, np.uint8)), 3)
    zs = schnorrsig._batch_randomizers(
        *_port_args(msgs[:3], sigs[:3], pxs[:3]),
        torch.tensor(list(seed), dtype=torch.uint8), 3)
    assert np.asarray(jzs.v).astype(np.int64).tolist() == zs.v.tolist()
    assert ints(zs.v.T) == _host_randomizers(msgs[:3], sigs[:3], pxs[:3],
                                             seed)[1]

    from test_torch_sign import comb_entries
    before = dict(_build.LAUNCH_COUNTS)
    for n in (3, 1):
        for j in range(n):
            assert oracle.schnorr_verify(bytes(msgs[j]), int.from_bytes(
                bytes(pxs[j]), "big"), bytes(sigs[j]))
        ok, comb = comb_entries(lambda: schnorrsig.batch_verify(
            *_port_args(msgs[:n], sigs[:n], pxs[:n]), device="cpu"))
        assert ok.dtype == torch.bool and ok.shape == () and bool(ok), n
        assert comb == {"public"}           # sum z*s: the comb's gather
    # the two-lane cancellation forgery of tests/test_pallas_tpu.py
    (label, m, s, p), = _corruptions(msgs[:3], sigs[:3], pxs[:3],
                                     ("forgery",))
    assert not oracle.schnorr_verify(bytes(m[0]), int.from_bytes(
        bytes(p[0]), "big"), bytes(s[0]))
    ok = schnorrsig.batch_verify(*_port_args(m, s, p), device="cpu")
    assert ok.shape == () and not bool(ok), label
    assert _build.LAUNCH_COUNTS == before
    with pytest.raises(ValueError, match="at least one"):
        schnorrsig.batch_verify(*_port_args(msgs[:0], sigs[:0], pxs[:0]),
                                device="cpu")
    if not torch.cuda.is_available():
        # the default device is the card: with none present, refuse
        with pytest.raises(RuntimeError, match="cuda"):
            schnorrsig.batch_verify(*_port_args(msgs[:1], sigs[:1],
                                                pxs[:1]))
        with pytest.raises(RuntimeError, match="cuda"):
            msm.ecmult_multi(_lb([1]), _ge([hc.G]))


CORRUPTIONS = ("flipped s byte", "flipped msg", "key x off the curve",
               "r >= p", "forgery")


def _corruptions(msgs, sigs, pxs, labels=CORRUPTIONS):
    """(label, msgs, sigs, pxs) of batches each broken in one way."""
    out = []

    def variant(label, fn):
        m, s, p = msgs.copy(), sigs.copy(), pxs.copy()
        fn(m, s, p)
        out.append((label, m, s, p))

    def flip_s(m, s, p):
        s[1, 40] ^= 1

    def flip_msg(m, s, p):
        m[2, 4] ^= 0x20

    def off_curve(m, s, p):
        x = 5
        while oracle.lift_x_even_y(x) is not None:
            x += 1
        p[0] = np.frombuffer(x.to_bytes(32, "big"), np.uint8)

    def r_ge_p(m, s, p):
        r = P + int.from_bytes(bytes(s[2, :32]), "big") % (2 ** 256 - P)
        s[2, :32] = np.frombuffer(r.to_bytes(32, "big"), np.uint8)

    def forgery(m, s, p):
        # s_0 += z_1 * t, s_1 -= t with z of the unmodified batch: the
        # cancellation that per-lane randomizers admitted
        z1 = _host_randomizers(msgs, sigs, pxs)[1][1]
        t = 0xDEADBEEF
        s0 = int.from_bytes(bytes(sigs[0, 32:]), "big")
        s1 = int.from_bytes(bytes(sigs[1, 32:]), "big")
        s[0, 32:] = np.frombuffer(((s0 + z1 * t) % N).to_bytes(32, "big"),
                                  np.uint8)
        s[1, 32:] = np.frombuffer(((s1 - t) % N).to_bytes(32, "big"),
                                  np.uint8)

    for label, fn in zip(CORRUPTIONS, (flip_s, flip_msg, off_curve, r_ge_p,
                                       forgery)):
        if label in labels:
            variant(label, fn)
    return out


def _batch_verify_rejects_a_corruption():
    """Each corruption breaks a lane by the oracle's verdict; the port's
    ``batch_verify`` rejects the flipped s byte here (the others, at about
    14 s a CPU call, in the slow item, beside the JAX package)."""
    rng = np.random.default_rng(83)
    msgs, sigs, pxs = _signed_batch(rng, 3)
    before = dict(_build.LAUNCH_COUNTS)
    for label, m, s, p in _corruptions(msgs, sigs, pxs, CORRUPTIONS[:4]):
        lanes = [oracle.schnorr_verify(bytes(m[j]), int.from_bytes(
            bytes(p[j]), "big"), bytes(s[j])) for j in range(3)]
        assert not all(lanes), label
        if label == "flipped s byte":
            ok = schnorrsig.batch_verify(*_port_args(m, s, p), device="cpu")
            assert ok.shape == () and not bool(ok), label
    assert _build.LAUNCH_COUNTS == before


def test_msm_engine_and_batch_verify(monkeypatch):
    """All the checks above as one tier-1 item: the tier-1 xdist run
    hands each worker a first chunk of N // 6 // 4 consecutive items, and
    N = 191 (one new item) keeps that chunk at 7 as before this file (see
    ROADMAP, "Tests must be reached")."""
    _gej_add_and_msm_table_vs_jax_and_ints()
    _msm_engine_vs_ints_and_jax_winreduce(monkeypatch)
    _finish_and_lane_sum_vs_ints_and_jax()
    _batch_randomizers_and_valid_batches_vs_jax_and_oracle()
    _batch_verify_rejects_a_corruption()


@pytest.mark.slow
def test_batch_verify_equals_the_jax_package():
    """The whole path against the JAX ``schnorrsig.batch_verify`` (jit,
    minutes of XLA:CPU compile when cold) on a valid batch and on each
    corruption: the only item where the port meets a flipped message
    byte, a key x off the curve and r >= p."""
    rng = np.random.default_rng(84)
    msgs, sigs, pxs = _signed_batch(rng, 3)
    cases = [("valid", msgs, sigs, pxs)] + _corruptions(msgs, sigs, pxs)
    jfn = jax.jit(jschnorr.batch_verify)
    for label, m, s, p in cases:
        ok = schnorrsig.batch_verify(*_port_args(m, s, p), device="cpu")
        jok = jfn(jnp.asarray(m), jnp.asarray(s), jnp.asarray(p))
        assert bool(ok) == bool(np.asarray(jok)) == (label == "valid"), \
            label
