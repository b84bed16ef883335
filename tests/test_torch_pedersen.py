"""Pedersen commitments and NUMS generators of the port, on the CPU: the
plain version of the ``affine_meta`` kernel against the JAX kernel body,
the field's powers and ``svdw`` against the JAX functions, and every
entry point of ``modules/generator.py`` against ``tests/oracle.py``.

* ``affine_meta_ref`` (B10) against the JAX body ``_affine_meta_kernel``
  with numpy arrays as its refs (the digit schedule as a jnp array, as
  the package hands it to the kernel) and Python integers: random points
  with random Z, Z = 0, a weak Z = p + 1, the weak zero Z = p, Y = 0, and
  y squares and non-squares.  The body runs with its limb multiply and
  square compiled (``jax.jit`` of the package's own ``_mul_limbs`` /
  ``_sqr_limbs``) and its ``fori_loop`` as a Python loop, as under
  ``jax.disable_jit()``: op by op it takes minutes, and its loop compiled
  whole takes more; the JAX package is untouched.
* ``field.sqrt`` / ``is_square`` / ``inv`` and ``svdw`` against the JAX
  functions called as they are (their scans compiled, the rest op by op)
  and Python integers; ``svdw`` at t = 0, t >= p and random t, also
  against ``oracle.svdw``.
* ``generator_generate`` (blinded and not, a blind >= n), the serializer
  and parser against ``oracle.generator_generate`` / ``generator_serialize``;
  ``pedersen_commit`` and ``pedersen_commit_bytes`` against
  ``oracle.pedersen_commit`` / ``pedersen_commitment_serialize`` on lanes
  with b = 0, v = 0, both, b >= n, an infinite generator and v = 2^64 - 1;
  the commitment parser; the tally balanced and off by one, built as
  tests/test_generator.py builds it; both blind sums against Python ints.
  The blinded generators and the commitments reach the comb's full scan
  alone (their blinds are secret), never its public gather.

Tolerance: 0 (integers, limbs, bytes).  On CPU tensors every wrapper takes
its plain version; the launch counters must not move.  These checks are
:func:`check_pedersen_generators_and_commitments`, run by
``test_torch_kernels.py::test_ecmult_glv_vs_ints`` (the commitment is the
comb and GLV Strauss without the r check, then ``affine_meta``), so the
number of items collected — on which pytest-xdist's initial chunk size
depends — stays as it was.  The whole pipeline against the JAX package's
``pedersen_commit`` is this file's ``slow`` item (a cold XLA:CPU compile
of the portable ecmult).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from secp256k1_zkp_tpu.modules import generator as JG
from secp256k1_zkp_tpu.ops import field as JF
from secp256k1_zkp_tpu.ops import group as JGR
from secp256k1_zkp_tpu.ops import pallas_field as JPF
from secp256k1_zkp_tpu.ops.limb import LB as JLB
from secp256k1_zkp_tpu_torch.modules import generator as TG
from secp256k1_zkp_tpu_torch.ops import _build, cuda_field
from secp256k1_zkp_tpu_torch.ops import field as TF
from secp256k1_zkp_tpu_torch.ops import group as TGR
from secp256k1_zkp_tpu_torch.utils import convert
from secp256k1_zkp_tpu_torch.utils import hostcurve as hc

from test_torch_kernels import trows32
from test_torch_ops import ints, rand, rows_np

P, N = hc.P, hc.N


def lanes_np(vals):
    """Python ints -> ``[B, 16]`` uint32 limb array (lane-major)."""
    return rows_np(vals).T.copy()


def tlb(vals):
    return TF.LB(torch.from_numpy(lanes_np(vals).astype(np.int64)), 0xFFFF)


def jlb(vals):
    return JLB(jnp.asarray(lanes_np(vals)), 0xFFFF)


def lb_ints(a):
    """A port or JAX ``LB`` ``[B, 16]`` -> Python ints (as stored)."""
    return ints(np.asarray(a.v).T)


def bytes_t(bs):
    return torch.tensor(np.array([list(b) for b in bs], np.uint8))


def i32(x):
    return x.to_bytes(32, "big")


def ge_list(pt):
    """A port ``GE`` -> [(x, y) or None at infinity]."""
    return [None if inf else (x, y) for x, y, inf in
            zip(lb_ints(pt.x), lb_ints(pt.y), pt.inf.tolist())]


def _jax_affine_meta(X, Y, Z, monkeypatch):
    """The JAX ``_affine_meta_kernel`` body on numpy refs (module
    docstring: its limb multiply and square compiled, its loop in
    Python)."""
    real_mul, real_sqr = JPF._mul_limbs, JPF._sqr_limbs
    mul = jax.jit(lambda a, b: real_mul(list(a), list(b)))
    sqr = jax.jit(lambda a: real_sqr(list(a)))

    def pyloop(lo, hi, body, init):
        for i in range(lo, hi):
            init = body(i, init)
        return init

    with monkeypatch.context() as m:
        m.setattr(JPF, "_mul_limbs", lambda a, b: list(mul(tuple(a),
                                                              tuple(b))))
        m.setattr(JPF, "_sqr_limbs", lambda a: list(sqr(tuple(a))))
        m.setattr(jax.lax, "fori_loop", pyloop)
        L = len(X)
        ax, ay = np.zeros((16, L), np.uint32), np.zeros((16, L), np.uint32)
        sq = np.zeros((1, L), np.uint32)
        JPF._affine_meta_kernel(
            jnp.asarray(JPF._exp_digits_msb((P - 1) // 2)), rows_np(X),
            rows_np(Y), rows_np(Z), ax, ay, sq)
    return ints(ax), ints(ay), (sq[0] != 0).tolist()


def _is_sq(a):
    return a % P != 0 and pow(a, (P - 1) // 2, P) == 1


def check_pedersen_generators_and_commitments(monkeypatch):
    rng = np.random.default_rng(90)
    before = dict(_build.LAUNCH_COUNTS)

    # -- B10: affine_meta against the JAX kernel body and Python ints -------
    pts = [hc.mul(k) for k in rand(rng, N, 8)]
    zs = [z or 1 for z in rand(rng, P, len(pts))]
    X = [p[0] * z * z % P for p, z in zip(pts, zs)]
    Y = [p[1] * pow(z, 3, P) % P for p, z in zip(pts, zs)]
    Z = list(zs)
    want = [(p[0], p[1], _is_sq(p[1])) for p in pts]
    for x, y, z, w in ((0, 1, 0, (0, 0, False)),               # infinity
                       (pts[0][0], pts[0][1], P + 1,           # weak Z = 1
                        want[0]),
                       (5, 7, P, (0, 0, False)),               # Z = p === 0
                       (pts[1][0], 0, 1, (pts[1][0], 0, False))):  # Y = 0
        X.append(x); Y.append(y); Z.append(z); want.append(w)
    ax, ay, sq = cuda_field.affine_meta(*(trows32(v) for v in (X, Y, Z)))
    assert ax.dtype == torch.int32 and ax.shape == (16, len(X))
    assert sq.dtype == torch.bool and sq.shape == (len(X),)
    got = list(zip(ints(ax), ints(ay), sq.tolist()))
    assert got == want
    assert 0 < sum(w[2] for w in want[:8]) < 8     # squares and non-squares
    assert list(zip(*_jax_affine_meta(X, Y, Z, monkeypatch))) == got

    # -- field.sqrt / is_square / inv against the JAX functions ------------
    fv = [0, 1, 2, 4, P - 1, P, 7 ** 3 + 7] + rand(rng, P, 5)
    tr, tok = TF.sqrt(tlb(fv))
    jr, jok = JF.sqrt(jlb(fv))
    r_int = [v % P for v in lb_ints(tr)]
    assert r_int == [v % P for v in lb_ints(jr)]
    assert r_int == [pow(v, (P + 1) // 4, P) for v in fv]
    assert tok.tolist() == np.asarray(jok).tolist() \
        == [r * r % P == v % P for r, v in zip(r_int, fv)]
    assert 0 < sum(tok.tolist()) < len(fv)
    assert TF.is_square(tlb(fv)).tolist() \
        == np.asarray(JF.is_square(jlb(fv))).tolist() \
        == [v % P == 0 or _is_sq(v) for v in fv]
    inv_int = [v % P for v in lb_ints(TF.inv(tlb(fv)))]
    assert inv_int == [v % P for v in lb_ints(JF.inv(jlb(fv)))] \
        == [pow(v, P - 2, P) for v in fv]

    # -- svdw ---------------------------------------------------------------
    ts = [0, 1, P + 3] + rand(rng, P, 5)
    tpt = TG.svdw(tlb(ts))
    jpt = JG.svdw(jlb(ts))
    got = ge_list(tpt)
    assert got == [oracle.svdw(t % P) for t in ts]
    assert got == list(zip(lb_ints(jpt.x), lb_ints(jpt.y)))
    assert TGR.ge_is_on_curve(tpt).all()

    # -- generators: generate (blinded and not), serialize, parse ----------
    keys = [rng.bytes(32) for _ in range(3)]
    blinds = [i32(b) for b in rand(rng, N, 2)] + [i32(N + 5)]
    gen, ok = TG.generator_generate(bytes_t(keys), device="cpu")
    assert ok.tolist() == [True] * 3
    want_g = [oracle.generator_generate(k) for k in keys]
    assert ge_list(gen) == want_g
    ser = TG.generator_serialize(gen)
    assert ser.shape == (3, 33) and ser.dtype == torch.uint8
    assert [bytes(s.tolist()) for s in ser] \
        == [oracle.generator_serialize(g) for g in want_g]
    parsed, pok = TG.generator_parse(ser, device="cpu")
    assert pok.tolist() == [True] * 3 and ge_list(parsed) == want_g
    bad = ser.clone()
    bad[0, 0] = 8                                   # a commitment's prefix
    bad[1, 1:] = torch.tensor(list(i32(P + 1)))     # x >= p
    bad[2, 1:] = torch.tensor(list(i32(5)))         # no point has x = 5
    assert not pow(5 ** 3 + 7, (P - 1) // 2, P) == 1
    assert TG.generator_parse(bad, device="cpu")[1].tolist() == [False] * 3
    from test_torch_sign import comb_entries
    (bgen, bok), comb = comb_entries(lambda: TG.generator_generate(
        bytes_t(keys), bytes_t(blinds), device="cpu"))
    assert comb == {"secret"}                       # the blind: full scan
    assert bok.tolist() == [True, True, False]      # blind >= n
    assert ge_list(bgen) == [
        oracle.generator_generate(k, i32(int.from_bytes(b, "big") % N))
        for k, b in zip(keys, blinds)]

    # -- commitments --------------------------------------------------------
    cb = rand(rng, N, 8)
    cv = [int(v) for v in rng.integers(0, 2 ** 63, 8)]
    cb[1] = 0                                       # b = 0
    cv[2] = 0                                       # v = 0
    cb[3] = N + 7                                   # b >= n
    cb[5] = cv[5] = 0                               # infinity
    cv[6] = 2 ** 64 - 1
    lane_gen = [want_g[i % 3] for i in range(8)]
    ginf = [i == 4 for i in range(8)]               # infinite generator
    gpts = TGR.GE(tlb([g[0] for g in lane_gen]), tlb([g[1] for g in lane_gen]),
                  torch.tensor(ginf))
    hi = np.array([v >> 32 for v in cv], np.uint32)
    lo = np.array([v & 0xFFFFFFFF for v in cv], np.uint32)
    (c33, cok), comb = comb_entries(lambda: TG.pedersen_commit_bytes(
        bytes_t([i32(b) for b in cb]), hi, lo, gpts, device="cpu"))
    assert comb == {"secret"}                       # b: the full scan
    want_c, want_ok = [], []
    for b, v, g, gi in zip(cb, cv, lane_gen, ginf):
        pt = hc.add(hc.mul(b % N), None if gi else hc.mul(v, g))
        want_c.append(bytes([9]) + bytes(32) if pt is None else
                      oracle.pedersen_commitment_serialize(pt))
        want_ok.append(b < N and pt is not None and not gi)
        if b < N and not gi:
            assert pt == oracle.pedersen_commit(i32(b), v, g)
    assert [bytes(c.tolist()) for c in c33] == want_c
    assert cok.tolist() == want_ok == [True, True, True, False, False, False,
                                       True, True]
    # pedersen_commit on those lanes and, in the same call, the tally's
    # lanes (one generator H for all, as tests/test_generator.py builds
    # them): 4 commitments, a balancing pair, and the pair off by one
    Hgen = oracle.generator_generate(b"\x07" * 32)
    tb = rand(rng, N, 4)
    tv = [int(v) for v in rng.integers(0, 2 ** 52, 4)]
    tb2 = [1, (sum(tb) - 1) % N]
    ab = cb + tb + tb2 + tb2
    av = cv + tv + [sum(tv) - 3, 3, sum(tv) - 3, 4]
    ag = lane_gen + [Hgen] * 8
    cj, jok = TG.pedersen_commit(
        bytes_t([i32(b) for b in ab]),
        np.array([v >> 32 for v in av], np.uint32),
        np.array([v & 0xFFFFFFFF for v in av], np.uint32),
        TGR.GE(tlb([g[0] for g in ag]), tlb([g[1] for g in ag]),
               torch.tensor(ginf + [False] * 8)), device="cpu")
    # the portable commit does not refuse an infinite generator (b*G)
    assert jok.tolist() == [True, True, True, False, True, False, True,
                            True] + [True] * 8
    fin = [i for i in range(8) if not bool(cj.inf[i])]
    assert fin == [0, 1, 2, 3, 4, 6, 7]
    cser = TG.pedersen_commitment_serialize(TGR.ge_from_gej(cj))
    assert [bytes(cser[i].tolist()) for i in fin] == [want_c[i] for i in fin]
    cpt, cpok = TG.pedersen_commitment_parse(c33[fin], device="cpu")
    assert cpok.all()
    assert [bytes(s.tolist()) for s in TG.pedersen_commitment_serialize(cpt)] \
        == [want_c[i] for i in fin]
    assert not TG.generator_parse(c33[fin], device="cpu")[1].any()

    # -- the tally: balanced, off by one, an odd number of lanes -------------
    def lanes(a, b):
        return TGR.GEJ(*(TF.LB(c.v[a:b], c.bound) for c in (cj.x, cj.y, cj.z)),
                       cj.inf[a:b])

    pos = lanes(8, 12)
    assert TG.pedersen_verify_tally(pos, lanes(12, 14))
    assert not TG.pedersen_verify_tally(pos, lanes(14, 16))
    assert TG.pedersen_verify_tally(lanes(8, 11), lanes(8, 11))

    # -- blind sums ----------------------------------------------------------
    sb = rand(rng, N, 5)
    out, sok = TG.pedersen_blind_sum(bytes_t([i32(b) for b in sb]), 3,
                                     device="cpu")
    assert bytes(out.tolist()) == i32((sum(sb[:3]) - sum(sb[3:])) % N)
    assert bool(sok)
    assert not TG.pedersen_blind_sum(
        bytes_t([i32(N)] + [i32(b) for b in sb[1:]]), 3, device="cpu")[1]
    gv = [int(v) for v in rng.integers(0, 2 ** 63, 5)]
    gr, grp = rand(rng, N, 5), rand(rng, N, 5)
    last, gok = TG.pedersen_blind_generator_blind_sum(
        np.array([v >> 32 for v in gv], np.uint32),
        np.array([v & 0xFFFFFFFF for v in gv], np.uint32),
        bytes_t([i32(r) for r in gr]), bytes_t([i32(r) for r in grp]), 2,
        device="cpu")
    final = int.from_bytes(bytes(last.tolist()), "big")
    terms = [v * r + rp for v, r, rp in zip(gv, gr, grp[:4] + [final])]
    assert bool(gok) and (sum(terms[2:]) - sum(terms[:2])) % N == 0

    # -- entry points default to the card ------------------------------------
    for call in (lambda: TG.generator_generate(bytes_t(keys)),
                 lambda: TG.pedersen_commit_bytes(
                     bytes_t([i32(1)]), hi[:1], lo[:1], gpts.to("cpu"))):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert _build.LAUNCH_COUNTS == before


@pytest.mark.slow
def test_pedersen_equals_the_jax_package(rng):
    """generator_generate (blinded) and the commit pipeline of the port
    against the JAX package's ``generator_generate`` / ``pedersen_commit``
    + ``pedersen_commitment_serialize`` (jitted: the cold XLA:CPU compile
    is the reason for the mark), both committing to the JAX package's
    generators (``convert.ge_from_jax_limbs``)."""
    keys = [rng.bytes(32) for _ in range(4)]
    blinds = [i32(b) for b in rand(rng, N, 4)]
    jgen, jok = jax.jit(JG.generator_generate)(
        jnp.asarray(np.array([list(k) for k in keys], np.uint8)),
        jnp.asarray(np.array([list(b) for b in blinds], np.uint8)))
    tgen, tok = TG.generator_generate(bytes_t(keys), bytes_t(blinds),
                                      device="cpu")
    assert tok.tolist() == np.asarray(jok).tolist()
    assert ge_list(tgen) == list(zip(
        lb_ints(JF.normalize(jgen.x)), lb_ints(JF.normalize(jgen.y))))

    cb = [i32(b) for b in rand(rng, N, 4)]
    cb[1] = bytes(32)
    cv = [int(v) for v in rng.integers(0, 2 ** 63, 4)]
    cv[2] = 0
    hi = np.array([v >> 32 for v in cv], np.uint32)
    lo = np.array([v & 0xFFFFFFFF for v in cv], np.uint32)

    @jax.jit
    def go(blind_b, hi, lo, hx, hy):
        cj, ok = JG.pedersen_commit(
            blind_b, hi, lo, JGR.GE(hx, hy, jnp.zeros(4, bool)))
        return JG.pedersen_commitment_serialize(JGR.ge_from_gej(cj)), ok

    jser, jcok = go(jnp.asarray(np.array([list(b) for b in cb], np.uint8)),
                    jnp.asarray(hi), jnp.asarray(lo), jgen.x, jgen.y)
    # the port commits to the JAX package's own generators, carried across
    hj = convert.ge_from_jax_limbs(np.asarray(JF.normalize(jgen.x).v),
                                   np.asarray(JF.normalize(jgen.y).v),
                                   np.asarray(jgen.inf))
    t33, tcok = TG.pedersen_commit_bytes(bytes_t(cb), hi, lo, hj,
                                         device="cpu")
    assert t33.tolist() == np.asarray(jser).tolist()
    assert tcok.tolist() == np.asarray(jcok).tolist()
