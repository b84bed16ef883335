"""NUMS generators (Shallue-van de Woestijne hash-to-curve) and Pedersen
commitments on PyTorch tensors.

Counterpart of the JAX package's ``modules/generator.py`` (the reference's
modules/generator/main_impl.h and pedersen_impl.h):

* :func:`svdw` — the SvdW map, a mask/select dataflow in plain PyTorch on
  both devices (its inverse and square roots are ``field``'s fixed-window
  powers, as in the JAX package);
* :func:`generator_generate` — H = svdw(SHA256("1st generation: " || key))
  + svdw(SHA256("2nd generation: " || key)) [+ b*G];
* :func:`pedersen_commit` — commit = b*G + v*H as a jacobian point, and
  :func:`pedersen_commit_bytes`, the kernel pipeline of
  ``pedersen_commit_tpu``: the fixed-base comb for b*G, GLV Strauss for
  v*H + b*G, the ``affine_meta`` kernel for the 33-byte form;
* serialization and parsing, blind sums and the tally check.

Serialization is 33 bytes: prefix 10|11 for generators, 8|9 for
commitments, with bit 0 set where y is not a square; parsing recovers y as
the root that is a square (the reference's ge_set_xquad).  On a card every
step but ``svdw`` and the scalar glue runs a hand-written kernel: SHA-256,
the comb, GLV Strauss, ``gej_add``, ``affine_xy``, ``affine_meta``,
``lift_x``; on the CPU their plain versions.  Entry points that take bytes
or integers have ``device="cuda"`` (which raises without a card); those
that take points follow the points' device.
"""

from __future__ import annotations

import torch

from ..config import resolve_device
from ..ops import cuda_field, cuda_gen, cuda_group, msm
from ..ops import field as F
from ..ops import group as G
from ..ops import scalar as S
from ..ops import sha256 as H
from ..ops.cuda_scalar import recode_w5
from ..ops.group import GE, GEJ
from ..ops.limb import LB, LIMBS, MASK16, from_rows, kernel_rows

# SvdW constants: c = sqrt(-3) (the principal root), d = (c - 1) / 2 — the
# negc and d of the reference (main_impl.h:131-132)
_C = pow(F.P - 3, (F.P + 1) // 4, F.P)
_NEGC = F.P - _C
_D = (_C - 1) * pow(2, -1, F.P) % F.P

_PREFIX1 = b"1st generation: "
_PREFIX2 = b"2nd generation: "
_GEN_PREFIX, _COMMIT_PREFIX = 10, 8


def svdw(t: LB) -> GE:
    """Map field elements (any batch shape) to curve points, never
    infinity: x1 where its x^3 + 7 is a square, else x2, else x3, with y
    the principal root negated where t is odd (main_impl.h:94-202).  At
    t = 0 the inverse is inv(0) = 0, as in the reference."""
    dev = t.device
    t2 = F.sqr(t)
    wd = F.norm_weak(F.add(t2, F.fe(F.B_COEFF + 1, dev)))     # 1 + b + t^2
    x3d = F.norm_weak(F.neg(F.FP.norm_if_needed(F.mul_int(t2, 3))))
    jinv = F.inv(F.mul(wd, x3d))
    x1 = F.norm_weak(F.add(F.mul(F.mul(F.mul(F.fe(_NEGC, dev), t2), x3d),
                                 jinv), F.fe(_D, dev)))
    x2 = F.norm_weak(F.neg(F.norm_weak(F.add(x1, F.fe(1, dev)))))
    wd3 = F.mul(F.sqr(wd), wd)
    x3 = F.norm_weak(F.add(F.mul(wd3, jinv), F.fe(1, dev)))

    # the three candidates' square roots as one chain, stacked in front
    xs = LB(torch.stack([x1.v, x2.v, x3.v], 0), MASK16)
    rhs = F.norm_weak(F.add(F.mul(F.sqr(xs), xs), F.fe(F.B_COEFF, dev)))
    ys, qs = F.sqrt(rhs)
    y1, y2, y3 = (LB(v, ys.bound) for v in ys.v.unbind(0))
    aq, bq = qs[0], qs[1]
    x = F.select(aq, x1, F.select(bq, x2, x3))
    y = F.normalize(F.select(aq, y1, F.select(bq, y2, y3)))
    y = F.normalize(F.select(F.is_odd(F.normalize(t)), F.neg(y), y))
    return GE(F.normalize(x), y,
              torch.zeros(y.batch_shape, dtype=torch.bool, device=dev))


def _bytes_batch(b, dev, width: int = 32) -> torch.Tensor:
    b = torch.as_tensor(b).to(dev)
    if b.dim() != 2 or b.shape[1] != width:
        raise ValueError(f"expected a 1-D batch of {width}-byte strings "
                         f"[B, {width}], got {tuple(b.shape)}")
    return b


def _prefixed(prefix: bytes, key32: torch.Tensor) -> torch.Tensor:
    pre = torch.tensor(list(prefix), dtype=torch.uint8, device=key32.device)
    return torch.cat([pre.expand(key32.shape[0], len(prefix)), key32], -1)


def generator_generate(key32, blind32=None, device="cuda"):
    """key32 ``[B, 32]`` uint8 -> (H ``GE``, ok ``[B]``): the NUMS
    generator of each key, plus b*G where ``blind32`` (``[B, 32]``) is
    given (generator_generate_blinded, main_impl.h:204-264).

    ok is false where a hash is >= p (fe_set_b32_limit) or the blind is
    >= n; those lanes are computed all the same.  Both hashes of a lane
    are one ``sha256_msg`` launch for the 2B messages and both maps one
    ``svdw`` over 2B lanes; H1 + H2 and + b*G are ``gej_add`` launches,
    b*G the comb, the affine result ``affine_xy``."""
    dev = resolve_device(device)
    key32 = _bytes_batch(key32, dev)
    lanes = key32.shape[0]
    if lanes == 0:                           # nothing to launch
        z = F.fe_zero((0,), dev)
        none = torch.zeros(0, dtype=torch.bool, device=dev)
        return GE(z, z, none), none
    msgs = torch.cat([_prefixed(_PREFIX1, key32), _prefixed(_PREFIX2, key32)])
    t, t_ovf = F.from_bytes_be(H.sha256_digest(msgs))
    pts = svdw(t)
    p1, p2 = (GE(LB(pts.x.v[k], MASK16), LB(pts.y.v[k], MASK16), pts.inf[k])
              for k in (slice(0, lanes), slice(lanes, None)))
    acc = G.gej_add_ge(G.gej_from_ge(p1), p2)
    ok = ~t_ovf[:lanes] & ~t_ovf[lanes:]
    if blind32 is not None:
        b, b_ovf = S.from_bytes_be(_bytes_batch(blind32, dev))
        x, y, z = cuda_gen.ecmult_gen(kernel_rows(b))     # z = 0: infinity
        acc = G.gej_add(GEJ(from_rows(x), from_rows(y), from_rows(z),
                            (z == 0).all(0)), acc)
        ok = ok & ~b_ovf
    return G.ge_from_gej(acc), ok


def _serialize(pt: GE, prefix: int) -> torch.Tensor:
    """[prefix | y not a square] || x, through ``affine_meta`` with z = 1
    (x canonical, y's character); ``[B, 33]`` uint8."""
    if pt.inf.shape[0] == 0:
        return torch.zeros((0, 33), dtype=torch.uint8, device=pt.device)
    x, y = (kernel_rows(F.norm_weak(c)) for c in (pt.x, pt.y))
    one = torch.zeros_like(x)
    one[0] = 1
    xa, _, sq = cuda_field.affine_meta(x, y, one)
    pre = torch.where(sq, prefix, prefix + 1).to(torch.uint8)
    return torch.cat([pre[:, None], F.to_bytes_be(from_rows(xa))], -1)


def generator_serialize(gen: GE) -> torch.Tensor:
    """``[B, 33]`` uint8: [10 | y not a square] || x (generator_save), on
    the points' device."""
    return _serialize(gen, _GEN_PREFIX)


def _parse_xquad(b33, lo_prefix: int, device):
    """33 bytes -> (GE, ok): x, and the root of x^3 + 7 that is a square
    (the principal root a^((p+1)/4); p = 3 mod 4 makes exactly one of ±y a
    square), negated where the prefix's bit 0 is set.  ``lift_x`` gives
    the even root, ``affine_meta`` (z = 1) its character."""
    dev = resolve_device(device)
    b33 = _bytes_batch(b33, dev, 33)
    prefix = b33[:, 0].to(torch.int64)
    x, xovf = F.from_bytes_be(b33[:, 1:])
    if b33.shape[0] == 0:
        return GE(x, x, xovf.clone()), xovf
    xr = kernel_rows(x)
    ye, on_curve = cuda_field.lift_x(xr)
    one = torch.zeros_like(xr)
    one[0] = 1
    _, _, sq = cuda_field.affine_meta(xr, ye, one)
    ye = ye.to(torch.int64)
    neg = cuda_field._neg_canon(ye)
    flip = sq == ((prefix & 1) == 1)             # square root, then bit 0
    y = torch.where(flip[None, :], neg, ye)
    ok = ((prefix & 0xFE) == lo_prefix) & ~xovf & on_curve
    return GE(x, from_rows(y), ~ok), ok


def generator_parse(b33, device="cuda"):
    """``[B, 33]`` uint8 -> (GE, ok): ok where the prefix is 10 or 11, x < p
    and x is on the curve (generator_parse)."""
    return _parse_xquad(b33, _GEN_PREFIX, device)


def pedersen_scalar_from_u32_pair(hi, lo) -> LB:
    """(hi, lo) 32-bit halves ``[...]`` -> the 64-bit value as scalar limbs
    ``[..., 16]``."""
    hi = torch.as_tensor(hi).to(torch.int64) & 0xFFFFFFFF
    lo = torch.as_tensor(lo).to(torch.int64) & 0xFFFFFFFF
    z = torch.zeros((*hi.shape, LIMBS), dtype=torch.int64, device=hi.device)
    z[..., 0] = lo & MASK16
    z[..., 1] = lo >> 16
    z[..., 2] = hi & MASK16
    z[..., 3] = hi >> 16
    return LB(z, MASK16)


def _commit_rows(b: LB, v: LB, gen: GE):
    """b*G + v*H as jacobian kernel rows (x, y, z canonical, inf ``[B]``):
    the comb for b*G, then GLV Strauss with v on the a1 stream (v < 2^64
    needs no lambda split: its signed-w5 digits of limbs 0-7, rows 26-51
    and both sign flags zero) joined with b*G.  An infinite generator
    lane runs with G in its place and its adds masked: b*G."""
    vt = kernel_rows(v)
    lanes = vt.shape[1]
    digs = torch.cat([recode_w5(vt[:8].to(torch.int64)).to(torch.int32),
                      vt.new_zeros((26, lanes))])
    flags = vt.new_zeros((2, lanes))
    gjac = cuda_gen.fixedbase_digits(cuda_gen.gen_digits(kernel_rows(b)))
    return cuda_group.ecmult_glv(
        digs, flags, kernel_rows(F.normalize(gen.x)),
        kernel_rows(F.normalize(gen.y)), gen.inf, gjac, rx=None)[:4]


def _commit_inputs(blind32, value_hi, value_lo, gen: GE, device):
    dev = resolve_device(device)
    blind32 = _bytes_batch(blind32, dev)
    b, b_ovf = S.from_bytes_be(blind32)
    v = pedersen_scalar_from_u32_pair(torch.as_tensor(value_hi).to(dev),
                                      torch.as_tensor(value_lo).to(dev))
    return b, b_ovf, v, gen.to(dev)


def pedersen_commit(blind32, value_hi, value_lo, gen: GE, device="cuda"):
    """commit = b*G + v*H -> (``GEJ`` ``[B]``, ok ``[B]``) for blinds
    ``[B, 32]`` uint8, 64-bit values as 32-bit halves ``[B]`` and
    generators ``gen`` (a ``GE`` of B points) (pedersen_commit,
    main_impl.h:309).  ok is false where b >= n or the commitment is
    infinity.  On a card the comb and GLV Strauss kernels."""
    b, b_ovf, v, gen = _commit_inputs(blind32, value_hi, value_lo, gen,
                                      device)
    if b_ovf.shape[0] == 0:
        return G.gej_infinity((0,), b_ovf.device), b_ovf
    x, y, z, inf = _commit_rows(b, v, gen)
    return GEJ(from_rows(x), from_rows(y), from_rows(z), inf), ~b_ovf & ~inf


def pedersen_commit_bytes(blind32, value_hi, value_lo, gen: GE,
                          device="cuda"):
    """Batched commit straight to bytes -> (commit33 ``[B, 33]`` uint8, ok
    ``[B]``): the same semantics as :func:`pedersen_commit` followed by
    :func:`pedersen_commitment_serialize`, and the pipeline of the JAX
    ``pedersen_commit_tpu``: the comb for b*G, GLV Strauss for v*H + b*G,
    ``affine_meta`` for x and the prefix — three kernel launches on a card.
    ok is also false where the generator is infinite."""
    b, b_ovf, v, gen = _commit_inputs(blind32, value_hi, value_lo, gen,
                                      device)
    if b_ovf.shape[0] == 0:
        return (torch.zeros((0, 33), dtype=torch.uint8, device=b_ovf.device),
                b_ovf)
    x, y, z, inf = _commit_rows(b, v, gen)
    xa, _, sq = cuda_field.affine_meta(x, y, z)
    pre = torch.where(sq, _COMMIT_PREFIX, _COMMIT_PREFIX + 1)
    commit33 = torch.cat([pre.to(torch.uint8)[:, None],
                          F.to_bytes_be(from_rows(xa))], -1)
    return commit33, ~b_ovf & ~inf & ~gen.inf


def pedersen_commitment_serialize(c: GE) -> torch.Tensor:
    """``[B, 33]`` uint8: [8 | y not a square] || x
    (pedersen_commitment_save), on the points' device."""
    return _serialize(c, _COMMIT_PREFIX)


def pedersen_commitment_parse(b33, device="cuda"):
    """``[B, 33]`` uint8 -> (GE, ok): ok where the prefix is 8 or 9, x < p
    and x is on the curve (pedersen_commitment_parse)."""
    return _parse_xquad(b33, _COMMIT_PREFIX, device)


def pedersen_blind_sum(blinds32, npositive: int, device="cuda"):
    """sum(first npositive) - sum(rest) mod n over the leading axis of
    ``blinds32`` ``[n, ..., 32]`` (pedersen_blind_sum, main_impl.h:330).
    Returns (blind32 ``[..., 32]``, ok): ok is false if any blind
    overflowed n."""
    dev = resolve_device(device)
    b, ovf = S.from_bytes_be(torch.as_tensor(blinds32).to(dev))
    acc = S.zero(b.batch_shape[1:], dev)
    for i in range(b.v.shape[0]):
        x = LB(b.v[i], MASK16)
        if i < npositive:
            acc = S.add(acc, x)
        else:
            acc = S.sub(S.FN.norm_if_needed(acc), x)
        acc = S.FN.norm_weak(acc)
    return S.to_bytes_be(S.normalize(acc)), ~ovf.any(0)


def pedersen_blind_generator_blind_sum(values_hi, values_lo,
                                       generator_blinds32, blinding32,
                                       n_inputs: int, device="cuda"):
    """The final blinding factor of a set of commitments to blinded
    generators (pedersen_blind_generator_blind_sum, main_impl.h:400-466).

    Along axis 0 (n_total): 64-bit values as 32-bit halves, generator
    blinds r_i and commitment blinds r'_i, the first n_inputs of them
    inputs.  Returns (blinding32 for the last index, ok): the value that
    makes sum_outputs(v_i r_i + r'_i) - sum_inputs(v_i r_i + r'_i) = 0."""
    dev = resolve_device(device)
    r, r_ovf = S.from_bytes_be(torch.as_tensor(generator_blinds32).to(dev))
    rp, rp_ovf = S.from_bytes_be(torch.as_tensor(blinding32).to(dev))
    n_total = r.v.shape[0]
    v = pedersen_scalar_from_u32_pair(torch.as_tensor(values_hi).to(dev),
                                      torch.as_tensor(values_lo).to(dev))
    addend = S.FN.norm_weak(S.add(S.mul(v, r), rp))
    sign = torch.arange(n_total, device=dev) < n_inputs
    addend = S.select(sign, S.FN.norm_weak(S.neg(addend)), addend)
    total = S.zero((), dev)
    for i in range(n_total):
        total = S.FN.norm_weak(S.add(total, LB(addend.v[i], MASK16)))
    out = S.normalize(S.sub(LB(rp.v[n_total - 1], MASK16), total))
    return S.to_bytes_be(out), ~r_ovf.any() & ~rp_ovf.any()


def pedersen_verify_tally(pos: GEJ, neg: GEJ):
    """True iff the sum of the ``pos`` commitments equals the sum of the
    ``neg`` ones (pedersen_verify_tally, main_impl.h:364): a 0-d bool.
    Each sum is one ``gej_sum`` launch whatever the count
    (``msm._tree_reduce``)."""
    return G.gej_eq(msm._tree_reduce(pos), msm._tree_reduce(neg))
