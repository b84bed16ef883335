"""The third slice as a whole: batched ECDSA and BIP-340 signing of
``secp256k1_zkp_tpu_torch`` on CPU tensors.

Each test walks one signing entry point through what a caller relies on:

* the signature bytes (and ECDSA's recovery id) equal those of
  ``oracle.ecdsa_sign`` / ``oracle.schnorr_sign`` — RFC6979 and the
  BIP-340 nonce function byte for byte, since a nonce fault would still
  give signatures that verify — and, for BIP-340, the four sign vectors;
* secret keys 0, n and above n give ok false and a zeroed signature;
* signing with the blinding of the JAX package's ``Context.randomize``,
  carried across by ``convert.blind_from_jax``, and with the port's own
  ``Context(...).randomize`` changes no byte;
* the port's own ``verify`` accepts every signature it made;
* asking for the default device, the card, raises where there is none;
* a spy on ``cuda_gen`` (:func:`comb_entries`) shows which of the comb's
  entries each path reaches: every secret scalar (signing's nonce and key,
  here; Pedersen's and the generator's blinds in test_torch_pedersen.py)
  the full scan, never the public gather, and the verifiers (verify here,
  recover in test_torch_recovery.py, batch verify in test_torch_batch.py)
  the gather alone.

Tolerance: 0 — bytes, ids and masks are compared exactly.  The comparison
with the JAX package's own ``ecdsa.sign`` / ``schnorrsig.sign`` is in the
``slow`` tier (their cold XLA:CPU compiles take minutes); run it with
``pytest tests/test_torch_sign.py -m slow``.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from secp256k1_zkp_tpu import context as jcontext
from secp256k1_zkp_tpu.modules import ecdsa as jecdsa
from secp256k1_zkp_tpu.modules import schnorrsig as jschnorr
from secp256k1_zkp_tpu_torch import context
from secp256k1_zkp_tpu_torch.modules import ecdsa, schnorrsig
from secp256k1_zkp_tpu_torch.ops import _build
from secp256k1_zkp_tpu_torch.ops import cuda_gen
from secp256k1_zkp_tpu_torch.ops.group import GE
from secp256k1_zkp_tpu_torch.utils import convert
from secp256k1_zkp_tpu_torch.utils import hostcurve as hc

from test_schnorr import BIP340_SIGN_VECTORS

N = hc.N
B_GOOD = 5
BAD_KEYS = (0, N, N + 5)       # lanes B_GOOD.. : ok false, zero signature


def _jax_blind(seed):
    """The JAX package's ``Context.blind`` for ``seed`` (its randomize,
    run on a bare object so no generator table is built)."""
    return jcontext.Context.randomize(types.SimpleNamespace(), seed).blind


def _keys_and_msgs(seed):
    rng = np.random.default_rng(seed)
    secs = [int.from_bytes(rng.bytes(32), "big") % N or 1
            for _ in range(B_GOOD)] + list(BAD_KEYS)
    msgs = [rng.bytes(32) for _ in secs]
    auxs = [rng.bytes(32) for _ in secs]
    return secs, msgs, auxs


def _u8(rows):
    return torch.tensor([list(r) for r in rows], dtype=torch.uint8)


def _sec_bytes(secs):
    return _u8([d.to_bytes(32, "big") for d in secs])


def comb_entries(fn):
    """Run ``fn()`` with the comb's two wrappers in ``cuda_gen`` spied on
    (the real ones still run): returns (its result, the set of entries it
    reached — "secret" for ``fixedbase_digits``, the full scan, which
    ``ecmult_gen`` takes too; "public" for ``fixedbase_public``)."""
    seen = set()
    real = {name: getattr(cuda_gen, name)
            for name in ("fixedbase_digits", "fixedbase_public")}

    def spy(name, tag):
        def call(*args, **kw):
            seen.add(tag)
            return real[name](*args, **kw)
        return call

    cuda_gen.fixedbase_digits = spy("fixedbase_digits", "secret")
    cuda_gen.fixedbase_public = spy("fixedbase_public", "public")
    try:
        out = fn()
    finally:
        for name, f in real.items():
            setattr(cuda_gen, name, f)
    return out, seen


def _refuses_the_default_device(fn):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            fn()


def test_ecdsa_sign():
    secs, msgs, _ = _keys_and_msgs(80)
    sec_t, msg_t = _sec_bytes(secs), _u8(msgs)
    before = dict(_build.LAUNCH_COUNTS)
    (sig, recid, ok), comb = comb_entries(
        lambda: ecdsa.sign(msg_t, sec_t, device="cpu"))
    assert _build.LAUNCH_COUNTS == before
    assert comb == {"secret"}                  # k: the full scan
    assert sig.dtype == torch.uint8 and sig.shape == (len(secs), 64)
    assert recid.dtype == torch.int32 and ok.dtype == torch.bool
    assert ok.tolist() == [True] * B_GOOD + [False] * len(BAD_KEYS)
    assert not sig[B_GOOD:].any()
    pubs = []
    for j in range(B_GOOD):
        r, s, rid = oracle.ecdsa_sign(msgs[j], secs[j])
        assert bytes(sig[j].tolist()) == \
            r.to_bytes(32, "big") + s.to_bytes(32, "big"), j
        assert recid[j] == rid
        assert oracle.ecdsa_recover(msgs[j], r, s, rid) == hc.mul(secs[j])
        pubs.append(hc.mul(secs[j]))
    # the nonces themselves, against the reference's nonce function
    k, k_ok = ecdsa._pick_nonce(ecdsa.rfc6979_nonce(msg_t, sec_t))
    assert k_ok.all()
    for j, d in enumerate(secs):
        want = int.from_bytes(oracle.rfc6979_nonce(
            d.to_bytes(32, "big"), msgs[j]), "big")
        assert sum(int(v) << (16 * i) for i, v in enumerate(k.v[j])) == want
    # blinding changes no byte: the JAX package's blind, and the port's
    for blind in (convert.blind_from_jax(_jax_blind(b"\x07" * 32)),
                  context.Context("cpu").randomize(b"\x08" * 32).blind):
        (bsig, brecid, bok), comb = comb_entries(lambda: ecdsa.sign(
            msg_t, sec_t, blind=blind, device="cpu"))
        assert comb == {"secret"}
        assert torch.equal(bsig, sig) and torch.equal(brecid, recid)
        assert torch.equal(bok, ok)
    # the port's verify accepts what it signed
    pub = GE(*(convert.lb_from_numpy(np.array(
        [[(c >> (16 * i)) & 0xFFFF for i in range(16)] for c in col]))
        for col in zip(*pubs)), torch.zeros(B_GOOD, dtype=torch.bool))
    vok, comb = comb_entries(lambda: ecdsa.verify(
        msg_t[:B_GOOD], sig[:B_GOOD], pub, device="cpu"))
    assert vok.all() and comb == {"public"}    # u1: the gather
    # the entry point's edges: an empty batch, a lone message, the card
    esig, erecid, eok = ecdsa.sign(msg_t[:0], sec_t[:0], device="cpu")
    assert esig.shape == (0, 64) and erecid.shape == eok.shape == (0,)
    with pytest.raises(ValueError, match="1-D batch"):
        ecdsa.sign(msg_t[0], sec_t[0], device="cpu")
    _refuses_the_default_device(lambda: ecdsa.sign(msg_t, sec_t))
    # recovering the signers' keys, and the scalar inverse it takes:
    # tests/test_torch_recovery.py
    from test_torch_recovery import check_recover_and_the_scalar_inverse
    check_recover_and_the_scalar_inverse()


def test_schnorr_sign():
    secs, msgs, auxs = _keys_and_msgs(81)
    for _, sk, _, aux, msg, _ in BIP340_SIGN_VECTORS:
        secs.append(int(sk, 16))
        auxs.append(bytes.fromhex(aux))
        msgs.append(bytes.fromhex(msg))
    sec_t, msg_t, aux_t = _sec_bytes(secs), _u8(msgs), _u8(auxs)
    nbad = len(BAD_KEYS)
    good = [j for j in range(len(secs)) if not B_GOOD <= j < B_GOOD + nbad]
    before = dict(_build.LAUNCH_COUNTS)
    (sig, ok), comb = comb_entries(
        lambda: schnorrsig.sign(msg_t, sec_t, aux_t, device="cpu"))
    assert _build.LAUNCH_COUNTS == before
    assert comb == {"secret"}                  # d and k: the full scan
    assert sig.dtype == torch.uint8 and sig.shape == (len(secs), 64)
    assert ok.tolist() == [j in good for j in range(len(secs))]
    assert not sig[B_GOOD:B_GOOD + nbad].any()
    for j in good:
        assert bytes(sig[j].tolist()) == oracle.schnorr_sign(
            msgs[j], secs[j], auxs[j]), j
    for i, v in enumerate(BIP340_SIGN_VECTORS):
        assert bytes(sig[B_GOOD + nbad + i].tolist()).hex().upper() == v[5]
    # the keypair: x-only key, parity and the even-y secret
    (d_even, px32, parity, kok), comb = comb_entries(
        lambda: schnorrsig.keypair_xonly(sec_t, device="cpu"))
    assert comb == {"secret"}
    assert torch.equal(kok, ok)
    for j in good:
        pt = hc.mul(secs[j])
        assert bytes(px32[j].tolist()) == pt[0].to_bytes(32, "big")
        assert bool(parity[j]) == bool(pt[1] & 1)
        dv = sum(int(v) << (16 * i) for i, v in enumerate(d_even.v[j]))
        assert dv == (N - secs[j] if pt[1] & 1 else secs[j])
    # no aux means 32 zero bytes
    zsig, _ = schnorrsig.sign(msg_t[:1], sec_t[:1], device="cpu")
    assert bytes(zsig[0].tolist()) == oracle.schnorr_sign(msgs[0], secs[0])
    # blinding changes no byte: the JAX package's blind, and the port's
    for blind in (convert.blind_from_jax(_jax_blind(b"\x09" * 32)),
                  context.Context("cpu").randomize(b"\x0a" * 32).blind):
        (bsig, bok), comb = comb_entries(lambda: schnorrsig.sign(
            msg_t, sec_t, aux_t, blind=blind, device="cpu"))
        assert comb == {"secret"}
        assert torch.equal(bsig, sig) and torch.equal(bok, ok)
    # the port's verify accepts what it signed
    vok, comb = comb_entries(lambda: schnorrsig.verify(
        msg_t[good], sig[good], px32[good], device="cpu"))
    assert vok.all() and comb == {"public"}    # s: the gather
    esig, eok = schnorrsig.sign(msg_t[:0], sec_t[:0], device="cpu")
    assert esig.shape == (0, 64) and eok.shape == (0,)
    _refuses_the_default_device(lambda: schnorrsig.sign(msg_t, sec_t))
    _refuses_the_default_device(lambda: context.Context())


@pytest.mark.slow
def test_sign_equals_the_jax_package():
    secs, msgs, auxs = _keys_and_msgs(82)
    sec_t, msg_t, aux_t = _sec_bytes(secs), _u8(msgs), _u8(auxs)
    sig, recid, ok = ecdsa.sign(msg_t, sec_t, device="cpu")
    jsig, jrecid, jok = jecdsa.sign(jnp.asarray(msg_t.numpy()),
                                    jnp.asarray(sec_t.numpy()))
    assert ok.tolist() == np.asarray(jok).tolist()
    assert sig.tolist() == np.asarray(jsig).astype(np.int64).tolist()
    okl = ok.numpy()
    assert recid.numpy()[okl].tolist() == np.asarray(jrecid)[okl].tolist()
    ssig, sok = schnorrsig.sign(msg_t, sec_t, aux_t, device="cpu")
    jssig, jsok = jschnorr.sign(jnp.asarray(msg_t.numpy()),
                                jnp.asarray(sec_t.numpy()),
                                jnp.asarray(aux_t.numpy()))
    assert sok.tolist() == np.asarray(jsok).tolist()
    assert ssig.tolist() == np.asarray(jssig).astype(np.int64).tolist()
