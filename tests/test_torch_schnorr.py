"""The second slice as a whole: batched BIP-340 Schnorr verify of
``secp256k1_zkp_tpu_torch`` on CPU tensors against the BIP-340 verify
vectors, ``oracle.schnorr_verify`` and the expected mask of a mix of
lanes, and its ``lift_x`` against the JAX package's on the same arrays.

The mix is that of tests/test_pallas_tpu.py (valid / signature byte 50
bit 2 flipped / message byte flipped, by lane index) plus edge lanes: a
key x not on the curve, x >= p, r >= p, s >= n, s = 0 with otherwise
valid inputs, a signature whose R has odd y, and the BIP-340 verify and
sign vectors.  Tolerance: 0 — the result is a boolean mask and must be
equal lane for lane.  The comparison with the JAX package's own
``schnorrsig.verify`` is in the ``slow`` tier (its cold XLA:CPU compile
alone takes minutes); run it with
``pytest tests/test_torch_schnorr.py -m slow``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from secp256k1_zkp_tpu.modules import schnorrsig as jschnorr
from secp256k1_zkp_tpu_torch.modules import schnorrsig
from secp256k1_zkp_tpu_torch.ops import _build
from secp256k1_zkp_tpu_torch.utils import hostcurve as hc

from test_schnorr import BIP340_SIGN_VECTORS, BIP340_VERIFY_VECTORS

B_MIX = 12
N, P = hc.N, hc.P


def _tagged_e(r32, px32, msg):
    return int.from_bytes(oracle.tagged_hash(
        "BIP0340/challenge", r32 + px32 + msg), "big") % N


def _odd_r_signature(rng):
    """A signature that is right but for R's odd y (k left unnegated)."""
    d = int.from_bytes(rng.bytes(32), "big") % N or 1
    pt = hc.mul(d)
    if pt[1] & 1:
        d, pt = N - d, hc.mul(N - d)
    while True:
        k = int.from_bytes(rng.bytes(32), "big") % N or 1
        R = hc.mul(k)
        if R[1] & 1:
            break
    msg = rng.bytes(32)
    r32, px32 = R[0].to_bytes(32, "big"), pt[0].to_bytes(32, "big")
    s = (k + _tagged_e(r32, px32, msg) * d) % N
    return msg, r32 + s.to_bytes(32, "big"), px32


def _not_on_curve_x():
    x = 5
    while oracle.lift_x_even_y(x) is not None:
        x += 1
    return x


@pytest.fixture(scope="module")
def batch():
    """(msgs, sigs, pxs, expected mask, lane labels) as numpy / lists."""
    rng = np.random.default_rng(70)
    rows, want, label = [], [], []
    for i in range(B_MIX):
        d = int.from_bytes(rng.bytes(32), "big") % N or 1
        msg = rng.bytes(32)
        sig = bytearray(oracle.schnorr_sign(msg, d))
        px32 = hc.mul(d)[0].to_bytes(32, "big")
        good = True
        if i % 3 == 1:
            sig[50] ^= 4
            good = False
        elif i % 3 == 2:
            msg = bytes([msg[3] ^ 1]) + msg[1:]
            good = False
        rows.append((msg, bytes(sig), px32))
        want.append(good)
        label.append(("valid", "sig byte", "msg byte")[i % 3])
    # edge lanes, each from a valid lane (0, 3, 6, 9 are valid)
    msg, sig, px32 = rows[0]
    rows.append((msg, sig, _not_on_curve_x().to_bytes(32, "big")))
    label.append("px not on curve")
    x_ge_p = P + int.from_bytes(px32, "big") % (2 ** 256 - P)
    rows.append((msg, sig, x_ge_p.to_bytes(32, "big")))
    label.append("px >= p")
    msg, sig, px32 = rows[3]
    r_ge_p = (P + int.from_bytes(sig[:32], "big") % (2 ** 256 - P))
    rows.append((msg, r_ge_p.to_bytes(32, "big") + sig[32:], px32))
    label.append("r >= p")
    s_ge_n = N + int.from_bytes(sig[32:], "big") % (2 ** 256 - N)
    rows.append((msg, sig[:32] + s_ge_n.to_bytes(32, "big"), px32))
    label.append("s >= n")
    msg, sig, px32 = rows[6]
    rows.append((msg, sig[:32] + bytes(32), px32))
    label.append("s = 0")
    rows.append(_odd_r_signature(rng))
    label.append("R odd y")
    want += [False] * 6
    for pk, msg, sig, valid in BIP340_VERIFY_VECTORS:
        rows.append((bytes.fromhex(msg), bytes.fromhex(sig),
                     bytes.fromhex(pk)))
        want.append(valid)
        label.append("BIP-340 verify vector")
    for v in BIP340_SIGN_VECTORS:
        rows.append((bytes.fromhex(v[4]), bytes.fromhex(v[5]),
                     bytes.fromhex(v[2])))
        want.append(True)
        label.append("BIP-340 sign vector")

    def arr(k):
        return np.array([list(r[k]) for r in rows], np.uint8)

    return arr(0), arr(1), arr(2), np.array(want), label


def test_verify_matches_expected_mask(batch):
    msgs, sigs, pxs, want, label = batch
    for j in range(len(want)):
        assert oracle.schnorr_verify(bytes(msgs[j]), int.from_bytes(
            bytes(pxs[j]), "big"), bytes(sigs[j])) == want[j], label[j]
    before = dict(_build.LAUNCH_COUNTS)
    ok = schnorrsig.verify(torch.from_numpy(msgs), torch.from_numpy(sigs),
                           torch.from_numpy(pxs), device="cpu")
    assert _build.LAUNCH_COUNTS == before
    assert ok.dtype == torch.bool and ok.shape == (len(want),)
    wrong = [label[i] for i in np.flatnonzero(ok.numpy() != want)]
    assert not wrong, wrong


def test_challenge_and_lift_x_vs_jax_and_oracle(batch):
    msgs, sigs, pxs, _, _ = batch
    e = schnorrsig.challenge(torch.from_numpy(sigs[:, :32]),
                             torch.from_numpy(pxs), torch.from_numpy(msgs))
    for j in range(len(msgs)):
        val = sum(int(v) << (16 * i) for i, v in enumerate(e.v[j]))
        assert val == _tagged_e(bytes(sigs[j, :32]), bytes(pxs[j]),
                                bytes(msgs[j]))
    pk, ok = schnorrsig.lift_x(torch.from_numpy(pxs), device="cpu")
    jpk, jok = jschnorr.lift_x(jnp.asarray(pxs))
    assert ok.tolist() == np.asarray(jok).tolist()
    assert pk.inf.tolist() == np.asarray(jpk.inf).tolist()
    assert pk.x.v.tolist() == np.asarray(jpk.x.v).astype(np.int64).tolist()
    assert pk.y.v.tolist() == np.asarray(jpk.y.v).astype(np.int64).tolist()
    for j in range(len(pxs)):
        x = int.from_bytes(bytes(pxs[j]), "big")
        pt = oracle.lift_x_even_y(x)
        assert bool(ok[j]) == (pt is not None)
        if pt is not None:
            assert sum(int(v) << (16 * i)
                       for i, v in enumerate(pk.y.v[j])) == pt[1]


def test_verify_edge_cases_of_the_entry_point(batch):
    msgs, sigs, pxs, _, _ = batch
    empty = schnorrsig.verify(torch.zeros((0, 32), dtype=torch.uint8),
                              torch.zeros((0, 64), dtype=torch.uint8),
                              torch.zeros((0, 32), dtype=torch.uint8),
                              device="cpu")
    assert empty.shape == (0,) and empty.dtype == torch.bool
    with pytest.raises(ValueError, match="1-D batch"):
        schnorrsig.verify(torch.from_numpy(msgs[0]),
                          torch.from_numpy(sigs[0]),
                          torch.from_numpy(pxs[0]), device="cpu")


def test_default_device_is_the_card(batch):
    """The default device is the card; with none present the entry points
    raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    msgs, sigs, pxs, _, _ = batch
    args = [torch.from_numpy(a) for a in (msgs, sigs, pxs)]
    with pytest.raises(RuntimeError, match="cuda"):
        schnorrsig.verify(*args)
    with pytest.raises(RuntimeError, match="cuda"):
        schnorrsig.lift_x(args[2])


@pytest.mark.slow
def test_verify_equals_the_jax_package(batch):
    msgs, sigs, pxs, want, _ = batch
    ok = schnorrsig.verify(torch.from_numpy(msgs), torch.from_numpy(sigs),
                           torch.from_numpy(pxs), device="cpu")
    jok = jschnorr.verify(jnp.asarray(msgs), jnp.asarray(sigs),
                          jnp.asarray(pxs))
    assert ok.tolist() == np.asarray(jok).tolist() == want.tolist()
