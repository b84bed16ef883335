"""SHA-256 of ``secp256k1_zkp_tpu_torch`` on the CPU: the compression (the
plain version of the port's SHA-256 kernel), padding, whole and tagged
hashes, against the JAX package's ``ops/sha256.py`` on the same numpy
inputs, against ``hashlib`` / ``oracle.tagged_hash`` and against the host
compression of both packages.

Tolerance: 0 — words and bytes are compared exactly.  The JAX functions
run as the JAX package's own tests run them (``tests/test_sha256.py``):
eagerly on jnp arrays, with the compression's rolled scan.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from secp256k1_zkp_tpu.ops import sha256 as JH
from secp256k1_zkp_tpu.utils import sha256_host as jhost
from secp256k1_zkp_tpu_torch import context
from secp256k1_zkp_tpu_torch.ops import _build
from secp256k1_zkp_tpu_torch.ops import cuda_sha256 as TC
from secp256k1_zkp_tpu_torch.ops import sha256 as TH
from secp256k1_zkp_tpu_torch.utils import sha256_host as thost

TAGS = ("BIP0340/challenge", "BIP0340/aux", "BIP0340/nonce")


def _words(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_compress_vs_jax_and_host():
    rng = np.random.default_rng(50)
    st = _words(rng, (6, 8))
    bl = _words(rng, (6, 16))
    st[0] = thost.INIT
    bl[1] = 0xFFFFFFFF                       # every word >= 2^31
    bl[2] = 0
    before = dict(_build.LAUNCH_COUNTS)
    got = TH.compress(_t(st), _t(bl))
    assert _build.LAUNCH_COUNTS == before    # CPU: no kernel launch
    assert got.dtype == torch.int64 and got.shape == (6, 8)
    want = np.asarray(JH.compress(jnp.asarray(st), jnp.asarray(bl)))
    assert got.tolist() == want.astype(np.int64).tolist()
    for j in range(6):
        host = thost.compress(st[j].tolist(), bl[j].astype(">u4").tobytes())
        assert got[j].tolist() == host


def test_kernel_plain_version_word_major():
    """``sha256_blocks_ref`` (the kernel's plain version) on the kernel's
    ``[8, B]`` / ``[16k, B]`` int32 bit patterns equals block-by-block
    ``compress`` on ``[B, W]`` words, and the row codecs round-trip."""
    rng = np.random.default_rng(51)
    st = _words(rng, (5, 8))
    bl = _words(rng, (5, 48))                # three blocks a lane
    rows_st, rows_bl = TC.words_to_rows(_t(st)), TC.words_to_rows(_t(bl))
    assert rows_st.dtype == torch.int32 and rows_st.shape == (8, 5)
    assert rows_bl.shape == (48, 5) and rows_bl.is_contiguous()
    assert TC.rows_to_words(rows_bl).tolist() == _t(bl).tolist()
    before = dict(_build.LAUNCH_COUNTS)
    got = TC.sha256_blocks(rows_st, rows_bl)
    assert _build.LAUNCH_COUNTS == before
    want = _t(st)
    for i in range(3):
        want = TH.compress(want, _t(bl[:, 16 * i:16 * (i + 1)]))
    assert TC.rows_to_words(got).tolist() == want.tolist()


def test_sha256_bytes_vs_jax_and_hashlib():
    """Every padding case: empty, one byte, up to and across the 55/56 and
    119/120 block boundaries, with and without a consumed midstate."""
    for length in (0, 1, 32, 55, 56, 63, 64, 96, 119, 120):
        rng = np.random.default_rng(52 + length)
        msg = rng.integers(0, 256, (3, length), dtype=np.uint8)
        for consumed in (0, 64):
            pad = TH._pad_bytes_to_blocks(torch.from_numpy(msg), consumed)
            jpad = JH._pad_bytes_to_blocks(jnp.asarray(msg), consumed)
            assert pad.tolist() == \
                np.asarray(jpad).astype(np.int64).tolist(), length
        got = TH.words_to_bytes32(TH.sha256_bytes(torch.from_numpy(msg)))
        assert got.dtype == torch.uint8 and got.shape == (3, 32)
        for j in range(3):
            assert bytes(got[j].numpy()) == hashlib.sha256(
                bytes(msg[j])).digest(), length


def test_sha256_words_and_padding_vs_jax():
    rng = np.random.default_rng(53)
    for nw in (8, 14, 16, 24):
        w = _words(rng, (2, nw))
        for consumed in (0, 64):
            pad = TH._pad_words(_t(w), 4 * nw, consumed)
            jpad = JH._pad_words(jnp.asarray(w), 4 * nw, consumed)
            assert pad.tolist() == np.asarray(jpad).astype(np.int64).tolist()
        got = TH.sha256_words(_t(w))
        want = JH.sha256_words(jnp.asarray(w))
        assert got.tolist() == np.asarray(want).astype(np.int64).tolist()
        for j in range(2):
            assert bytes(TH.words_to_bytes32(got[j]).numpy()) == \
                hashlib.sha256(w[j].astype(">u4").tobytes()).digest()


def test_tagged_hashes_and_midstates():
    rng = np.random.default_rng(54)
    msg = rng.integers(0, 256, (4, 96), dtype=np.uint8)
    for tag in TAGS:
        assert list(TH.tag_midstate(tag)) == jhost.tagged_midstate(tag) \
            == thost.tagged_midstate(tag)
    got = TH.tagged_hash_bytes("BIP0340/challenge", torch.from_numpy(msg))
    want = JH.tagged_hash_bytes("BIP0340/challenge", jnp.asarray(msg))
    assert got.tolist() == np.asarray(want).astype(np.int64).tolist()
    gb = TH.words_to_bytes32(got)
    for j in range(4):
        assert bytes(gb[j].numpy()) == oracle.tagged_hash(
            "BIP0340/challenge", bytes(msg[j]))
    w = TH.bytes32_to_words(torch.from_numpy(msg[:, :32]))
    jw = JH.bytes32_to_words(jnp.asarray(msg[:, :32]))
    assert w.tolist() == np.asarray(jw).astype(np.int64).tolist()
    assert TH.words_to_bytes32(w).tolist() == msg[:, :32].tolist()
    gw = TH.tagged_hash_words("BIP0340/aux", w)
    jgw = JH.tagged_hash_words("BIP0340/aux", jw)
    assert gw.tolist() == np.asarray(jgw).astype(np.int64).tolist()
    assert bytes(TH.words_to_bytes32(gw[0]).numpy()) == oracle.tagged_hash(
        "BIP0340/aux", bytes(msg[0, :32]))


def test_set_compress_routes_every_hash():
    calls = []

    def spy(state, block):
        calls.append(tuple(block.shape))
        return TH.compress_plain(state, block)

    msg = torch.zeros((2, 96), dtype=torch.uint8)
    plain = TH.tagged_hash_bytes("BIP0340/challenge", msg)
    prev = TH.set_compress(spy)
    try:
        assert prev is None
        got = TH.tagged_hash_bytes("BIP0340/challenge", msg)
    finally:
        assert TH.set_compress(prev) is spy
    assert calls == [(2, 16), (2, 16)]       # 96 bytes after the midstate
    assert torch.equal(got, plain)
    TH.tagged_hash_bytes("BIP0340/challenge", msg)
    assert len(calls) == 2                   # reset: the spy is gone

    # the fused entries (one kernel launch each on a card) run their eager
    # chains under an override, every compression through it: RFC6979
    # (ten HMACs, 42 compressions for two candidates), the batch digest
    # (3 leaves: the leaf blocks, two levels of two blocks), the digest
    # bytes and the plain versions of the kernels
    kd = torch.arange(128, dtype=torch.uint8).reshape(2, 64)
    sigs = torch.arange(192, dtype=torch.uint8).reshape(3, 64)
    keys, msgs = sigs[:, :32], sigs[:, 32:]
    want_nonce = TH.rfc6979(kd)
    want_root = TH.batch_digest(keys, msgs, sigs)
    want_digest = TH.tagged_digest("BIP0340/challenge", msg)
    calls.clear()
    prev = TH.set_compress(spy)
    try:
        assert torch.equal(TH.rfc6979(kd), want_nonce)
        assert len(calls) == 42 and set(calls) == {(2, 16)}
        calls.clear()
        assert torch.equal(TC.rfc6979_ref(kd), want_nonce)
        assert len(calls) == 42
        calls.clear()
        assert torch.equal(TH.batch_digest(keys, msgs, sigs), want_root)
        assert calls == [(3, 16)] * 3 + [(2, 16)] * 2 + [(1, 16)] * 2
        calls.clear()
        assert torch.equal(TC.batch_digest_ref(keys, msgs, sigs), want_root)
        assert len(calls) == 7
        calls.clear()
        assert torch.equal(TH.tagged_digest("BIP0340/challenge", msg),
                           want_digest)
        assert torch.equal(TC.sha256_msg_ref(
            msg, TH.tag_midstate("BIP0340/challenge"), 64), want_digest)
        assert len(calls) == 4
        with TH.plain_route():               # the override still wins
            TH.sha256_bytes(msg)
        assert len(calls) == 6
    finally:
        assert TH.set_compress(prev) is spy
    assert torch.equal(TH.words_to_bytes32(plain), want_digest)
    assert not TH.on_kernels(msg)            # a CPU tensor: never

    # through a Context, as tests/test_context.py does for the JAX
    # package: the spy is installed after its known-answer test ...
    calls.clear()
    ctx = context.Context("cpu", hash_compress=spy)
    try:
        assert calls, "the KAT did not route through the override"
        n0 = len(calls)
        assert torch.equal(TH.tagged_hash_bytes("BIP0340/challenge", msg),
                           plain)
        assert len(calls) == n0 + 2
    finally:
        ctx.set_hash_compress(None)
    assert TH._COMPRESS_OVERRIDE is None

    # ... and a broken compression raises and leaves the previous route
    def broken(state, block):
        return TH.compress_plain(state, block) ^ 1

    with pytest.raises(RuntimeError, match="KAT"):
        ctx.set_hash_compress(broken)
    assert TH._COMPRESS_OVERRIDE is None
    ctx.set_hash_compress(spy)
    try:
        with pytest.raises(RuntimeError, match="KAT"):
            ctx.set_hash_compress(broken)
        assert TH._COMPRESS_OVERRIDE is spy
    finally:
        ctx.set_hash_compress(None)
    with pytest.raises(RuntimeError):
        context.Context("cpu", hash_compress=broken)
    assert TH._COMPRESS_OVERRIDE is None


def test_selftest_runs_the_sha256_kat():
    """``context.selftest`` holds the compression to the JAX package's
    known answer: it passes, and a broken compression makes it raise."""
    context.selftest("cpu")
    prev = TH.set_compress(lambda state, block: state)
    try:
        with pytest.raises(RuntimeError, match="SHA256 selftest"):
            context.selftest("cpu")
    finally:
        TH.set_compress(prev)
