"""Batched SHA-256 and BIP-340 tagged hashes on PyTorch tensors.

Counterpart of the JAX package's ``ops/sha256.py``: ``compress``,
padding, ``sha256_words``, ``sha256_bytes``, ``tagged_hash_words``,
``tagged_hash_bytes``, ``hmac_sha256``, ``hmac_sha256_bytes``, the
``RFC6979`` HMAC-DRBG, the word / byte codecs and the ``set_compress``
hook.  ``Sha256Stream`` waits for a slice that keeps a running
transcript.

Data layout as in the JAX package: 32-bit big-endian words, batch first,
``[..., W]``.  Words are held in ``int64`` and masked with ``0xFFFFFFFF``
after every add and inside every rotate (the uint32 wrap-around of the
reference).  All message lengths are static, so every hash is a fixed
number of compressions.

Route: on CUDA tensors every hash is one launch of a hand-written
SHA-256 kernel (``ops/cuda_sha256.py``): a byte or word message through
``sha256_msg`` (padding and word assembly in the kernel, digest bytes
out), the RFC6979 DRBG through ``rfc6979`` and the BIP-340 batch tree
through ``batch_digest``, each whole; a bare :func:`compress` through
``sha256_blocks``.  On CPU tensors the eager chains below run block by
block on :func:`compress_plain`, and they are the kernels' plain versions
(:func:`plain_route` runs them on CUDA tensors too).  A ``set_compress``
override wins over every route: with one installed, every hash of every
entry runs the eager chains, one compression through the override at a
time.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from functools import lru_cache

import torch

from ..utils import sha256_host
from . import cuda_sha256

M32 = 0xFFFFFFFF
I64 = torch.int64
_K = tuple(sha256_host.K)
_INIT = tuple(sha256_host.INIT)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & M32


def compress_plain(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One SHA-256 compression in plain PyTorch: state ``[..., 8]``, block
    ``[..., 16]`` int64 words in [0, 2^32) -> ``[..., 8]``
    (cf. sha256_transform, src/hash_impl.h:51-138)."""
    w = list(block.unbind(-1))
    for t in range(16, 64):
        x, y = w[t - 15], w[t - 2]
        s0 = _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)
        s1 = _rotr(y, 17) ^ _rotr(y, 19) ^ (y >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = state.unbind(-1)
    for t in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + S1 + ch + _K[t] + w[t]) & M32
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (S0 + maj) & M32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & M32, c, b, a, \
            (t1 + t2) & M32
    return (state + torch.stack([a, b, c, d, e, f, g, h], -1)) & M32


_COMPRESS_OVERRIDE = None


def set_compress(fn):
    """Install a custom compression function (or None to reset); returns
    the previous one.

    The counterpart of the reference's per-context pluggable SHA256
    compression (include/secp256k1.h:420-446): every hash here routes
    through :func:`compress`, so an override redirects all of them.
    ``fn(state, block)`` takes int64 words ``[..., 8]``, ``[..., 16]``
    and returns ``[..., 8]``.  Process-global, like the JAX package's."""
    global _COMPRESS_OVERRIDE
    prev = _COMPRESS_OVERRIDE
    _COMPRESS_OVERRIDE = fn
    return prev


_ROUTE = threading.local()


@contextmanager
def plain_route():
    """Run every hash in the body through the eager chains on the plain
    compression (or an installed override), whatever the device: what the
    kernels' plain versions run on the card."""
    prev = getattr(_ROUTE, "plain", False)
    _ROUTE.plain = True
    try:
        yield
    finally:
        _ROUTE.plain = prev


def on_kernels(t: torch.Tensor) -> bool:
    """Whether a hash of ``t`` goes through the fused kernels: a CUDA
    tensor, no :func:`set_compress` override, outside :func:`plain_route`."""
    return (t.is_cuda and _COMPRESS_OVERRIDE is None
            and not getattr(_ROUTE, "plain", False))


def _blocks_on_card(state: torch.Tensor, words: torch.Tensor):
    """All ``words.shape[-1] // 16`` blocks in one kernel launch."""
    batch = state.shape[:-1]
    st = cuda_sha256.words_to_rows(state.reshape(-1, 8))
    bl = cuda_sha256.words_to_rows(words.reshape(-1, words.shape[-1]))
    out = cuda_sha256.sha256_blocks(st, bl)
    return cuda_sha256.rows_to_words(out).reshape(*batch, 8)


def compress(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One SHA-256 compression: state ``[..., 8]``, block ``[..., 16]``
    int64 words -> ``[..., 8]``.  A :func:`set_compress` override wins;
    otherwise CUDA tensors go through the kernel, CPU tensors through
    :func:`compress_plain`."""
    if _COMPRESS_OVERRIDE is not None:
        return _COMPRESS_OVERRIDE(state, block)
    if on_kernels(state):
        return _blocks_on_card(state, block)
    return compress_plain(state, block)


def _compress_blocks(state: torch.Tensor, words: torch.Tensor):
    """Absorb the padded block words ``[..., 16k]`` into ``state`` block by
    block (the eager chains: the override, or the plain compression)."""
    for i in range(words.shape[-1] // 16):
        state = compress(state, words[..., 16 * i:16 * (i + 1)])
    return state


def _start(init_state, batch, device):
    src = _INIT if init_state is None else init_state
    st = torch.as_tensor(src, dtype=I64, device=device)
    return st.expand(*batch, 8).contiguous()


def _pad_words(words: torch.Tensor, msg_bytes: int,
               consumed_bytes: int = 0) -> torch.Tensor:
    """SHA-256 padding of a whole-word message of static length:
    ``[..., W]`` (W * 4 == msg_bytes) -> ``[..., 16k]`` block words.
    ``consumed_bytes``: bytes already absorbed (64 for a midstate)."""
    W = words.shape[-1]
    assert W * 4 == msg_bytes
    bitlen = (msg_bytes + consumed_bytes) * 8
    npad = (-(W + 1 + 2)) % 16 + 1 + 2
    pad = torch.zeros((*words.shape[:-1], npad), dtype=I64,
                      device=words.device)
    pad[..., 0] = 0x80000000
    pad[..., -2] = (bitlen >> 32) & M32
    pad[..., -1] = bitlen & M32
    return torch.cat([words.to(I64), pad], -1)


def _pad_bytes_to_blocks(msg: torch.Tensor,
                         consumed_bytes: int = 0) -> torch.Tensor:
    """``[..., L]`` uint8 (static L) -> padded big-endian block words
    ``[..., 16k]`` int64: message || 0x80 || zeros || 8-byte bit length."""
    L = msg.shape[-1]
    batch = msg.shape[:-1]
    bitlen = (L + consumed_bytes) * 8
    zpad = (64 - (L + 1 + 8) % 64) % 64
    tail = [0x80] + [0] * (zpad + 8)
    tail[-8:] = list(bitlen.to_bytes(8, "big"))
    tail_t = torch.tensor(tail, dtype=I64, device=msg.device)
    full = torch.cat([msg.to(I64), tail_t.expand(*batch, len(tail))], -1)
    assert full.shape[-1] % 64 == 0
    b4 = full.reshape(*batch, -1, 4)
    return (b4[..., 0] << 24) | (b4[..., 1] << 16) | (b4[..., 2] << 8) \
        | b4[..., 3]


def _digest_on_card(msg: torch.Tensor, init_state, consumed_bytes: int):
    """One ``sha256_msg`` launch for ``[..., L]`` bytes -> ``[..., 32]``
    digest bytes; ``init_state`` a tuple (a midstate, or None: the IV) or
    a per-lane ``[..., 8]`` state."""
    batch, L = msg.shape[:-1], msg.shape[-1]
    flat = msg.reshape(-1, L)
    if isinstance(init_state, torch.Tensor):
        out = cuda_sha256.sha256_msg(flat, None, consumed_bytes,
                                     init_state.reshape(-1, 8))
    else:
        out = cuda_sha256.sha256_msg(flat, init_state, consumed_bytes)
    return out.reshape(*batch, 32)


def sha256_words(words: torch.Tensor, init_state=None,
                 consumed_bytes: int = 0) -> torch.Tensor:
    """SHA-256 of a whole-word message ``[..., W]`` -> digest words
    ``[..., 8]``; ``init_state`` / ``consumed_bytes`` continue a
    midstate."""
    if on_kernels(words):
        return bytes32_to_words(_digest_on_card(
            words_to_bytes(words), init_state, consumed_bytes))
    msg = _pad_words(words, words.shape[-1] * 4, consumed_bytes)
    state = _start(init_state, words.shape[:-1], words.device)
    return _compress_blocks(state, msg)


def sha256_bytes(msg: torch.Tensor, init_state=None,
                 consumed_bytes: int = 0) -> torch.Tensor:
    """SHA-256 over a byte tensor ``[..., L]`` (static L) -> ``[..., 8]``
    digest words."""
    if on_kernels(msg):
        return bytes32_to_words(_digest_on_card(msg, init_state,
                                                consumed_bytes))
    words = _pad_bytes_to_blocks(msg, consumed_bytes)
    state = _start(init_state, msg.shape[:-1], msg.device)
    return _compress_blocks(state, words)


def sha256_digest(msg: torch.Tensor, init_state=None,
                  consumed_bytes: int = 0) -> torch.Tensor:
    """:func:`sha256_bytes` as digest bytes ``[..., 32]`` uint8: on the
    card the kernel's own output, no conversion."""
    if on_kernels(msg):
        return _digest_on_card(msg, init_state, consumed_bytes)
    return words_to_bytes32(sha256_bytes(msg, init_state, consumed_bytes))


@lru_cache(maxsize=32)
def tag_midstate(tag: str) -> tuple[int, ...]:
    """State after SHA256(tag) || SHA256(tag), computed on the host
    (cf. hash_impl.h:196)."""
    return tuple(sha256_host.tagged_midstate(tag))


def tagged_hash_words(tag: str, words: torch.Tensor) -> torch.Tensor:
    """SHA256(SHA256(tag) || SHA256(tag) || msg) of a whole-word message."""
    return sha256_words(words, init_state=tag_midstate(tag),
                        consumed_bytes=64)


def tagged_hash_bytes(tag: str, msg: torch.Tensor) -> torch.Tensor:
    """Tagged hash of a byte message ``[..., L]`` -> ``[..., 8]`` words."""
    return sha256_bytes(msg, init_state=tag_midstate(tag), consumed_bytes=64)


def tagged_digest(tag: str, msg: torch.Tensor) -> torch.Tensor:
    """Tagged hash of a byte message ``[..., L]`` -> ``[..., 32]`` bytes."""
    return sha256_digest(msg, init_state=tag_midstate(tag),
                         consumed_bytes=64)


def _hmac_states(key8: torch.Tensor):
    """The inner and outer HMAC states of a 32-byte key ``[..., 8]``:
    one compression each of the key block XOR ipad / opad."""
    kblock = torch.cat([key8.to(I64), torch.zeros_like(key8, dtype=I64)],
                       -1)
    init = _start(None, key8.shape[:-1], key8.device)
    return (compress(init, kblock ^ 0x36363636),
            compress(init, kblock ^ 0x5C5C5C5C))


def hmac_sha256(key8: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
    """HMAC-SHA256 with a 32-byte key (``[..., 8]`` words) over a
    whole-word message ``[..., W]`` -> ``[..., 8]`` (cf. hmac_sha256,
    src/hash_impl.h:216).  On the card: four kernel launches (the key's
    two pad states, the inner and the outer hash)."""
    inner, outer = _hmac_states(key8)
    ihash = sha256_words(msgs, init_state=inner, consumed_bytes=64)
    return sha256_words(ihash, init_state=outer, consumed_bytes=64)


def hmac_sha256_bytes(key8: torch.Tensor, msg: torch.Tensor):
    """HMAC-SHA256, 32-byte key, byte message ``[..., L]`` (static L)."""
    inner, outer = _hmac_states(key8)
    ihash = sha256_bytes(msg, init_state=inner, consumed_bytes=64)
    return sha256_words(ihash, init_state=outer, consumed_bytes=64)


class RFC6979:
    """Batched RFC6979 HMAC-SHA256 DRBG (cf. rfc6979_hmac_sha256_*,
    src/hash_impl.h:255-318).  Key material: ``keydata_words`` ``[..., W]``
    words — seckey32 || msg32 for the reference's default nonce function
    (src/secp256k1.c:519-560).  Construction runs four HMACs, each
    :meth:`generate32` three."""

    def __init__(self, keydata_words: torch.Tensor):
        kb = words_to_bytes(keydata_words.to(I64))
        batch = kb.shape[:-1]
        v = torch.full((*batch, 8), 0x01010101, dtype=I64, device=kb.device)
        k = torch.zeros_like(v)
        k = self._hmac_vbyte(k, v, kb, 0x00)
        v = hmac_sha256(k, v)
        k = self._hmac_vbyte(k, v, kb, 0x01)
        v = hmac_sha256(k, v)
        self.k, self.v = k, v

    @staticmethod
    def _hmac_vbyte(k, v, keydata_bytes, sep_byte: int):
        """HMAC(k, v || sep_byte || keydata): a byte message, which the
        one-byte separator leaves unaligned to words."""
        sep = torch.full((*v.shape[:-1], 1), sep_byte, dtype=torch.uint8,
                         device=v.device)
        msg = torch.cat([words_to_bytes32(v), sep, keydata_bytes], -1)
        return hmac_sha256_bytes(k, msg)

    def generate32(self) -> torch.Tensor:
        """One 32-byte candidate as ``[..., 8]`` words; then the state
        steps on for the next (rfc6979_hmac_sha256_generate,
        src/hash_impl.h:295): k = HMAC(k, v || 0x00), v = HMAC(k, v)."""
        self.v = hmac_sha256(self.k, self.v)
        out = self.v
        zero = torch.zeros((*out.shape[:-1], 1), dtype=torch.uint8,
                           device=out.device)
        self.k = hmac_sha256_bytes(
            self.k, torch.cat([words_to_bytes32(self.v), zero], -1))
        self.v = hmac_sha256(self.k, self.v)
        return out


def rfc6979_chain(keydata: torch.Tensor, rounds: int = 2) -> torch.Tensor:
    """The first ``rounds`` candidates of the RFC6979 DRBG keyed with
    ``keydata`` ``[B, 64]`` uint8 (seckey || msg32), as ``[rounds, B, 8]``
    words: the eager HMAC chain, ten HMACs for two candidates (the plain
    version of the ``rfc6979`` kernel)."""
    drbg = RFC6979(bytes_to_words(keydata))
    return torch.stack([drbg.generate32() for _ in range(rounds)], 0)


def rfc6979(keydata: torch.Tensor, rounds: int = 2) -> torch.Tensor:
    """:func:`rfc6979_chain`, on the card in one launch of the ``rfc6979``
    kernel (every HMAC state in registers, no eager op)."""
    if on_kernels(keydata):
        return cuda_sha256.rfc6979(keydata, rounds)
    return rfc6979_chain(keydata, rounds)


BATCH_LEAF_TAG = "BIP0340/batch/leaf"
BATCH_NODE_TAG = "BIP0340/batch/node"


def batch_digest_tree(px32, msg32, sig64) -> torch.Tensor:
    """The digest binding a BIP-340 batch, ``[32]`` uint8: tagged leaf
    hashes of px || msg || sig (``[n, 32]``, ``[n, 32]``, ``[n, 64]``),
    then a binary tree of node hashes, a zero node padding each odd level
    (the plain version of the ``batch_digest`` kernel)."""
    nodes = tagged_digest(BATCH_LEAF_TAG, torch.cat([px32, msg32, sig64],
                                                    -1))
    k = nodes.shape[0]
    while k > 1:
        if k % 2:
            nodes = torch.cat([nodes, nodes.new_zeros((1, 32))], 0)
            k += 1
        nodes = tagged_digest(BATCH_NODE_TAG, nodes.reshape(k // 2, 64))
        k //= 2
    return nodes[0]


def batch_digest(px32, msg32, sig64) -> torch.Tensor:
    """:func:`batch_digest_tree`, on the card in one launch of the
    ``batch_digest`` kernel (leaves, every level and the padding)."""
    if on_kernels(px32):
        return cuda_sha256.batch_digest(px32, msg32, sig64)
    return batch_digest_tree(px32, msg32, sig64)


def bytes_to_words(b: torch.Tensor) -> torch.Tensor:
    """``[..., 4W]`` uint8 -> ``[..., W]`` big-endian int64 words."""
    b4 = b.to(I64).reshape(*b.shape[:-1], -1, 4)
    return (b4[..., 0] << 24) | (b4[..., 1] << 16) | (b4[..., 2] << 8) \
        | b4[..., 3]


def words_to_bytes(w: torch.Tensor) -> torch.Tensor:
    """``[..., W]`` words -> ``[..., 4W]`` uint8."""
    out = torch.stack([(w >> 24) & 0xFF, (w >> 16) & 0xFF,
                       (w >> 8) & 0xFF, w & 0xFF], -1)
    return out.reshape(*w.shape[:-1], 4 * w.shape[-1]).to(torch.uint8)


def bytes32_to_words(b: torch.Tensor) -> torch.Tensor:
    """``[..., 32]`` uint8 -> ``[..., 8]`` big-endian int64 words."""
    return bytes_to_words(b)


def words_to_bytes32(w: torch.Tensor) -> torch.Tensor:
    """``[..., 8]`` words -> ``[..., 32]`` uint8."""
    return words_to_bytes(w)
