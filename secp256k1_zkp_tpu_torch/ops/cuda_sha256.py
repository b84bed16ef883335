"""The SHA-256 kernels (``csrc/sha256.cu``): four entries on one
compression core.

There is no TPU kernel behind them: in the JAX package SHA-256 is XLA glue
(``ops/sha256.py`` ``_compress_scan``), which XLA fuses.  Eager PyTorch
would launch each of the ~3,800 elementwise operations of a compression
separately, and the padding, word assembly and HMAC chains around it, so
the port's hashes are hand-written CUDA kernels:

* :func:`sha256_blocks` — k compressions a lane, word-major: state
  ``[8, B]`` and blocks ``[16k, B]`` int32 holding the bits of the uint32
  words (``ops/sha256.compress``, the selftest's known answer);
  ``words_to_rows`` / ``rows_to_words`` convert from and to the ``[B, W]``
  int64 words of ``ops/sha256.py``.
* :func:`sha256_msg` — a whole hash of a byte message ``[B, L]`` from a
  start state (the IV, a tag's midstate, or a per-lane state) to the
  digest bytes ``[B, 32]``: padding and word assembly in the kernel.
* :func:`rfc6979` — the RFC6979 DRBG of ECDSA signing, seckey || msg32
  ``[B, 64]`` to its first candidates ``[rounds, B, 8]`` words.
* :func:`batch_digest` — the BIP-340 batch tree of n signatures to its
  ``[32]``-byte root.

Each counts its launches under its own name.  Each has a plain version
beside it with the same signature (``*_ref``): the eager chains of
``ops/sha256.py`` run on the plain compression
(``sha256.plain_route``), on any device.  CPU tensors go through the plain
versions, CUDA tensors through the kernels.  A ``set_compress`` override
is honoured by the callers in ``ops/sha256.py``, which then never reach
these entries (but ``compress``, which the override replaces).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..utils import sha256_host
from . import _build

M32 = 0xFFFFFFFF
IV = tuple(sha256_host.INIT)
BD_THREADS = 256          # leaves a block of batch_digest (csrc/sha256.cu)


def words_to_rows(words: torch.Tensor) -> torch.Tensor:
    """``[B, W]`` int64 words in [0, 2^32) -> ``[W, B]`` int32 bit
    patterns, contiguous."""
    return _bits32(words).T.contiguous()


def rows_to_words(rows: torch.Tensor) -> torch.Tensor:
    """``[W, B]`` int32 bit patterns -> ``[B, W]`` int64 words."""
    return rows.T.to(torch.int64) & M32


def _bits32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 tensors of the same bits."""
    w = words.to(torch.int64)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def _u32s(words) -> ctypes.Array:
    """Python ints -> a host array of uint32 for a C entry (copied into
    the kernel's by-value parameters)."""
    return (ctypes.c_uint32 * len(words))(*words)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernels load whole
    words (a copy only for a view that does not start on 16 bytes)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_bytes(t, cols, name: str, lanes: int | None = None) -> int:
    """A CUDA uint8 ``[B, cols]`` operand (cols None: any); returns B."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != torch.uint8 or t.dim() != 2 or (
            cols is not None and t.shape[1] != cols):
        raise ValueError(f"{name}: expected uint8 [B, {cols or 'L'}], got "
                         f"{t.dtype} {tuple(t.shape)}")
    if lanes is not None and t.shape[0] != lanes:
        raise ValueError(f"{name}: expected {lanes} rows, got {t.shape[0]}")
    return t.shape[0]


# --- sha256_blocks ----------------------------------------------------------


def sha256_blocks_ref(state: torch.Tensor, blocks: torch.Tensor):
    """Plain version of :func:`sha256_blocks` (any device)."""
    from .sha256 import compress_plain
    st = rows_to_words(state)
    bl = rows_to_words(blocks)
    for i in range(blocks.shape[0] // 16):
        st = compress_plain(st, bl[:, 16 * i:16 * (i + 1)])
    return words_to_rows(st)


def sha256_blocks(state: torch.Tensor, blocks: torch.Tensor):
    """Absorb k = ``blocks.shape[0] // 16`` blocks into each lane's state.

    state ``[8, B]``, blocks ``[16k, B]`` int32 (uint32 bit patterns,
    big-endian words as SHA-256 reads them); returns the new state
    ``[8, B]`` int32.  CUDA tensors go through the hand-written kernel
    (``csrc/sha256.cu``), all k blocks in one launch; CPU tensors through
    the plain version."""
    if not state.is_cuda:
        return sha256_blocks_ref(state, blocks)
    lanes = _build.check_rows(state, 8, "sha256 state")
    nwords = blocks.shape[0] if blocks.dim() == 2 else -1
    if nwords <= 0 or nwords % 16:
        raise ValueError("sha256 blocks: expected [16k, B] with k >= 1, "
                         f"got {tuple(blocks.shape)}")
    _build.check_rows(blocks, nwords, "sha256 blocks", lanes)
    out = torch.empty_like(state)
    lib = _build.lib()
    _build.count_launch("sha256")
    _build.check(lib.secp_sha256(
        state.data_ptr(), blocks.data_ptr(), out.data_ptr(), nwords // 16,
        lanes, _build.stream_ptr()), "sha256")
    return out


# --- sha256_msg -------------------------------------------------------------


def sha256_msg_ref(msg, start=None, consumed: int = 0, lane_state=None):
    """Plain version of :func:`sha256_msg` (any device): the eager padding
    and block chain of ``ops/sha256.py`` on the plain compression."""
    from . import sha256 as H
    with H.plain_route():
        init = lane_state if lane_state is not None else start
        return H.sha256_digest(msg, init, consumed)


def sha256_msg(msg, start=None, consumed: int = 0, lane_state=None):
    """SHA-256 of each row of ``msg`` ``[B, L]`` uint8 after a start state:
    ``start`` (8 words; None: the IV) or ``lane_state`` (``[B, 8]`` int64
    words, a state a lane: HMAC's inner and outer hashes), with
    ``consumed`` bytes (a multiple of 64) already absorbed into it.
    Returns the digests ``[B, 32]`` uint8.

    CUDA tensors go through the hand-written kernel (``csrc/sha256.cu``,
    ``sha256_msg_kernel``: one launch, the padding, the big-endian words
    and every block in the kernel, the rows staged through shared memory
    with coalesced loads); CPU tensors through the plain version."""
    if not msg.is_cuda:
        return sha256_msg_ref(msg, start, consumed, lane_state)
    lanes = _check_bytes(msg, None, "sha256_msg msg")
    if consumed % 64 or consumed < 0:
        raise ValueError("sha256_msg: the bytes already absorbed must be a "
                         f"multiple of 64, got {consumed}")
    out = torch.empty((lanes, 32), dtype=torch.uint8, device=msg.device)
    if lanes == 0:
        return out
    L = msg.shape[1]
    msg = _aligned(msg)
    lane32 = None
    if lane_state is not None:
        if lane_state.shape != (lanes, 8) or not lane_state.is_cuda:
            raise ValueError("sha256_msg lane_state: expected a CUDA "
                             f"[{lanes}, 8] tensor, got "
                             f"{tuple(lane_state.shape)}")
        lane32 = _aligned(_bits32(lane_state))
    st0 = _u32s(IV if start is None else tuple(start))
    bits = (consumed + L) * 8
    lib = _build.lib()
    _build.count_launch("sha256_msg")
    _build.check(lib.secp_sha256_msg(
        msg.data_ptr(), L, ctypes.addressof(st0),
        None if lane32 is None else lane32.data_ptr(), bits >> 32,
        bits & M32, out.data_ptr(), lanes, int(L % 4 == 0),
        _build.stream_ptr()), "sha256_msg")
    return out


# --- rfc6979 ----------------------------------------------------------------


@lru_cache(maxsize=1)
def zero_key_states() -> tuple[int, ...]:
    """The inner and outer pad states of the all-zero HMAC key (RFC6979's
    first key), 16 words: one host compression each."""
    return tuple(sha256_host.compress(list(IV), b"\x36" * 64)
                 + sha256_host.compress(list(IV), b"\x5c" * 64))


def rfc6979_ref(keydata, rounds: int = 2):
    """Plain version of :func:`rfc6979` (any device): the eager HMAC chain
    (``ops/sha256.rfc6979_chain``) on the plain compression."""
    from . import sha256 as H
    with H.plain_route():
        return H.rfc6979_chain(keydata, rounds)


def rfc6979(keydata, rounds: int = 2):
    """The first ``rounds`` candidates of the reference's RFC6979 DRBG
    (nonce_function_rfc6979, src/secp256k1.c:519-560) keyed with
    ``keydata`` ``[B, 64]`` uint8 = seckey || msg32, as ``[rounds, B, 8]``
    int64 words.

    CUDA tensors go through the hand-written kernel (``csrc/sha256.cu``,
    ``rfc6979_kernel``: the whole DRBG in one launch, 24 compressions a
    lane for two candidates, no branch on the key); CPU tensors through
    the plain version."""
    if not keydata.is_cuda:
        return rfc6979_ref(keydata, rounds)
    lanes = _check_bytes(keydata, 64, "rfc6979 keydata")
    if rounds < 1:
        raise ValueError(f"rfc6979: rounds must be >= 1, got {rounds}")
    out = torch.empty((rounds, lanes, 8), dtype=torch.int32,
                      device=keydata.device)
    if lanes == 0:
        return out.to(torch.int64)
    kd = _aligned(keydata)
    k0 = _u32s(zero_key_states())
    lib = _build.lib()
    _build.count_launch("rfc6979")
    _build.check(lib.secp_rfc6979(
        kd.data_ptr(), ctypes.addressof(k0), out.data_ptr(), rounds, lanes,
        _build.stream_ptr()), "rfc6979")
    return out.to(torch.int64) & M32


# --- batch_digest -----------------------------------------------------------


def batch_digest_ref(px32, msg32, sig64):
    """Plain version of :func:`batch_digest` (any device): the eager tree
    of ``ops/sha256.batch_digest_tree`` on the plain compression."""
    from . import sha256 as H
    with H.plain_route():
        return H.batch_digest_tree(px32, msg32, sig64)


@lru_cache(maxsize=1)
def _batch_midstates() -> tuple[int, ...]:
    return tuple(sha256_host.tagged_midstate("BIP0340/batch/leaf")
                 + sha256_host.tagged_midstate("BIP0340/batch/node"))


def batch_digest(px32, msg32, sig64):
    """The digest of a BIP-340 batch of n >= 1 signatures, ``[32]``
    uint8: tagged leaf hashes of px || msg || sig (``[n, 32]``, ``[n, 32]``,
    ``[n, 64]`` uint8), then the tree of node hashes, a zero node padding
    each odd level.

    CUDA tensors go through the hand-written kernel (``csrc/sha256.cu``,
    ``batch_digest_kernel``: one launch for any n; a block's 256 leaves
    and their subtree in shared memory, the blocks' roots reduced by the
    last block to finish); CPU tensors through the plain version."""
    if not px32.is_cuda:
        return batch_digest_ref(px32, msg32, sig64)
    n = _check_bytes(px32, 32, "batch_digest px")
    _check_bytes(msg32, 32, "batch_digest msg", n)
    _check_bytes(sig64, 64, "batch_digest sig", n)
    if n == 0:
        raise ValueError("batch_digest: expected at least one signature")
    dev = px32.device
    nb = -(-n // BD_THREADS)                # a block a chunk of 256 leaves
    # the blocks' roots, the last block's second buffer and the counter:
    # dies with this call while the kernel may still run, safe in stream
    # order
    part = torch.empty((8 * nb + 8 * (-(-nb // 2)) + 1 if nb > 1 else 1,),
                       dtype=torch.int32, device=dev)
    root = torch.empty((32,), dtype=torch.uint8, device=dev)
    px, msg, sig = (_aligned(t) for t in (px32, msg32, sig64))
    mids = _u32s(_batch_midstates())
    lib = _build.lib()
    _build.count_launch("batch_digest")
    _build.check(lib.secp_batch_digest(
        px.data_ptr(), msg.data_ptr(), sig.data_ptr(), ctypes.addressof(mids),
        part.data_ptr(), root.data_ptr(), n, _build.stream_ptr()),
        "batch_digest")
    return root
