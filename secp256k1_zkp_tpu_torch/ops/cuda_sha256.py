"""The SHA-256 compression kernel: k blocks a lane in one launch.

There is no TPU kernel behind this one: in the JAX package SHA-256 is XLA
glue (``ops/sha256.py`` ``_compress_scan``), which XLA fuses.  Eager
PyTorch would launch each of the ~3,800 elementwise operations of a
compression separately, so the port's compression is a hand-written CUDA
kernel (``csrc/sha256.cu``), the seam the JAX package's ``set_compress``
exists for.  Its plain version is ``ops/sha256.compress_plain``, block by
block.

Operands are word-major, lane innermost, like the limb rows of the other
kernels: state ``[8, B]`` and blocks ``[16k, B]`` int32 holding the bits
of the uint32 words.  ``words_to_rows`` / ``rows_to_words`` convert from
and to the ``[B, W]`` int64 words of ``ops/sha256.py``.
"""

from __future__ import annotations

import torch

from . import _build

M32 = 0xFFFFFFFF


def words_to_rows(words: torch.Tensor) -> torch.Tensor:
    """``[B, W]`` int64 words in [0, 2^32) -> ``[W, B]`` int32 bit
    patterns, contiguous."""
    w = words.to(torch.int64)
    w = torch.where(w >= 2 ** 31, w - 2 ** 32, w)
    return w.T.to(torch.int32).contiguous()


def rows_to_words(rows: torch.Tensor) -> torch.Tensor:
    """``[W, B]`` int32 bit patterns -> ``[B, W]`` int64 words."""
    return rows.T.to(torch.int64) & M32


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
