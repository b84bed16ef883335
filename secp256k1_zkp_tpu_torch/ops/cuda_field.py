"""GF(p) limb arithmetic of the kernel library: plain PyTorch versions and
the ``mulmod_chain`` kernel.

Counterpart of the JAX package's ``ops/pallas_field.py`` (``_mul_limbs``,
``_sqr_limbs``, ``_reduce_cols``, ``_canon_p``, ``mulmod_chain``).  A
256-bit element is **limb-major**: ``[16, B]`` base-2^16 limbs with the
batch innermost, the layout of every kernel operand.  Kernel operands and
results are ``int32`` (the bits of the reference's ``uint32``); the plain
versions compute in ``int64``.

The plain versions are value-exact, not carry-save-exact: with 64-bit
integers a column sum needs no lo/hi split, so a *weak* result (limbs
<= 0xFFFF, value < 2^256) may be the other representative of its residue
class than the JAX helper returns.  Everything that leaves a kernel
wrapper is therefore canonical (``canon_p``), and comparisons with the JAX
helpers canonicalise both sides.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from . import _build

LIMBS = 16
MASK16 = 0xFFFF
P_PRIME = 2 ** 256 - 2 ** 32 - 977
_RED_LO = 977               # 2^256 === 2^32 + 977 (mod p)
I64 = torch.int64


def limbs16(x: int, k: int = LIMBS) -> tuple[int, ...]:
    return tuple((x >> (16 * i)) & MASK16 for i in range(k))


def const_rows(x: int, like: torch.Tensor, k: int = LIMBS) -> torch.Tensor:
    """Python int -> ``[k, 1]`` int64 limb column on ``like``'s device."""
    return torch.tensor(limbs16(x, k), dtype=I64,
                        device=like.device)[:, None]


@lru_cache(maxsize=16)
def _col_index(n: int, m: int, device: str) -> torch.Tensor:
    return torch.tensor([i + j for i in range(n) for j in range(m)],
                        dtype=I64, device=device)


def mul_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact schoolbook product ``[n, B] x [m, B] -> [n+m-1, B]`` column
    sums (limbs <= 0xFFFF in; columns < min(n, m) * 2^32 out)."""
    n, m = a.shape[0], b.shape[0]
    lanes = max(a.shape[1], b.shape[1])
    prod = (a[:, None, :] * b[None, :, :]).reshape(n * m, -1)
    prod = prod.expand(n * m, lanes)
    cols = torch.zeros((n + m - 1, lanes), dtype=I64, device=a.device)
    return cols.index_add_(0, _col_index(n, m, str(a.device)), prod)


def ripple(x: torch.Tensor):
    """Exact carry ripple over the rows of ``[K, B]`` non-negative columns.
    Returns (``[K, B]`` limbs <= 0xFFFF, carry_out ``[B]``)."""
    out = []
    carry = None
    for row in x.unbind(0):
        t = row if carry is None else row + carry
        out.append(t & MASK16)
        carry = t >> 16
    return torch.stack(out, 0), carry


def weak_p(x: torch.Tensor) -> torch.Tensor:
    """``[16, B]`` non-negative limbs (each < 2^47) -> weak form mod p:
    limbs <= 0xFFFF, value < 2^256, same residue."""
    out, carry = ripple(x)
    # carry * 2^256 === carry * (2^32 + 977)
    fold = torch.zeros_like(out)
    fold[0] = carry * _RED_LO
    fold[2] = carry
    out, carry = ripple(out + fold)
    # second carry-out is 0/1; if 1 the rest is tiny, so one more fold and
    # a short ripple finish exactly
    fold = torch.zeros_like(out)
    fold[0] = carry * _RED_LO
    fold[2] = carry
    out, _ = ripple(out + fold)
    return out


def reduce_cols(cols: torch.Tensor) -> torch.Tensor:
    """Fold 31 or 32 product columns mod p and carry-normalise to 16 weak
    limbs (2^256 === 2^32 + 977)."""
    nh = cols.shape[0] - LIMBS
    hi = cols[LIMBS:]
    acc = torch.zeros((LIMBS + 2, cols.shape[1]), dtype=I64,
                      device=cols.device)
    acc[:LIMBS] = cols[:LIMBS]
    acc[:nh] += hi * _RED_LO
    acc[2:2 + nh] += hi
    for k in (LIMBS + 1, LIMBS):        # feedback columns 17, 16
        c = acc[k]
        acc[k - 16] += c * _RED_LO
        acc[k - 14] += c
    return weak_p(acc[:LIMBS])


def mul_limbs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p on weak ``[16, B]`` int64 limbs -> weak ``[16, B]``."""
    return reduce_cols(mul_cols(a, b))


def sqr_limbs(a: torch.Tensor) -> torch.Tensor:
    """a^2 mod p.  The dense outer product is one tensor op, so symmetry
    buys nothing here (the CUDA kernel does exploit it)."""
    return reduce_cols(mul_cols(a, a))


def canon_p(a: torch.Tensor) -> torch.Tensor:
    """Weak limbs -> canonical mod p: x >= p  <=>  x + (2^256 - p) carries
    out; one conditional subtract suffices because x < 2^256 < 2p."""
    t, carry = ripple(a + const_rows((1 << 256) - P_PRIME, a))
    return torch.where((carry > 0)[None, :], t, a)


# ---------------------------------------------------------------------------
# mulmod_chain: x * y^n mod p — the unit test of the device library.
# ---------------------------------------------------------------------------


def mulmod_chain_ref(x: torch.Tensor, y: torch.Tensor, n: int = 1):
    """Plain version of :func:`mulmod_chain` (any device)."""
    xv, yv = x.to(I64), y.to(I64)
    for _ in range(n):
        xv = mul_limbs(xv, yv)
    return canon_p(xv).to(torch.int32)


def mulmod_chain(x: torch.Tensor, y: torch.Tensor, n: int = 1):
    """x * y^n mod p on ``[16, B]`` int32 limb-major tensors (limbs
    <= 0xFFFF); returns the canonical result, ``[16, B]`` int32.

    CUDA tensors go through the hand-written kernel
    (``csrc/mulmod_chain.cu``); CPU tensors through the plain version."""
    if not x.is_cuda:
        return mulmod_chain_ref(x, y, n)
    lanes = _build.check_rows(x, LIMBS, "mulmod_chain x")
    _build.check_rows(y, LIMBS, "mulmod_chain y", lanes)
    out = torch.empty_like(x)
    lib = _build.lib()
    _build.count_launch("mulmod_chain")
    _build.check(lib.secp_mulmod_chain(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), lanes, int(n),
        _build.stream_ptr()), "mulmod_chain")
    return out
