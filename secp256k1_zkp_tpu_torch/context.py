"""Start-up self test of the port.

Counterpart of the JAX package's ``context.selftest`` (a known-answer test
run at context creation, as the reference C library's
``secp256k1_selftest`` does).  It runs that test — the SHA256 compression
of one known message — through the port's host compression
(``utils/sha256_host``) and through ``ops/sha256.compress`` on the
device, which on a card is the hand-written SHA-256 kernel.  It also
checks what the verify slices stand on: the field multiply of the kernel
library, through ``mulmod_chain`` (the kernel on a CUDA device, its plain
version on the CPU), against Python integers.  ``Context`` and generator
blinding wait for the signing slice.
"""

from __future__ import annotations

import struct

import torch

from .config import resolve_device
from .ops import cuda_field
from .ops import sha256 as H
from .utils import sha256_host

# the JAX package's known-answer test (context.py there): one 64-byte
# message block, then the padding block of a 64-byte message
_SHA_BASE = b"secp256k1_zkp_tpu selftest: pluggable compression KAT"
_SHA_MSG = _SHA_BASE + b"." * (64 - len(_SHA_BASE))
_SHA_PAD = bytes([0x80] + [0] * 55) + (64 * 8).to_bytes(8, "big")
_SHA_WANT = "7df9d205f1b40a45c888f99a1b500eb9626ab62d1769a316c066551a9e8eedcc"

_KAT = (
    # (x, y, n): x * y^n mod p
    (3, 5, 1),
    (cuda_field.P_PRIME - 1, cuda_field.P_PRIME - 1, 3),
    (2 ** 255 + 12345, 2 ** 256 - 1, 7),
    (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
     0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8, 16),
)


def selftest_operands(device):
    """The known-answer cases as kernel operands, one group per chain
    length: yields (x ``[16, B]``, y ``[16, B]``, n, expected ints)."""
    for n in sorted({k[2] for k in _KAT}):
        cases = [k for k in _KAT if k[2] == n]
        x = torch.tensor([cuda_field.limbs16(c[0]) for c in cases],
                         dtype=torch.int32, device=device).T.contiguous()
        y = torch.tensor([cuda_field.limbs16(c[1]) for c in cases],
                         dtype=torch.int32, device=device).T.contiguous()
        want = [c[0] * pow(c[1], n, cuda_field.P_PRIME) % cuda_field.P_PRIME
                for c in cases]
        yield x, y, n, want


def _digest_hex(words) -> str:
    return b"".join(int(w).to_bytes(4, "big") for w in words).hex()


def _sha256_kat(device) -> None:
    """The SHA256 known-answer test, on the host and on ``device``."""
    st = sha256_host.compress(list(sha256_host.INIT), _SHA_MSG)
    got = _digest_hex(sha256_host.compress(st, _SHA_PAD))
    if got != _SHA_WANT:
        raise RuntimeError(f"SHA256 selftest failure on the host: {got}")
    state = torch.tensor([sha256_host.INIT], dtype=torch.int64,
                         device=device)
    for block in (_SHA_MSG, _SHA_PAD):
        words = torch.tensor([struct.unpack(">16I", block)],
                             dtype=torch.int64, device=device)
        state = H.compress(state, words)
    got = _digest_hex(state[0].tolist())
    if got != _SHA_WANT:
        raise RuntimeError(f"SHA256 selftest failure on {device}: {got}")


def selftest(device="cuda") -> None:
    """Known-answer tests of SHA256 and of the field multiply on
    ``device``; raises ``RuntimeError`` on a mismatch (and when
    ``"cuda"`` is asked for without a card)."""
    dev = resolve_device(device)
    _sha256_kat(dev)
    for x, y, n, wants in selftest_operands(dev):
        got = cuda_field.mulmod_chain(x, y, n).cpu().tolist()
        for j, want in enumerate(wants):
            have = sum(got[i][j] << (16 * i) for i in range(16))
            if have != want:
                raise RuntimeError(
                    f"field multiply selftest failure on {dev}: "
                    f"{hex(have)} != {hex(want)}")
