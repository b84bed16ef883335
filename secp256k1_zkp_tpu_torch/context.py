"""Start-up self test of the port.

Counterpart of the JAX package's ``context.selftest`` (a known-answer test
run at context creation, as the reference C library's
``secp256k1_selftest`` does).  That one checks the SHA256 compression
function; SHA256 is not ported yet, so this one checks what the ported
slice stands on: the field multiply of the kernel library, through
``mulmod_chain`` — the hand-written kernel on a CUDA device, its plain
version on the CPU — against Python integers.  ``Context`` and generator
blinding wait for the signing slice.
"""

from __future__ import annotations

import torch

from .config import resolve_device
from .ops import cuda_field

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


def selftest(device="cuda") -> None:
    """Known-answer test of the field multiply on ``device``; raises
    ``RuntimeError`` on a mismatch (and when ``"cuda"`` is asked for
    without a card)."""
    dev = resolve_device(device)
    for x, y, n, wants in selftest_operands(dev):
        got = cuda_field.mulmod_chain(x, y, n).cpu().tolist()
        for j, want in enumerate(wants):
            have = sum(got[i][j] << (16 * i) for i in range(16))
            if have != want:
                raise RuntimeError(
                    f"field multiply selftest failure on {dev}: "
                    f"{hex(have)} != {hex(want)}")
