"""Library context: start-up self test and generator blinding.

Counterpart of the JAX package's ``context.py``.  ``selftest`` is the
known-answer test run at context creation, as the reference C library's
``secp256k1_selftest`` does: the SHA256 compression of one known message
through the port's host compression (``utils/sha256_host``) and through
``ops/sha256.compress`` on the device, which on a card is the
hand-written SHA-256 kernel, and the field multiply of the kernel library
through ``mulmod_chain`` (the kernel on a CUDA device, its plain version
on the CPU) against Python integers.

``Context`` holds the ecmult_gen blinding state (``randomize``) and the
pluggable compression hook (``set_hash_compress``).  Unlike the JAX
package's it holds no ``GenTable``: the portable ``ops/ecmult.py`` that
table serves is not ported yet, and the comb kernel's tables live in
``ops/cuda_gen``.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import struct
from functools import lru_cache

import torch

from .config import resolve_device
from .ops import cuda_field
from .ops import sha256 as H
from .ops.cuda_gen import Blind
from .utils import hostcurve, sha256_host

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


def _derive_blind(seed32: bytes, n: int) -> int:
    """HMAC-SHA256 DRBG -> scalar in [1, n-1], on the host.

    The derivation shape of the reference's ecmult_gen_blind
    (src/ecmult_gen_impl.h:306-331: an rfc6979 chain keyed on the seed,
    retried until valid)."""
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = _hmac.new(k, v + b"\x00" + seed32, hashlib.sha256).digest()
    v = _hmac.new(k, v, hashlib.sha256).digest()
    k = _hmac.new(k, v + b"\x01" + seed32, hashlib.sha256).digest()
    v = _hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = _hmac.new(k, v, hashlib.sha256).digest()
        b = int.from_bytes(v, "big")
        if 0 < b < n:
            return b
        k = _hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = _hmac.new(k, v, hashlib.sha256).digest()


class Context:
    """The ecmult_gen blinding state (``blind``: None until
    :meth:`randomize`, as the reference's static context is unblinded,
    src/secp256k1.c:90-98) of callers on ``device``.  Creation runs
    :func:`selftest` on that device (default ``"cuda"``, which raises when
    there is no card)."""

    def __init__(self, device="cuda", hash_compress=None):
        self.device = resolve_device(device)
        selftest(self.device)
        if hash_compress is not None:
            self.set_hash_compress(hash_compress)
        self.blind = None

    def set_hash_compress(self, fn) -> None:
        """Install a custom SHA256 compression for every hash of the
        library (None restores the built-in route) and check it with a
        known answer on the context's device; a function that fails is
        taken out again before this raises.  The per-context compression
        hook of the fork (include/secp256k1.h:420-446); process-global,
        like the JAX package's."""
        prev = H.set_compress(fn)
        if fn is None:
            return
        try:
            msg = torch.full((1, 32), 0x61, dtype=torch.uint8,
                             device=self.device)
            got = bytes(H.words_to_bytes32(H.sha256_bytes(msg))[0].tolist())
            if got != hashlib.sha256(b"\x61" * 32).digest():
                raise RuntimeError(
                    "custom SHA256 compression failed the selftest KAT")
        except Exception:
            H.set_compress(prev)
            raise

    def randomize(self, seed32: bytes | None = None) -> "Context":
        """Derive the blinding from seed32 (secp256k1_context_randomize,
        src/secp256k1.c:833-841): b from an HMAC-DRBG, and -b*G by host
        arithmetic.  seed32=None resets to the unblinded state."""
        if seed32 is None:
            self.blind = None
            return self
        b = _derive_blind(bytes(seed32), hostcurve.N)
        gbx, gby = hostcurve.mul(hostcurve.N - b)
        self.blind = Blind(b, gbx, gby)
        return self


@lru_cache(maxsize=4)
def default_context(device="cuda") -> Context:
    return Context(device)
