"""Fixed-base multiplication k*G from signed-w7 comb digit rows.

Counterpart of the JAX package's ``ops/pallas_gen.py`` (``_comb_tables_np``,
``gen_digits``, ``_gen_kernel``, ``fixedbase_digits_tpu``): digit position
v (0..36) runs against its own 64-entry table of d * 2^(7v) * G, so k*G
costs 37 complete mixed adds and no doublings.  The kernel selects each
entry with a full table scan (the same code serves signing, where k is
secret); the plain version indexes the table directly.

The blinded tail of the reference kernel (one more mixed add of -b*G) is
not ported yet: it belongs to the signing slice, the verify path runs
unblinded.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from . import _build
from ..utils import hostcurve as hc
from .cuda_field import I64, LIMBS, MASK16, canon_p, limbs16
from .cuda_group import FE, fe_neg, fe_select, fe_weak, jp_add_aff, jp_inf
from .cuda_scalar import NW7, recode_w7_256

COMB_ENTRIES = 64   # signed-w7 magnitudes 1..64


@lru_cache(maxsize=1)
def comb_tables() -> torch.Tensor:
    """``[37, 64, 2, 16]`` int64 (CPU): entry ``[v, d-1]`` holds the x and y
    base-2^16 limbs of (d * 2^(7v) mod n) * G.

    Built by jacobian accumulation (base_{v+1} = 128 * base_v, entry_d =
    entry_{d-1} + base) and one shared Montgomery inversion."""
    jpts = []
    base = hc.jlift(hc.G)
    for _ in range(NW7):
        acc = base
        for _d in range(COMB_ENTRIES):
            jpts.append(acc)
            acc = hc.jadd(acc, base)
        for _ in range(7):
            base = hc.jdouble(base)
    flat = [[limbs16(x), limbs16(y)] for x, y in hc.batch_affine(jpts)]
    return torch.tensor(flat, dtype=I64).reshape(NW7, COMB_ENTRIES, 2, LIMBS)


def pack_words(tab: torch.Tensor) -> torch.Tensor:
    """``[..., 16]`` base-2^16 limbs -> ``[..., 8]`` int32 holding the bits
    of the kernels' 32-bit words."""
    words = tab[..., 0::2] | (tab[..., 1::2] << 16)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


@lru_cache(maxsize=8)
def _comb_words(device: str) -> torch.Tensor:
    """The kernel's table: ``[37, 64, 16]`` int32 words (x 0-7, y 8-15)."""
    return pack_words(comb_tables()).reshape(NW7, COMB_ENTRIES, 16) \
        .contiguous().to(device)


@lru_cache(maxsize=8)
def _comb_limbs(device: str) -> torch.Tensor:
    return comb_tables().to(device)


def gen_digits(k: torch.Tensor) -> torch.Tensor:
    """Canonical scalar ``[16, B]`` int32 -> its ``[37, B]`` int32 signed-w7
    comb rows (MSB-first), the operand of :func:`fixedbase_digits`.
    Elementwise glue in plain PyTorch on both devices, as it is XLA glue
    in the JAX package (``pallas_gen.gen_digits``)."""
    return recode_w7_256(k.to(I64)).to(torch.int32)


def fixedbase_digits_ref(gdigs: torch.Tensor):
    """Plain version of :func:`fixedbase_digits` (any device)."""
    gdigs = gdigs.to(I64)
    tab = _comb_limbs(str(gdigs.device))
    acc = jp_inf(gdigs[0])
    for i in range(NW7):
        row = gdigs[i]
        mag, sgn = row & 0xFF, (row >> 8) != 0
        # rows are MSB-first: row i is digit position NW7-1-i
        ent = tab[NW7 - 1 - i].index_select(0, (mag - 1).clamp(min=0))
        gx = FE(ent[:, 0, :].T, MASK16)
        gy = FE(ent[:, 1, :].T, MASK16)
        gy = fe_select(sgn, fe_weak(fe_neg(gy)), gy)
        acc = jp_add_aff(acc, gx, gy, mag == 0)
    # z = 0 marks infinity lanes (all-zero digits: k === 0 mod n)
    z = torch.where(acc.inf[None, :], torch.zeros_like(acc.z.l),
                    canon_p(fe_weak(acc.z).l))
    i32 = torch.int32
    return (canon_p(fe_weak(acc.x).l).to(i32),
            canon_p(fe_weak(acc.y).l).to(i32), z.to(i32))


def fixedbase_digits(gdigs: torch.Tensor):
    """k*G from signed-w7 comb digit rows ``[37, B]`` int32 (the layout of
    ``cuda_scalar.recode_w7_256``, MSB-first).

    Returns jacobian (x, y, z) ``[16, B]`` int32 **canonical** limbs;
    z == 0 marks infinity lanes.  CUDA tensors go through the hand-written
    kernel (``csrc/fixedbase.cu``); CPU tensors through the plain version."""
    if not gdigs.is_cuda:
        return fixedbase_digits_ref(gdigs)
    lanes = _build.check_rows(gdigs, NW7, "fixedbase_digits gdigs")
    tab = _comb_words(str(gdigs.device))
    ox = torch.empty((LIMBS, lanes), dtype=torch.int32, device=gdigs.device)
    oy = torch.empty_like(ox)
    oz = torch.empty_like(ox)
    lib = _build.lib()
    _build.count_launch("fixedbase_digits")
    _build.check(lib.secp_fixedbase_digits(
        gdigs.data_ptr(), tab.data_ptr(), ox.data_ptr(), oy.data_ptr(),
        oz.data_ptr(), lanes, _build.stream_ptr()), "fixedbase_digits")
    return ox, oy, oz
