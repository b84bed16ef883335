"""Multi-scalar multiplication: R = sum_i k_i * P_i.

Counterpart of the JAX package's ``ops/msm.py``, cut to its dispatcher
``ecmult_multi`` on one route — the fused windowed-table engine of
``ops/cuda_msm.py`` (the kernels on a card, their plain versions on the
CPU) at every size above 0 — and to ``_tree_reduce``, the sum of a batch
of points (one ``gej_sum`` launch).  The JAX dispatcher takes that engine
for more than 256 points on a TPU and its portable ``msm_simple`` /
``msm_windowed`` / ``msm_pippenger`` otherwise; those, and batched
aggregates (``ks.ndim > 2``), are not ported yet (ROADMAP Queue A item
10).
"""

from __future__ import annotations

from ..config import resolve_device

from . import field as F
from . import scalar as S
from .cuda_group import gej_sum
from .cuda_msm import msm_windowed
from .group import GE, GEJ, gej_infinity
from .limb import LB, from_rows, kernel_rows


def _tree_reduce(pts: GEJ) -> GEJ:
    """Sum of the points along the leading axis: ``cuda_group.gej_sum``,
    one launch for any B on a card (its plain version, a halving tree, on
    the CPU).  Returns a 0-d ``GEJ`` (infinity for B = 0, without a
    launch); the counterpart of the JAX ``_tree_reduce``."""
    if pts.inf.dim() != 1:
        raise ValueError("_tree_reduce expects a 1-D batch of points")
    if pts.inf.shape[0] == 0:
        return gej_infinity((), pts.device)
    x, y, z, inf = gej_sum(*(kernel_rows(F.norm_weak(c))
                             for c in (pts.x, pts.y, pts.z)), pts.inf)
    return GEJ(*(from_rows(t, ()) for t in (x, y, z)), inf[0])


def ecmult_multi(ks: LB, pts: GE, device="cuda") -> GEJ:
    """sum_i k_i * P_i over the leading axis: ks ``[N, 16]`` scalar limbs
    (any representative: reduced mod n here), pts a ``GE`` of N points.
    Returns a 0-d ``GEJ`` on ``device`` (default ``"cuda"``, which raises
    when there is no card); N = 0 gives infinity without a launch."""
    dev = resolve_device(device)
    if ks.v.dim() > 2:
        raise NotImplementedError(
            "ecmult_multi: batched aggregates (ks.ndim > 2) are not ported")
    if ks.v.shape[0] == 0:
        return gej_infinity((), dev)
    ks = S.normalize(ks.to(dev))
    return msm_windowed(ks, pts.to(dev), nbits=256)

