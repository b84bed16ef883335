"""Multi-scalar multiplication: R = sum_i k_i * P_i.

Counterpart of the JAX package's ``ops/msm.py``, cut to its dispatcher
``ecmult_multi`` on one route — the fused windowed-table engine of
``ops/cuda_msm.py`` (the kernels on a card, their plain versions on the
CPU) at every size above 0 — and to ``_tree_reduce``, the sum of a batch
of points by a tree of ``gej_add`` launches.  The JAX dispatcher takes
that engine for more than 256 points on a TPU and its portable
``msm_simple`` / ``msm_windowed`` / ``msm_pippenger`` otherwise; those,
and batched aggregates (``ks.ndim > 2``), are not ported yet (ROADMAP A9).
"""

from __future__ import annotations

from ..config import resolve_device
import torch

from . import scalar as S
from .cuda_msm import msm_windowed
from .group import GE, GEJ, gej_add, gej_infinity
from .limb import LB


def _tree_reduce(pts: GEJ) -> GEJ:
    """Sum of the points along the leading axis by pairwise halving:
    lanes 2i and 2i+1 are added, one ``gej_add`` launch a level
    (ceil(log2 B) of them), an odd level padded with infinity.  Returns a
    0-d ``GEJ`` (infinity for B = 0)."""
    if pts.inf.dim() != 1:
        raise ValueError("_tree_reduce expects a 1-D batch of points")
    if pts.inf.shape[0] == 0:
        return gej_infinity((), pts.device)
    cur = pts
    while cur.inf.shape[0] > 1:
        if cur.inf.shape[0] % 2:
            pad = gej_infinity((1,), cur.device)
            cur = GEJ(*(LB(torch.cat([c.v, p.v]), max(c.bound, p.bound))
                        for c, p in ((cur.x, pad.x), (cur.y, pad.y),
                                     (cur.z, pad.z))),
                      torch.cat([cur.inf, pad.inf]))
        lo, hi = (GEJ(*(LB(c.v[k::2], c.bound)
                        for c in (cur.x, cur.y, cur.z)), cur.inf[k::2])
                  for k in (0, 1))
        cur = gej_add(lo, hi)
    return GEJ(*(LB(c.v[0], c.bound) for c in (cur.x, cur.y, cur.z)),
               cur.inf[0])


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

