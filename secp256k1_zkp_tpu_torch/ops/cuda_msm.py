"""The fused windowed-table MSM engine: R = sum_i k_i * P_i.

Counterpart of the JAX package's ``ops/pallas_msm.py``: per-point
true-affine tables d*P, d = 1..15 (``msm_table``), 4-bit windows reduced
to per-window partial sums (``msm_winreduce``), and sum_w 16^w * S_w of
those partials as one point (``msm_finish``; on the TPU the Horner
recurrence on 128 lanes and their collapse by the add kernel);
``msm_windowed`` chains them, as ``msm_windowed_tpu`` does.  Each kernel
wrapper sits beside its plain PyTorch version; the device of the tensors
decides which runs.

Layouts: points are limb-major ``[16, N]`` int32 limbs with ``[N]`` bool
infinity masks, as every kernel of the port takes them; digits are
``[nwin, N]`` int32 (window w of lane i at ``[w, i]``, LSB window first);
the table is lane-major ``[N, 15, 16]`` int32 — entry d - 1 of lane i
holds the 32-bit words of the canonical affine d*P_i, x in 0-7 and y in
8-15 (``csrc/msm.cuh``), so a lane's digit names one 64-byte entry.

The window partials and the finish's result are jacobian: their
representation depends on the order of the additions, so the kernels and
the plain versions are compared as points (:func:`points_affine`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as tnf

from . import _build
from . import field as F
from .cuda_divsteps import inv_limbs16
from .cuda_field import LIMBS, MASK16, P_PRIME, canon_p, mul_limbs, sqr_limbs
from .cuda_gen import pack_words
from .cuda_group import (FE, JP, _canon32, _rows_fe, affine_multiples,
                         block_sum_ref, fe_const, fe_select, fe_weak,
                         jp_add, jp_double, jp_inf, tree_sum)
from .group import GE, GEJ
from .limb import LB, from_rows, kernel_rows
from ..utils import hostcurve

NENT = 15                 # table entries 1..15 (unsigned 4-bit digits)
TABLE_SCRATCH_ROWS = 13 * 16 + 12 * 8   # msm_table's X, Y and z-ratio rows
WR_THREADS = 32           # threads of one (window, chunk) partial: a warp
WR_PARTIALS = 1056        # msm_winreduce partials (one warp each) at most:
                          # two blocks of 4 warps on each of an H100's 132
                          # SMs (chip_smoke.py sweeps nblk)
FINISH_THREADS = 256      # msm_finish's one block (csrc/msm_finish.cu)
FINISH_WINDOWS = FINISH_THREADS // 2    # two threads a window's ladder
I32 = torch.int32
I64 = torch.int64


def digits_u4(k: torch.Tensor, nwin: int) -> torch.Tensor:
    """Canonical ``[16, N]`` scalar limbs -> ``[nwin, N]`` int32 unsigned
    4-bit window digits, LSB window first (each digit sits inside one
    16-bit limb); the counterpart of ``pallas_msm._digits_u4``."""
    shifts = torch.arange(0, 16, 4, dtype=I64, device=k.device)
    d = (k.to(I64)[:, None, :] >> shifts[None, :, None]) & 0xF
    return d.reshape(4 * LIMBS, -1)[:nwin].to(I32).contiguous()


def _unpack_words(w: torch.Tensor) -> torch.Tensor:
    """``[..., 8]`` int32 words -> ``[..., 16]`` int64 base-2^16 limbs."""
    w = w.to(I64) & 0xFFFFFFFF
    return torch.stack([w & MASK16, w >> 16], -1).flatten(-2)


# ---------------------------------------------------------------------------
# msm_table
# ---------------------------------------------------------------------------


def msm_table_ref(px, py, pinf):
    """Plain version of :func:`msm_table` (any device)."""
    pinf = pinf.to(torch.bool)
    like = px[0]
    x = fe_select(pinf, fe_const(hostcurve.GX, like), _rows_fe(px))
    y = fe_select(pinf, fe_const(hostcurve.GY, like), _rows_fe(py))
    axs, ays = affine_multiples(x, y, NENT)
    ent = torch.stack([torch.stack([canon_p(fe_weak(axs[d]).l),
                                    canon_p(fe_weak(ays[d]).l)])
                       for d in range(1, NENT + 1)])      # [15, 2, 16, N]
    words = pack_words(ent.permute(3, 0, 1, 2))           # [N, 15, 2, 8]
    return words.reshape(-1, NENT, 16).contiguous()


def msm_table(px, py, pinf):
    """Per point, the canonical affine d*P for d = 1..15: px, py ``[16, N]``
    int32 limbs, pinf ``[N]`` bool (those lanes' tables are built from G
    and never read) -> ``[N, 15, 16]`` int32 words (module docstring).

    CUDA tensors go through the hand-written kernel (``csrc/msm_table.cu``,
    with a word-major ``[TABLE_SCRATCH_ROWS, N]`` scratch for the chain);
    CPU tensors through the plain version."""
    if not px.is_cuda:
        return msm_table_ref(px, py, pinf)
    lanes = _build.check_rows(px, LIMBS, "msm_table px")
    _build.check_rows(py, LIMBS, "msm_table py", lanes)
    if not pinf.is_cuda or pinf.shape != (lanes,):
        raise ValueError("msm_table pinf: expected a CUDA [N] mask")
    pinf32 = pinf.to(I32).contiguous()
    tab = torch.empty((lanes, NENT, 16), dtype=I32, device=px.device)
    # scratch dies with this call while the kernel may still run: safe, the
    # caching allocator reuses a block only in stream order
    scratch = torch.empty((TABLE_SCRATCH_ROWS, lanes), dtype=I32,
                          device=px.device)
    lib = _build.lib()
    _build.count_launch("msm_table")
    _build.check(lib.secp_msm_table(
        px.data_ptr(), py.data_ptr(), pinf32.data_ptr(), tab.data_ptr(),
        scratch.data_ptr(), lanes, _build.stream_ptr()), "msm_table")
    return tab


# ---------------------------------------------------------------------------
# msm_winreduce
# ---------------------------------------------------------------------------


def winreduce_blocks(lanes: int, nwin: int) -> int:
    """Lane chunks per window (``nblk``): as many as keep nwin * nblk
    within WR_PARTIALS, never a chunk with fewer lanes than a warp has
    threads.  On an H100 the kernel's times fit a bound by each SM's
    throughput, set by the most blocks any SM runs: two
    blocks an SM, all at once, was the fastest or within 2% of it at
    every N the sweep tried (16,384 to 2^20 points; a third block on a
    few SMs cost a third more), the threads folding longer runs as N
    grows (PERF.md)."""
    nblk = max(1, min(-(-lanes // WR_THREADS), WR_PARTIALS // nwin))
    chunk = -(-lanes // nblk)
    return -(-lanes // chunk)               # no empty chunk


def msm_winreduce_ref(digs, tab, pinf, nblk: int):
    """Plain version of :func:`msm_winreduce` (any device).  Each chunk's
    lanes are summed by a tree of complete adds, a few windows at a time
    (at most 2^22 lanes in flight: the column products of the first level
    then take 4 GB)."""
    nwin, lanes = digs.shape
    chunk = -(-lanes // nblk)
    width = 1 << (chunk - 1).bit_length()
    group = max(1, (1 << 22) // (nblk * width))
    pinf = pinf.to(torch.bool)
    lane_idx = torch.arange(lanes, device=digs.device)
    outs = []
    for w0 in range(0, nwin, group):
        d = digs[w0:w0 + group].to(I64) & 0xF                  # [g, N]
        ent = tab[lane_idx[None, :], (d - 1).clamp(min=0)]    # [g, N, 16]
        x = _unpack_words(ent[..., :8])
        y = _unpack_words(ent[..., 8:])
        inf = (d == 0) | pinf[None, :]

        def lay(t, fill):
            # [..., g, N] -> [..., g * nblk * width]: chunk c of window w
            # is the run of ``width`` lanes at (w * nblk + c) * width
            t = tnf.pad(t, (0, nblk * chunk - lanes), value=fill)
            t = t.reshape(*t.shape[:-1], nblk, chunk)
            t = tnf.pad(t, (0, width - chunk), value=fill)
            return t.reshape(*t.shape[:-3], -1)

        xs = lay(x.permute(2, 0, 1), 0)                        # [16, L]
        one = torch.zeros_like(xs)
        one[0] = 1
        p = JP(FE(xs, MASK16), FE(lay(y.permute(2, 0, 1), 0), MASK16),
               FE(one, MASK16), lay(inf.to(I64), 1) != 0)
        outs.append(tree_sum(p, width))
    return (torch.cat([_canon32(o.x) for o in outs], 1),
            torch.cat([_canon32(o.y) for o in outs], 1),
            torch.cat([_canon32(o.z) for o in outs], 1),
            torch.cat([o.inf for o in outs]))


def msm_winreduce(digs, tab, pinf, nblk: int):
    """Per window w and lane chunk c, the partial sum of d_{i,w} * P_i over
    the chunk's lanes: digs ``[nwin, N]`` int32 (0..15), tab the
    ``[N, 15, 16]`` table of :func:`msm_table`, pinf ``[N]`` bool (those
    lanes add nothing), ``nblk`` chunks of ceil(N / nblk) lanes.

    Returns jacobian (x, y, z ``[16, nwin * nblk]`` int32 canonical, inf
    ``[nwin * nblk]`` bool), partial (w, c) at column w * nblk + c.  CUDA
    tensors go through the hand-written kernel (``csrc/msm_winreduce.cu``);
    CPU tensors through the plain version."""
    if not digs.is_cuda:
        return msm_winreduce_ref(digs, tab, pinf, nblk)
    nwin = digs.shape[0]
    lanes = _build.check_rows(digs, nwin, "msm_winreduce digs")
    if (not tab.is_cuda or tab.dtype != I32 or not tab.is_contiguous()
            or tab.shape != (lanes, NENT, 16)):
        raise ValueError("msm_winreduce tab: expected a contiguous CUDA "
                         f"int32 [{lanes}, {NENT}, 16] table")
    if not pinf.is_cuda or pinf.shape != (lanes,):
        raise ValueError("msm_winreduce pinf: expected a CUDA [N] mask")
    chunk = -(-lanes // nblk)
    if not 1 <= nblk <= lanes or -(-lanes // chunk) != nblk:
        raise ValueError(f"msm_winreduce: {nblk} chunks of {lanes} lanes "
                         "leave one empty")
    pinf32 = pinf.to(I32).contiguous()
    cols = nwin * nblk
    ox = torch.empty((LIMBS, cols), dtype=I32, device=digs.device)
    oy = torch.empty_like(ox)
    oz = torch.empty_like(ox)
    oinf = torch.empty((cols,), dtype=I32, device=digs.device)
    lib = _build.lib()
    _build.count_launch("msm_winreduce")
    _build.check(lib.secp_msm_winreduce(
        digs.data_ptr(), tab.data_ptr(), pinf32.data_ptr(), ox.data_ptr(),
        oy.data_ptr(), oz.data_ptr(), oinf.data_ptr(), lanes, nwin, nblk,
        chunk, _build.stream_ptr()), "msm_winreduce")
    return ox, oy, oz, oinf != 0


# ---------------------------------------------------------------------------
# msm_finish and the engine
# ---------------------------------------------------------------------------


def finish_team(nwin: int) -> int:
    """Threads a window in msm_finish's first stage: the most (a power of
    two, at most a warp) with team * nwin <= FINISH_THREADS."""
    team = 1
    while team < 32 and 2 * team * nwin <= FINISH_THREADS:
        team *= 2
    return team


def msm_finish_ref(x, y, z, inf, nwin: int):
    """Plain version of :func:`msm_finish` (any device), in the kernel's
    order: each window's team of threads folds its partials and sums them
    by a shuffle tree (S_w), S_w is doubled 4w times (the kernel's pair of
    threads gives the same residues), and the block's tree adds the nwin
    terms."""
    nblk = x.shape[1] // nwin
    team = finish_team(nwin)
    steps = -(-nblk // team)

    def lay(t, fill):
        # [..., nwin * nblk] -> [..., steps, nwin * team]: partial
        # r + k * team of window w is thread w * team + r's k-th
        lead = t.shape[:-1]
        t = tnf.pad(t.reshape(*lead, nwin, nblk), (0, steps * team - nblk),
                    value=fill)
        t = t.reshape(*lead, nwin, steps, team).transpose(-2, -3)
        return t.reshape(*lead, steps, nwin * team)

    px, py, pz = (lay(t.to(I64), 0) for t in (x, y, z))
    pinf = lay(inf.to(I64), 1) != 0
    # a thread past its window's last partial adds nothing more; one with
    # none at all holds infinity
    real = lay(torch.ones_like(inf, dtype=I64), 0) != 0

    def col(k):
        return JP(FE(px[:, k], MASK16), FE(py[:, k], MASK16),
                  FE(pz[:, k], MASK16), pinf[k])

    def where(m, a, b):
        return JP(fe_select(m, a.x, b.x), fe_select(m, a.y, b.y),
                  fe_select(m, a.z, b.z), torch.where(m, a.inf, b.inf))

    acc = where(real[0], col(0), jp_inf(px[0, 0]))
    for k in range(1, steps):
        acc = where(real[k], jp_add(acc, col(k)), acc)
    acc = tree_sum(acc, team)                   # S_w, [nwin] lanes
    w = torch.arange(nwin, device=x.device)
    for k in range(4 * (nwin - 1)):
        acc = where(k < 4 * w, jp_double(acc), acc)
    out = block_sum_ref(acc)
    return _canon32(out.x), _canon32(out.y), _canon32(out.z), out.inf


def msm_finish(x, y, z, inf, nwin: int):
    """The window partials of :func:`msm_winreduce` (``[16, nwin * nblk]``
    int32, inf ``[nwin * nblk]`` bool; 1 <= nwin <= FINISH_WINDOWS) ->
    sum_w 16^w * S_w, S_w the sum of window w's nblk partials: the MSM's
    result.

    Returns (x, y, z ``[16, 1]`` int32 canonical, inf ``[1]`` bool).  CUDA
    tensors go through the hand-written kernel (``csrc/msm_finish.cu``, one
    block, one launch); CPU tensors through the plain version."""
    if not 1 <= nwin <= FINISH_WINDOWS:
        raise ValueError(f"msm_finish: nwin must be 1..{FINISH_WINDOWS}, "
                         f"not {nwin}")
    if x.shape[-1] % nwin or x.shape[-1] == 0:
        raise ValueError(f"msm_finish: {x.shape[-1]} partials for {nwin} "
                         "windows")
    if not x.is_cuda:
        return msm_finish_ref(x, y, z, inf, nwin)
    cols = _build.check_rows(x, LIMBS, "msm_finish x")
    _build.check_rows(y, LIMBS, "msm_finish y", cols)
    _build.check_rows(z, LIMBS, "msm_finish z", cols)
    if not inf.is_cuda or inf.shape != (cols,):
        raise ValueError("msm_finish inf: expected a CUDA mask")
    inf32 = inf.to(I32).contiguous()
    ox = torch.empty((LIMBS, 1), dtype=I32, device=x.device)
    oy = torch.empty_like(ox)
    oz = torch.empty_like(ox)
    oinf = torch.empty((1,), dtype=I32, device=x.device)
    lib = _build.lib()
    _build.count_launch("msm_finish")
    _build.check(lib.secp_msm_finish(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), inf32.data_ptr(),
        ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), oinf.data_ptr(), nwin,
        cols // nwin, _build.stream_ptr()), "msm_finish")
    return ox, oy, oz, oinf != 0


def points_affine(x, y, z, inf, groups: int):
    """Comparison support, called by ``chip_smoke.py`` and the tests and
    by nothing on the engine's path: split the lanes into ``groups`` equal
    runs, sum each run, and return each sum as canonical affine
    (x, y ``[16, groups]`` int64, zeros at infinity; inf ``[groups]``).
    Jacobian results of different addition orders compare equal here
    exactly when they are the same points."""
    per = x.shape[1] // groups
    width = 1 << (per - 1).bit_length()

    def lay(t, fill):
        t = t.reshape(*t.shape[:-1], groups, per)
        return tnf.pad(t, (0, width - per), value=fill) \
            .reshape(*t.shape[:-2], -1)

    p = tree_sum(JP(*(FE(lay(t.to(I64), 0), MASK16) for t in (x, y, z)),
                     lay(inf.to(I64), 1) != 0), width)
    zinv = inv_limbs16(canon_p(fe_weak(p.z).l), P_PRIME)
    zi2 = sqr_limbs(zinv)
    ax = canon_p(mul_limbs(fe_weak(p.x).l, zi2))
    ay = canon_p(mul_limbs(fe_weak(p.y).l, mul_limbs(zi2, zinv)))
    keep = ~p.inf[None, :]
    return ax * keep, ay * keep, p.inf


def msm_windowed(ks: LB, pts: GE, nbits: int = 256) -> GEJ:
    """R = sum_i k_i * P_i: ks ``[N, 16]`` canonical scalar limbs below
    2^nbits, pts a ``GE`` of N points (infinite lanes add nothing).
    Returns a 0-d ``GEJ``; the counterpart of ``msm_windowed_tpu``.

    ``nbits`` must be 128 or 256, and 128-bit scalars must have zero high
    limbs (checked, one reduction on the device).  The JAX function floors
    ``nwin // chunk`` in its finish and so silently drops top windows for
    other widths, and never checks that the scalars fit (ROADMAP Queue C);
    the port refuses both instead.  Its kernels mask the ragged edge, so
    nothing is padded.

    msm_table -> msm_winreduce -> msm_finish, three launches: on CUDA
    tensors the hand-written kernels, on CPU tensors their plain
    versions."""
    if nbits not in (128, 256):
        raise ValueError(f"msm_windowed: nbits must be 128 or 256, not "
                         f"{nbits}")
    lanes = ks.v.shape[0]
    if ks.v.dim() != 2 or lanes == 0 or pts.x.v.shape[0] != lanes:
        raise ValueError("msm_windowed: expected N >= 1 scalars [N, 16] and "
                         "N points")
    if nbits == 128 and bool((ks.v[:, 8:] != 0).any()):
        raise ValueError("msm_windowed: a scalar exceeds 128 bits")
    nwin = nbits // 4
    digs = digits_u4(kernel_rows(ks), nwin)
    pinf = pts.inf.to(torch.bool).contiguous()
    tab = msm_table(kernel_rows(F.norm_weak(pts.x)),
                    kernel_rows(F.norm_weak(pts.y)), pinf)
    parts = msm_winreduce(digs, tab, pinf, winreduce_blocks(lanes, nwin))
    x, y, z, inf = msm_finish(*parts, nwin)
    return GEJ(*(from_rows(t, ()) for t in (x, y, z)), inf[0])
