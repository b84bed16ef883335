"""Lazy build and loading of the hand-written CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` at
the first kernel call — one ``nvcc -c`` per ``.cu`` file, all started
together, then one link into a shared library with a plain C interface
that is loaded with ``ctypes``.  The library lands in
``secp256k1_zkp_tpu_torch/_build/`` under a name keyed by a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses.

Nothing here catches a failure: a missing ``nvcc`` or a compile error
raises with the compiler's output, and every C entry point returns
``cudaGetLastError()`` which :func:`check` turns into an exception.

Also home of the launch counters: each kernel wrapper calls
:func:`count_launch` exactly where it launches its kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_U32 = ctypes.c_uint32

# name -> argtypes (pointers and the stream as c_void_p, sizes as c_int)
_SIGNATURES = {
    "secp_mulmod_chain": [_VP, _VP, _VP, _INT, _INT, _VP],
    "secp_ecdsa_prep": [_VP] * 6 + [_INT, _INT, _VP],
    "secp_ecdsa_prep_warps": [],
    "secp_fixedbase": [_VP] * 6 + [_INT] * 3 + [_VP],
    "secp_fixedbase_warps": [_INT] * 2,
    "secp_ecmult_glv": [_VP] * 13 + [_INT, _INT, _VP, _VP],
    "secp_ecmult_glv_warps": [_INT],
    "secp_lift_x": [_VP, _VP, _VP, _INT, _VP],
    "secp_lift_x_warps": [],
    "secp_glv_only": [_VP, _VP, _VP, _INT, _VP],
    "secp_schnorr_check": [_VP] * 6 + [_INT, _VP],
    "secp_sha256": [_VP, _VP, _VP, _INT, _INT, _VP],
    "secp_sha256_msg": [_VP, _INT, _VP, _VP, _U32, _U32, _VP, _INT, _INT,
                        _VP],
    "secp_rfc6979": [_VP, _VP, _VP, _INT, _INT, _VP],
    "secp_batch_digest": [_VP] * 6 + [_INT, _VP],
    "secp_sha256_warps": [_INT],
    "secp_ecdsa_finish": [_VP] * 9 + [_INT, _INT, _VP],
    "secp_ecdsa_finish_warps": [],
    "secp_affine_xy": [_VP] * 5 + [_INT, _INT, _VP],
    "secp_affine_xy_warps": [],
    "secp_muladd_n": [_VP] * 5 + [_INT, _VP],
    "secp_gej_add": [_VP] * 12 + [_INT, _VP],
    "secp_gej_sum": [_VP] * 9 + [_INT, _INT, _VP],
    "secp_gej_warps": [_INT],
    "secp_msm_table": [_VP] * 5 + [_INT, _VP],
    "secp_msm_table_warps": [],
    "secp_msm_winreduce": [_VP] * 7 + [_INT] * 4 + [_VP],
    "secp_msm_winreduce_warps": [],
    "secp_msm_finish": [_VP] * 8 + [_INT] * 2 + [_VP],
    "secp_msm_finish_warps": [],
    "secp_latency_probe": [_VP, _INT, _INT, _VP],
    "secp_affine_meta": [_VP] * 7 + [_INT, _INT, _VP],
    "secp_affine_meta_warps": [],
    "secp_inv_n": [_VP, _VP, _INT, _VP],
}

_LIB = None
BUILD_SECONDS = None        # wall seconds of the build done by this process
LAUNCH_COUNTS: dict[str, int] = {
    "mulmod_chain": 0, "ecdsa_prep": 0, "fixedbase_digits": 0,
    "ecmult_glv": 0, "lift_x": 0, "glv_only": 0, "schnorr_check": 0,
    "sha256": 0, "ecdsa_finish": 0, "affine_xy": 0, "muladd_n": 0,
    "fixedbase_blinded": 0, "gej_add": 0, "msm_table": 0,
    "msm_winreduce": 0, "msm_finish": 0, "affine_meta": 0, "inv_n": 0,
    "fixedbase_public": 0, "gej_sum": 0, "sha256_msg": 0, "rfc6979": 0,
    "batch_digest": 0}


def count_launch(name: str) -> None:
    LAUNCH_COUNTS[name] += 1


def reset_launch_counts() -> None:
    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of secp256k1_zkp_tpu_torch cannot be built here")


def build() -> Path:
    """Compile csrc/*.cu (in parallel) and link them; returns the .so path.
    Reuses a library already built from identical sources."""
    global BUILD_SECONDS
    out = BUILD_DIR / f"libsecp_kernels_{source_hash()}.so"
    if out.exists():
        return out
    nvcc = find_nvcc()
    t0 = time.time()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    procs = []
    for cu in sorted(SRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{cu.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-c", str(cu),
               "-o", str(obj)]
        procs.append((cu, obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cu, obj, cmd, p in procs:
        text, _ = p.communicate()
        log.append(f"$ {' '.join(cmd)}\n{text}")
        if p.returncode != 0:
            failed.append(cu.name)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(log))
    tmp = BUILD_DIR / f"{tag}.so"
    link = [nvcc, "-shared", "-o", str(tmp)] + [str(o) for _, o, _, _ in procs]
    r = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"link failed:\n{r.stdout}")
    os.replace(tmp, out)            # atomic: concurrent processes agree
    for _, obj, _, _ in procs:
        obj.unlink()
    BUILD_SECONDS = time.time() - t0
    return out


def build_log() -> str:
    p = BUILD_DIR / "build.log"
    return p.read_text() if p.exists() else ""


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        dll = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(dll, name)
            fn.argtypes = argtypes
            fn.restype = _INT
        dll.secp_cuda_error_string.argtypes = [_INT]
        dll.secp_cuda_error_string.restype = ctypes.c_char_p
        _LIB = dll
    return _LIB


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib().secp_cuda_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"error {code} ({msg})")


def stream_ptr() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


@lru_cache(maxsize=8)
def sm_count(device: str) -> int:
    """The SMs of a CUDA device (the launch rules size their grids by it)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_rows(t, rows: int, name: str, lanes: int | None = None) -> int:
    """Validate a kernel operand: CUDA, int32, contiguous ``[rows, B]``
    with B >= 1.  Returns B.  Raises on anything the kernels do not take
    (an empty batch launches nothing, so it is refused before the launch
    is counted)."""
    import torch
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: expected int32 limbs, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != rows:
        raise ValueError(f"{name}: expected shape [{rows}, B], got "
                         f"{tuple(t.shape)}")
    if t.shape[1] == 0:
        raise ValueError(f"{name}: expected at least one lane")
    if lanes is not None and t.shape[1] != lanes:
        raise ValueError(f"{name}: expected {lanes} lanes, got {t.shape[1]}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.shape[1]
