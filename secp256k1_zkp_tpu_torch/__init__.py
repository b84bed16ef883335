"""secp256k1_zkp_tpu_torch — the PyTorch/CUDA port of secp256k1_zkp_tpu.

Same layout as the JAX package so a reader finds the counterpart of each
file; PyTorch idiom inside: plain functions on tensors, small dataclasses
of tensors (``LB``/``GE``/``GEJ``), an explicit device everywhere.

=====================  =====================================================
``ops.limb``           batched base-2^16 modular bignum engine (int64 limbs)
``ops.field``          GF(p) instance
``ops.scalar``         GF(n) instance
``ops.group``          point containers (``GE``/``GEJ``) and constructors
``ops.cuda_field``     mod-p kernel library, plain versions + ``mulmod_chain``
``ops.cuda_divsteps``  safegcd modular inverse, plain version
``ops.cuda_scalar``    mod-n library + the ECDSA *prep* kernel
``ops.cuda_group``     complete group formulas + the GLV Strauss kernel
``ops.cuda_gen``       fixed-base comb tables + kernel
``modules.ecdsa``      batched ECDSA verify (the kernel pipeline)
``utils.hostcurve``    Python-int curve for table generation
``utils.convert``      tables and containers of the JAX package -> port
``csrc/``              the CUDA C++ sources of the four kernels
=====================  =====================================================

Importing the package needs no CUDA, no compiler and no Triton: the
kernels are built with ``nvcc`` at the first kernel call (``ops/_build``).
A tensor's device decides the route: CUDA tensors go through the
hand-written kernels (or raise), CPU tensors through the plain PyTorch
versions that sit beside each kernel wrapper.
"""

__version__ = "0.1.0"


def __getattr__(name):
    import importlib
    if name in ("ops", "modules", "utils", "config"):
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
