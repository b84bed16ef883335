"""secp256k1_zkp_tpu_torch — the PyTorch/CUDA port of secp256k1_zkp_tpu.

Same layout as the JAX package so a reader finds the counterpart of each
file; PyTorch idiom inside: plain functions on tensors, small dataclasses
of tensors (``LB``/``GE``/``GEJ``), an explicit device everywhere.

======================  ====================================================
``ops.limb``            batched base-2^16 modular bignum engine (int64 limbs),
                        fixed-window powers
``ops.field``           GF(p) instance: ``sqrt``, ``is_square``, ``inv``
``ops.scalar``          GF(n) instance: ``inv`` (the ``inv_n`` kernel)
``ops.group``           point containers (``GE``/``GEJ``), ``gej_add``(``_ge``),
                        ``gej_eq``, ``ge_from_gej``
``ops.msm``             ``ecmult_multi`` and the lane sum ``_tree_reduce``
``ops.sha256``          SHA-256, HMAC, RFC6979 and BIP-340 tagged hashes
``ops.cuda_sha256``     the SHA-256 kernels: blocks, messages, RFC6979 and
                        the batch digest
``ops.cuda_field``      mod-p library + ``mulmod_chain``, ``lift_x``,
                        ``schnorr_check``, ``affine_meta``
``ops.cuda_divsteps``   safegcd modular inverse, plain version
``ops.cuda_scalar``     mod-n library + the ECDSA *prep*, GLV-split and
                        ``inv_n`` kernels
``ops.cuda_group``      complete group formulas + GLV Strauss, ``gej_add``,
                        ``gej_sum``
``ops.cuda_gen``        fixed-base comb + the sign epilogue kernels
``ops.cuda_msm``        the fused windowed-table MSM engine
``modules.ecdsa``       batched ECDSA verify, sign, recover
``modules.recovery``    recoverable signatures (65-byte form)
``modules.schnorrsig``  batched BIP-340 ``lift_x``, verify, sign, batch verify
``modules.generator``   NUMS generators, Pedersen commitments, tally
``context``             selftest, generator blinding
``utils.hostcurve``     Python-int curve for table generation
``utils.sha256_host``   host SHA-256 compression for tag midstates
``utils.convert``       tables and containers of the JAX package -> port
``csrc/``               the CUDA C++ sources of the kernels
======================  ====================================================

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
