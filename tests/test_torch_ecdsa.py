"""The ported slice as a whole: batched ECDSA verify of
``secp256k1_zkp_tpu_torch`` on CPU tensors against the expected mask (built
with Python integers) and against the JAX package's ``ecdsa.verify`` on the
same arrays.

The batch is the mix of tests/test_pallas_tpu.py (valid / flipped signature
byte / flipped message / high-S by lane index) at B = 20, plus lanes with
r = 0, s = 0, s >= n and an infinite public key.  Tolerance: 0 — the
result is a boolean mask and must be equal lane for lane.  The comparison
with the JAX package's own ``verify`` is in the ``slow`` tier (its cold
XLA:CPU compile alone exceeds 90 s); run it with
``pytest tests/test_torch_ecdsa.py -m slow``.

Also here: the state carried across (the JAX package's comb table
converted to the port's layout equals the table the port builds itself),
the import hygiene of the port (neither ``jax`` nor the JAX package is
pulled in), and that asking for the card where there is none raises
instead of running on the CPU.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from secp256k1_zkp_tpu.modules import ecdsa as jecdsa
from secp256k1_zkp_tpu.ops import group as JG
from secp256k1_zkp_tpu.ops import pallas_gen as JGEN
from secp256k1_zkp_tpu.ops.limb import LB as JLB
from secp256k1_zkp_tpu_torch.modules import ecdsa
from secp256k1_zkp_tpu_torch.ops import _build
from secp256k1_zkp_tpu_torch.ops import cuda_gen
from secp256k1_zkp_tpu_torch.ops import group as TGRP
from secp256k1_zkp_tpu_torch.utils import convert
from secp256k1_zkp_tpu_torch.utils import hostcurve as hc

B_MIX = 20
N = hc.N


def _sign(rng):
    d = int.from_bytes(rng.bytes(32), "big") % N or 1
    k = int.from_bytes(rng.bytes(32), "big") % N or 1
    msg = rng.bytes(32)
    m = int.from_bytes(msg, "big") % N
    r = hc.mul(k)[0] % N
    s = pow(k, -1, N) * (m + r * d) % N
    if s > N // 2:
        s = N - s
    return msg, r, s, hc.mul(d)


@pytest.fixture(scope="module")
def batch():
    """(msgs, sigs, key x limbs, key y limbs, key inf, expected mask)."""
    rng = np.random.default_rng(40)
    rows = []
    for i in range(B_MIX + 4):
        msg, r, s, pub = _sign(rng)
        sig = bytearray(r.to_bytes(32, "big") + s.to_bytes(32, "big"))
        good, inf = True, False
        if i < B_MIX:
            if i % 5 == 1:
                sig[40] ^= 1
                good = False
            elif i % 5 == 2:
                msg = bytes([msg[0] ^ 0x80]) + msg[1:]
                good = False
            elif i % 5 == 3:                      # high-S rejection
                sig[32:] = (N - s).to_bytes(32, "big")
                good = False
        elif i == B_MIX:
            sig[:32] = bytes(32)                  # r = 0
            good = False
        elif i == B_MIX + 1:
            sig[32:] = bytes(32)                  # s = 0
            good = False
        elif i == B_MIX + 2:
            sig[32:] = (N + 5).to_bytes(32, "big")   # s >= n
            good = False
        else:
            inf, good = True, False               # P at infinity
        rows.append((msg, bytes(sig), pub, inf, good))
    msgs = np.array([list(r[0]) for r in rows], np.uint8)
    sigs = np.array([list(r[1]) for r in rows], np.uint8)
    px = np.array([[(r[2][0] >> (16 * l)) & 0xFFFF for l in range(16)]
                   for r in rows], np.uint32)
    py = np.array([[(r[2][1] >> (16 * l)) & 0xFFFF for l in range(16)]
                   for r in rows], np.uint32)
    inf = np.array([r[3] for r in rows], bool)
    expect = np.array([r[4] for r in rows], bool)
    assert expect.sum() == 8
    return msgs, sigs, px, py, inf, expect


@pytest.fixture(scope="module")
def port_mask(batch):
    msgs, sigs, px, py, inf, _ = batch
    pub = convert.ge_from_jax_limbs(px, py, inf)
    before = dict(_build.LAUNCH_COUNTS)
    ok = ecdsa.verify(torch.from_numpy(msgs), torch.from_numpy(sigs), pub,
                      device="cpu")
    assert _build.LAUNCH_COUNTS == before          # CPU: plain versions
    assert ok.dtype == torch.bool and ok.shape == (len(msgs),)
    assert ok.device.type == "cpu"
    return ok.numpy()


def test_verify_matches_expected_mask(batch, port_mask):
    assert port_mask.tolist() == batch[5].tolist()


@pytest.mark.slow
def test_verify_matches_jax_package(batch, port_mask):
    """The JAX package's portable ``ecdsa.verify`` compiles its scan
    programs on first use: 113 s on 8 lanes with a cold compilation cache
    on the CPU (97 s with the compile-small window), hence the slow tier.
    The tier-1 comparison is the expected mask above; the kernels' own
    dataflow is held against the JAX kernel bodies in
    test_torch_kernels.py."""
    msgs, sigs, px, py, inf, expect = batch
    pub = JG.GE(JLB(jnp.asarray(px), 0xFFFF), JLB(jnp.asarray(py), 0xFFFF),
                jnp.asarray(inf))
    want = np.asarray(jecdsa.verify(jnp.asarray(msgs), jnp.asarray(sigs), pub))
    assert want.tolist() == expect.tolist()
    assert port_mask.tolist() == want.tolist()


def test_verify_accepts_numpy_and_single_lane(batch):
    msgs, sigs, px, py, inf, expect = batch
    pub = convert.ge_from_jax_limbs(px[:1], py[:1], inf[:1])
    ok = ecdsa.verify(msgs[:1], sigs[:1], pub, device="cpu")
    assert ok.tolist() == expect[:1].tolist()


def test_sig_parse_compact(batch):
    _, sigs, *_ = batch
    r, s, ok = ecdsa.sig_parse_compact(torch.from_numpy(sigs))
    jr, js, jok = jecdsa.sig_parse_compact(jnp.asarray(sigs))
    assert r.v.tolist() == np.asarray(jr.v).tolist()
    assert s.v.tolist() == np.asarray(js.v).tolist()
    assert ok.tolist() == np.asarray(jok).tolist()
    assert not ok[B_MIX + 2] and ok[:B_MIX].all()


def test_verify_on_cuda_raises_without_a_card(batch):
    """The default device is the card; with none present the entry point
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    msgs, sigs, px, py, inf, _ = batch
    pub = convert.ge_from_jax_limbs(px, py, inf)
    with pytest.raises(RuntimeError, match="cuda"):
        ecdsa.verify(torch.from_numpy(msgs), torch.from_numpy(sigs), pub)
    with pytest.raises(RuntimeError, match="cuda"):
        ecdsa.verify(torch.from_numpy(msgs), torch.from_numpy(sigs), pub,
                     device="cuda")


def test_converted_tables_and_containers(batch):
    conv = convert.comb_table_from_jax(JGEN._comb_tables_np())
    assert torch.equal(conv, cuda_gen.comb_tables())
    _, _, px, py, inf, _ = batch
    ge = convert.ge_from_jax_limbs(px, py, inf)
    assert isinstance(ge, TGRP.GE) and ge.x.v.dtype == torch.int64
    assert ge.x.v.tolist() == px.astype(np.int64).tolist()
    assert ge.inf.tolist() == inf.tolist()
    on = TGRP.ge_is_on_curve(ge)
    jon = JG.ge_is_on_curve(JG.GE(JLB(jnp.asarray(px), 0xFFFF),
                                  JLB(jnp.asarray(py), 0xFFFF),
                                  jnp.asarray(inf)))
    assert on.tolist() == np.asarray(jon).tolist() and on.all()
    g = TGRP.generator((3,))
    assert TGRP.ge_is_on_curve(g).all() and g.x.v.shape == (3, 16)
    lb = convert.lb_from_numpy(px[0])
    assert lb.bound == 0xFFFF and lb.v.tolist() == px[0].tolist()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import torch\n"
        "import secp256k1_zkp_tpu_torch as t\n"
        "from secp256k1_zkp_tpu_torch import context, config\n"
        "from secp256k1_zkp_tpu_torch.modules import (ecdsa, generator,\n"
        "    recovery, schnorrsig)\n"
        "from secp256k1_zkp_tpu_torch.ops import (_build, cuda_divsteps,\n"
        "    cuda_field, cuda_gen, cuda_group, cuda_msm, cuda_scalar,\n"
        "    cuda_sha256, field, group, limb, msm, scalar, sha256)\n"
        "from secp256k1_zkp_tpu_torch.utils import (convert, hostcurve,\n"
        "    sha256_host)\n"
        "context.selftest('cpu')\n"
        "ctx = context.Context('cpu').randomize(bytes(32))\n"
        "assert ctx.blind is not None and context.default_context('cpu')\n"
        "for fn in (ecdsa.sign, ecdsa.rfc6979_nonce, schnorrsig.sign,\n"
        "           schnorrsig.keypair_xonly, cuda_gen.ecmult_gen,\n"
        "           cuda_gen.ecdsa_sign_finish, cuda_gen.affine_xy,\n"
        "           cuda_gen.muladd_n, sha256.hmac_sha256, sha256.RFC6979,\n"
        "           convert.blind_from_jax, schnorrsig.batch_verify,\n"
        "           msm.ecmult_multi, cuda_msm.msm_windowed,\n"
        "           cuda_group.gej_add, group.gej_eq, ecdsa.recover,\n"
        "           recovery.recover, generator.generator_generate,\n"
        "           generator.pedersen_commit_bytes, cuda_field.affine_meta,\n"
        "           cuda_scalar.inv_n, scalar.inv, msm._tree_reduce):\n"
        "    assert callable(fn)\n"
        "pt = group.generator((1,))\n"
        "r = msm.ecmult_multi(limb.LB(torch.tensor([[2] + [0] * 15]),\n"
        "                             0xFFFF), pt, device='cpu')\n"
        "assert group.gej_eq(r, group.gej_add(\n"
        "    *[group.GEJ(pt.x, pt.y, field.FP.one((1,)), pt.inf)] * 2))\n"
        "h, ok = generator.generator_generate(torch.zeros((1, 32),\n"
        "    dtype=torch.uint8), device='cpu')\n"
        "c, cok = generator.pedersen_commit_bytes(torch.ones((1, 32),\n"
        "    dtype=torch.uint8), [0], [5], h, device='cpu')\n"
        "assert bool(ok[0] & cok[0]) and int(c[0, 0]) in (8, 9)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'jaxlib' or m == 'secp256k1_zkp_tpu'\n"
        "       or m.startswith('secp256k1_zkp_tpu.') or m == 'triton']\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(_build.SRC_DIR.parent.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
