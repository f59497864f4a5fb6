"""The port's kernel dispatch against the reference kernels on the CPU.

The port's ``ops.flash_attention`` on CPU tensors runs its plain version;
the reference runs its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` does.  Inputs come from numpy with a seed and are
handed to both packages.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

pytestmark = pytest.mark.torch_port

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    # the tests/test_kernels.py tolerances: bf16 rounds probabilities and
    # products to 8 bits; fp32 differs only in summation order
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)


def _qkv(B, S, Hq, Hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Hq, d), np.float32),
            rng.standard_normal((B, S, Hkv, d), np.float32),
            rng.standard_normal((B, S, Hkv, d), np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,Hq,Hkv,d,causal,window,bq,bk",
    [
        (2, 128, 4, 2, 64, True, 0, 64, 64),
        (1, 256, 4, 4, 64, True, 64, 64, 64),
        (2, 128, 8, 2, 128, False, 0, 64, 64),
        (1, 128, 2, 1, 64, True, 0, 128, 32),
        (2, 64, 4, 4, 32, True, 16, 32, 32),
    ])
def test_dispatch_matches_pallas_interpret(B, S, Hq, Hkv, d, causal, window,
                                           bq, bk, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v = _qkv(B, S, Hq, Hkv, d)
    want = jax_flash(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                     jnp.asarray(v, jdt), causal=causal,
                     sliding_window=window, block_q=bq, block_k=bk,
                     interpret=True)
    got = ops.flash_attention(torch.tensor(q).to(tdt),
                              torch.tensor(k).to(tdt),
                              torch.tensor(v).to(tdt), causal=causal,
                              sliding_window=window)
    assert got.dtype == tdt and tuple(got.shape) == (B, S, Hq, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))


def test_cuda_impl_on_cpu_tensor_raises():
    q, k, v = (torch.tensor(a) for a in _qkv(1, 64, 2, 1, 32))
    before = fa.launches
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v)
    assert fa.launches == before


def test_default_impl_follows_device():
    q = torch.zeros(1, 4, 2, 32)
    assert ops.resolve_impl(q) == "eager"
    assert ops.resolve_impl(q, "eager") == "eager"
    with pytest.raises(ValueError):
        ops.resolve_impl(q, "pallas")
    with pytest.raises(ValueError, match="CUDA"):
        ops.resolve_impl(q, "cuda")


def test_modules_import_without_triton_or_nvcc():
    code = (
        "import os, sys\n"
        "sys.modules['triton'] = None\n"
        "os.environ['PATH'] = ''\n"
        "from repro_torch.kernels import build, flash_attention, ops, ref\n"
        "try:\n"
        "    build.nvcc_path()\n"
        "except RuntimeError:\n"
        "    pass\n"
        "print('ok', flash_attention.launches)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok 0"
