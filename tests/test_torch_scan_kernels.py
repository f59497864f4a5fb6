"""The port's SSD scan (K2) and WKV6 (K3) dispatch against the reference on
the CPU.

On CPU tensors ``ops.ssd`` / ``ops.wkv6`` run their plain versions; the
reference runs its Pallas kernels in interpret mode and its sequential
oracles, as ``tests/test_kernels.py`` does, over that file's shape sweeps
and with its tolerances (fp32 1e-4: the two frameworks and the chunked vs
sequential forms sum in different orders; bf16 2e-2).  Inputs come from
numpy with a seed and are handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd as jax_ssd
from repro.kernels.wkv6 import wkv6 as jax_wkv6
from repro_torch.kernels import ops, ref, ssd_scan, wkv6

pytestmark = pytest.mark.torch_port

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)


def _state_tol(dtype):
    # tests/test_kernels.py:84-86: the fp32 final state of bf16 inputs
    return dict(rtol=1e-2, atol=1e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _ssd_inputs(B, S, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), np.float32)
    ld = -np.logaddexp(0.0, rng.standard_normal((B, S, H))).astype(np.float32)
    b = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    return x, ld, b, c


def _wkv_inputs(B, S, H, N, M, decay_scale=1.0, u_rows=0, seed=0):
    rng = np.random.default_rng(seed)
    r, k = ((rng.standard_normal((B, S, H, N)) * 0.5).astype(np.float32)
            for _ in range(2))
    v = (rng.standard_normal((B, S, H, M)) * 0.5).astype(np.float32)
    lw = (-np.exp(rng.standard_normal((B, S, H, N)))
          * decay_scale).astype(np.float32)
    u_shape = (u_rows, H, N) if u_rows else (H, N)
    u = (rng.standard_normal(u_shape) * 0.5).astype(np.float32)
    return r, k, v, lw, u


# ---------------------------------------------------------------------------
# K2: SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,H,P,N,chunk",
    [
        (2, 128, 4, 64, 32, 32),
        (1, 256, 2, 32, 64, 64),
        (2, 64, 8, 64, 16, 16),
        (1, 96, 2, 32, 32, 32),   # chunk divides S=96 after fit (32)
    ])
def test_ssd_matches_pallas_interpret_and_naive(B, S, H, P, N, chunk, dtype):
    jdt, tdt = DTYPES[dtype]
    x, ld, b, c = _ssd_inputs(B, S, H, P, N)
    jin = (jnp.asarray(x, jdt), jnp.asarray(ld), jnp.asarray(b, jdt),
           jnp.asarray(c, jdt))
    y_k, s_k = jax_ssd(*jin, chunk=chunk, interpret=True)
    y_n, s_n = jref.ssd_naive(*jin)
    y, s = ops.ssd(torch.tensor(x).to(tdt), torch.tensor(ld),
                   torch.tensor(b).to(tdt), torch.tensor(c).to(tdt),
                   chunk=chunk)
    assert y.dtype == tdt and tuple(y.shape) == (B, S, H, P)
    assert s.dtype == torch.float32 and tuple(s.shape) == (B, H, P, N)
    _close(y, y_k, **_tol(dtype))
    _close(y, y_n, **_tol(dtype))
    _close(s, s_k, **_state_tol(dtype))
    _close(s, s_n, **_state_tol(dtype))


def test_ssd_chunked_matches_naive():
    x, ld, b, c = (torch.tensor(a) for a in _ssd_inputs(2, 64, 2, 16, 8))
    y_c, s_c = ref.ssd_chunked_ref(x, ld, b, c, chunk=16)
    y_n, s_n = ref.ssd_naive(x, ld, b, c)
    _close(y_c, y_n.numpy(), rtol=2e-5, atol=2e-5)
    _close(s_c, s_n.numpy(), rtol=2e-5, atol=2e-5)


def test_ssd_initial_state_carried():
    """A sequence cut in two through initial_state equals one pass, in the
    port and against the reference's own split."""
    arrs = _ssd_inputs(1, 64, 2, 16, 8)
    x, ld, b, c = (torch.tensor(a) for a in arrs)
    y_full, s_full = ref.ssd_chunked_ref(x, ld, b, c, chunk=16)
    y1, s1 = ops.ssd(x[:, :32], ld[:, :32], b[:, :32], c[:, :32], chunk=16)
    y2, s2 = ops.ssd(x[:, 32:], ld[:, 32:], b[:, 32:], c[:, 32:], chunk=16,
                     initial_state=s1)
    _close(torch.cat([y1, y2], dim=1), y_full.numpy(), rtol=2e-5, atol=2e-5)
    _close(s2, s_full.numpy(), rtol=2e-5, atol=2e-5)
    jx, jld, jb, jc = (jnp.asarray(a[:, 32:]) for a in arrs)
    jy2, js2 = jref.ssd_chunked_ref(jx, jld, jb, jc, chunk=16,
                                    initial_state=jnp.asarray(s1.numpy()))
    _close(y2, jy2, rtol=1e-4, atol=1e-4)
    _close(s2, js2, rtol=1e-4, atol=1e-4)


def test_ssd_segsum_matches_reference():
    a = np.random.default_rng(3).standard_normal((2, 3, 8)).astype(np.float32)
    want = np.asarray(jref._segsum(jnp.asarray(a)))
    got = ref._segsum(torch.tensor(a)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)],
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# K3: WKV6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,H,N,M,chunk,decay_scale",
    [
        (2, 128, 4, 32, 32, 32, 1.0),
        (1, 256, 2, 64, 64, 64, 1.0),
        (2, 64, 4, 32, 32, 16, 8.0),    # aggressive decay: no overflow
        (1, 64, 2, 16, 16, 64, 1.0),    # chunk > S -> fit_chunk
    ])
def test_wkv6_matches_pallas_interpret_and_naive(B, S, H, N, M, chunk,
                                                 decay_scale, dtype):
    jdt, tdt = DTYPES[dtype]
    r, k, v, lw, u = _wkv_inputs(B, S, H, N, M, decay_scale)
    jin = (jnp.asarray(r, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
           jnp.asarray(lw), jnp.asarray(u))
    y_k, s_k = jax_wkv6(*jin, chunk=chunk, interpret=True)
    y_n, s_n = jref.wkv6_naive(*jin)
    y, s = ops.wkv6(*(torch.tensor(a).to(tdt) for a in (r, k, v)),
                    torch.tensor(lw), torch.tensor(u), chunk=chunk)
    assert y.dtype == tdt and tuple(y.shape) == (B, S, H, M)
    assert s.dtype == torch.float32 and tuple(s.shape) == (B, H, N, M)
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    _close(y, y_k, **_tol(dtype))
    _close(y, y_n, **_tol(dtype))
    _close(s, s_k, **_state_tol(dtype))
    _close(s, s_n, **_state_tol(dtype))


def test_wkv6_chunked_matches_naive():
    r, k, v, lw, u = (torch.tensor(a) for a in _wkv_inputs(1, 48, 2, 16, 16))
    y_c, s_c = ref.wkv6_chunked_ref(r, k, v, lw, u, chunk=16)
    y_n, s_n = ref.wkv6_naive(r, k, v, lw, u)
    _close(y_c, y_n.numpy(), rtol=2e-5, atol=2e-5)
    _close(s_c, s_n.numpy(), rtol=2e-5, atol=2e-5)


def test_wkv6_initial_state_carried():
    arrs = _wkv_inputs(1, 64, 2, 16, 16)
    r, k, v, lw, u = (torch.tensor(a) for a in arrs)
    y_full, s_full = ops.wkv6(r, k, v, lw, u)
    y1, s1 = ops.wkv6(r[:, :32], k[:, :32], v[:, :32], lw[:, :32], u)
    y2, s2 = ops.wkv6(r[:, 32:], k[:, 32:], v[:, 32:], lw[:, 32:], u,
                      initial_state=s1)
    _close(torch.cat([y1, y2], dim=1), y_full.numpy(), rtol=2e-5, atol=2e-5)
    _close(s2, s_full.numpy(), rtol=2e-5, atol=2e-5)
    jy2, js2 = jref.wkv6_naive(*(jnp.asarray(a[:, 32:]) for a in arrs[:4]),
                               jnp.asarray(arrs[4]),
                               initial_state=jnp.asarray(s1.numpy()))
    _close(y2, jy2, rtol=1e-4, atol=1e-4)
    _close(s2, js2, rtol=1e-4, atol=1e-4)


def test_wkv6_u_per_client_matches_each_client_and_sums_its_gradient():
    """u (U, H, N): batch rows [i*B/U, (i+1)*B/U) use client i's u, and the
    gradient of u sums back over each client's rows — as JAX's gradient of
    each client's own call."""
    B, U = 4, 2
    r, k, v, lw, u = _wkv_inputs(B, 32, 2, 16, 16, u_rows=U)
    w = np.random.default_rng(5).standard_normal((B, 32, 2, 16)).astype(
        np.float32)
    tu = torch.tensor(u, requires_grad=True)
    y, _ = ops.wkv6(*(torch.tensor(a) for a in (r, k, v, lw)), tu)
    (gu,) = torch.autograd.grad((y * torch.tensor(w)).sum(), [tu])
    rows = B // U
    for i in range(U):
        sl = slice(i * rows, (i + 1) * rows)

        def f(ui, sl=sl):
            yi, _ = jref.wkv6_chunked_ref(
                *(jnp.asarray(a[sl]) for a in (r, k, v, lw)), ui, chunk=16)
            return jnp.sum(yi * jnp.asarray(w[sl]))

        _close(y[sl], jref.wkv6_naive(*(jnp.asarray(a[sl])
                                        for a in (r, k, v, lw)),
                                      jnp.asarray(u[i]))[0],
               rtol=1e-4, atol=1e-4)
        _close(gu[i], jax.grad(f)(jnp.asarray(u[i])), rtol=1e-4, atol=1e-4)


def test_wkv6_effective_chunk_honours_the_request():
    """The CUDA kernel has no minimum chunk: both impls honour the request
    (the reference's Pallas path coerces it up to 64)."""
    assert ops.wkv6_effective_chunk(16, "eager") == 16
    assert ops.wkv6_effective_chunk(16, "cuda") == 16
    assert ops.wkv6_effective_chunk(128) == 128
    with pytest.raises(ValueError):
        ops.wkv6_effective_chunk(16, "pallas")
    r, k, v, lw, u = (torch.tensor(a) for a in _wkv_inputs(1, 64, 2, 8, 8))
    y16, s16 = ops.wkv6(r, k, v, lw, u, chunk=16)
    y64, s64 = ops.wkv6(r, k, v, lw, u, chunk=64)
    _close(y16, y64.numpy(), rtol=2e-5, atol=2e-5)
    _close(s16, s64.numpy(), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------

def test_cuda_impl_on_cpu_tensor_raises():
    x, ld, b, c = (torch.tensor(a) for a in _ssd_inputs(1, 64, 2, 16, 16))
    r, k, v, lw, u = (torch.tensor(a) for a in _wkv_inputs(1, 64, 2, 16, 16))
    before = (ssd_scan.launches, wkv6.launches)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd(x, ld, b, c, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan.ssd(x, ld, b, c)
    with pytest.raises(ValueError, match="CUDA"):
        ops.wkv6(r, k, v, lw, u, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        wkv6.wkv6(r, k, v, lw, u)
    assert (ssd_scan.launches, wkv6.launches) == before
