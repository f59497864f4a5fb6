"""Shared model building blocks (counterpart of ``repro/models/common.py``).

Conventions
-----------
* Parameters are nested dicts of tensors.  Per-block parameters are
  STACKED along a leading ``num_layers`` axis, as in the reference.
* Linear weights are stored ``(d_in, d_out)``; ``y = x @ W``.
* ``dtype`` is the compute/activation dtype; parameters are kept in
  ``param_dtype`` (fp32) and cast at use.
* Leading dims: a parameter may carry leading dims ``lead`` (the client
  axis of the fed step) that prefix the activation's own, e.g. a weight
  ``lead + (d_in, d_out)`` against ``x`` of ``lead + (B, S, d_in)``.  With
  ``lead == ()`` every function is the reference's one-model form.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# init helpers (torch.Generator draws, not the reference's jax.random bits;
# ``gen=None`` allocates without drawing, e.g. on the meta device to count)
# ---------------------------------------------------------------------------

def dense_init(gen: Optional[torch.Generator], shape: Tuple[int, ...],
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init over ``shape = (..., d_in, d_out)``,
    scaled llama-style by 1/sqrt(d_in)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (w / math.sqrt(shape[-2])).to(dtype)


def trunc_normal_init(gen: Optional[torch.Generator], shape: Tuple[int, ...],
                      scale: float, dtype=torch.float32, device=None
                      ) -> torch.Tensor:
    """Truncated normal on [-3, 3] times ``scale``."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (w * scale).to(dtype)


def normal_init(gen: Optional[torch.Generator], shape: Tuple[int, ...],
                scale: float, dtype=torch.float32, device=None
                ) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, device=device)
    return (w * scale).to(dtype)


def uniform_init(gen: Optional[torch.Generator], shape: Tuple[int, ...],
                 low: float, high: float, dtype=torch.float32, device=None
                 ) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.rand(shape, generator=gen, device=device)
    return (w * (high - low) + low).to(dtype)


def embed_init(gen: Optional[torch.Generator], vocab: int, d_model: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    if gen is None:
        return torch.empty((vocab, d_model), dtype=dtype, device=device)
    w = torch.randn((vocab, d_model), generator=gen, device=device)
    return (w * 0.02).to(dtype)


def rms_norm_init(n: Optional[int], d: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    shape = (d,) if n is None else (n, d)
    return torch.ones(shape, dtype=dtype, device=device)


def swiglu_init(gen: Optional[torch.Generator], n: Optional[int],
                d_model: int, d_ff: int, dtype=torch.float32, device=None
                ) -> dict:
    lead = () if n is None else (n,)
    return {
        "w_gate": dense_init(gen, lead + (d_model, d_ff), dtype, device),
        "w_up": dense_init(gen, lead + (d_model, d_ff), dtype, device),
        "w_down": dense_init(gen, lead + (d_ff, d_model), dtype, device),
    }


# ---------------------------------------------------------------------------
# linear algebra with leading dims
# ---------------------------------------------------------------------------

def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` cast to ``x``'s dtype.  ``w`` is
    ``lead + (d_in, d_out)`` and ``x`` is ``lead + mid + (d_in,)``: one
    (batched) matrix product over the flattened ``mid``."""
    lead = w.shape[:-2]
    d_in, d_out = w.shape[-2:]
    x2 = x.reshape(lead + (-1, d_in))
    return torch.matmul(x2, w.to(x.dtype)).reshape(x.shape[:-1] + (d_out,))


def lead_broadcast(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A ``lead + (d,)`` vector shaped to broadcast against
    ``x = lead + mid + (d,)``."""
    return p.reshape(p.shape[:-1] + (1,) * (x.dim() - p.dim())
                     + p.shape[-1:])


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32 accumulation, cast back to input dtype."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * lead_broadcast(gamma, x).float()).to(dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), fp32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer positions ``(..., S)`` ->
    ``(..., S, head_dim//2)``, built in fp32."""
    inv = rope_frequencies(head_dim, theta, positions.device)
    angles = positions.float()[..., None] * inv
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Apply rotary embedding (paired-halves convention, llama).

    ``x``: (..., S, H, D); ``cos``/``sin``: broadcastable to
    (..., S, 1, D/2), cast to ``x``'s dtype before the multiply."""
    d_half = x.shape[-1] // 2
    x1, x2 = x[..., :d_half], x[..., d_half:]
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# feed-forward
# ---------------------------------------------------------------------------

def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x@gate) * (x@up) )."""
    g = linear(x, w_gate)
    u = linear(x, w_up)
    return linear(F.silu(g) * u, w_down)
