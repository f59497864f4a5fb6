"""Grouped-query attention with RoPE (counterpart of
``repro/models/attention.py``, training / prefill path).

GQA is kept grouped throughout: the KV heads are never repeated.  Unlike
the reference model, whose blocks call the XLA ``attend`` directly,
``attend`` here goes through the kernel dispatch ``ops.flash_attention``:
on the card every block runs the hand-written K1 kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models import common


def attn_init(gen: Optional[torch.Generator], n: Optional[int], d_model: int,
              num_heads: int, num_kv_heads: int, head_dim: int,
              qkv_bias: bool = False, dtype=torch.float32, device=None
              ) -> Dict[str, torch.Tensor]:
    """Per-layer (or ``n``-stacked) attention projection params."""
    q_out, kv_out = num_heads * head_dim, num_kv_heads * head_dim
    lead = () if n is None else (n,)
    p = {
        "wq": common.dense_init(gen, lead + (d_model, q_out), dtype, device),
        "wk": common.dense_init(gen, lead + (d_model, kv_out), dtype, device),
        "wv": common.dense_init(gen, lead + (d_model, kv_out), dtype, device),
        "wo": common.dense_init(gen, lead + (q_out, d_model), dtype, device),
    }
    if qkv_bias:
        for name, width in (("bq", q_out), ("bk", kv_out), ("bv", kv_out)):
            p[name] = torch.zeros(lead + (width,), dtype=dtype, device=device)
    return p


def qkv_project(x: torch.Tensor, p: Dict[str, torch.Tensor], num_heads: int,
                num_kv_heads: int, head_dim: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., B,S,D) -> q (..., B,S,Hq,d), k/v (..., B,S,Hkv,d)."""
    q = common.linear(x, p["wq"])
    k = common.linear(x, p["wk"])
    v = common.linear(x, p["wv"])
    if "bq" in p:
        q = q + common.lead_broadcast(p["bq"], q).to(x.dtype)
        k = k + common.lead_broadcast(p["bk"], k).to(x.dtype)
        v = v + common.lead_broadcast(p["bv"], v).to(x.dtype)
    lead = x.shape[:-1]
    return (q.reshape(lead + (num_heads, head_dim)),
            k.reshape(lead + (num_kv_heads, head_dim)),
            v.reshape(lead + (num_kv_heads, head_dim)))


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, sliding_window: int = 0) -> torch.Tensor:
    """Full-sequence attention.  q (..., B,S,Hq,d), k/v (..., B,L,Hkv,d) ->
    (..., B,S,Hq,d); leading dims fold into the kernel's batch."""
    S, Hq, d = q.shape[-3:]
    L, Hkv = k.shape[-3], k.shape[-2]
    out = ops.flash_attention(q.reshape(-1, S, Hq, d).contiguous(),
                              k.reshape(-1, L, Hkv, d).contiguous(),
                              v.reshape(-1, L, Hkv, d).contiguous(),
                              causal=causal, sliding_window=sliding_window)
    return out.reshape(q.shape)


def output_project(o: torch.Tensor, p: Dict[str, torch.Tensor]
                   ) -> torch.Tensor:
    """(..., B,S,Hq,d) -> (..., B,S,D)."""
    return common.linear(o.flatten(-2), p["wo"])
