"""Dense transformer block stack (counterpart of
``repro/models/transformer.py``, dense family, training / prefill path).

Blocks are stacked along a leading layer axis, as in the reference; the
stack runs as a Python loop over that axis (the reference scans it).
Every block honours a per-layer ``gate`` in [0, 1]: the FedPairing
logical split multiplies each residual delta by the gate, so ``gate=0``
turns the layer into identity.

Parameters may carry leading client dims ``lead`` in front of the layer
axis (``lead + (W, ...)``), with activations ``lead + (B, S, D)``; see
``common``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, AttentionKind
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.tree import tree_map


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def block_stack_init(gen: Optional[torch.Generator], cfg: ArchConfig, n: int,
                     dtype=torch.float32, device=None) -> Dict:
    """Params for ``n`` stacked blocks: norms + attention + SwiGLU FFN."""
    hd = cfg.resolved_head_dim
    return {
        "ln_attn": common.rms_norm_init(n, cfg.d_model, dtype, device),
        "ln_mlp": common.rms_norm_init(n, cfg.d_model, dtype, device),
        "attn": attn.attn_init(gen, n, cfg.d_model, cfg.num_heads,
                               cfg.num_kv_heads, hd, cfg.qkv_bias, dtype,
                               device),
        "mlp": common.swiglu_init(gen, n, cfg.d_model, cfg.d_ff, dtype,
                                  device),
    }


def lm_head_init(gen: Optional[torch.Generator], cfg: ArchConfig,
                 dtype=torch.float32, device=None) -> Dict:
    p = {
        "embed": common.embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                                   device),
        "ln_f": common.rms_norm_init(None, cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = common.dense_init(
            gen, (cfg.d_model, cfg.padded_vocab), dtype, device)
    return p


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------

def _window(cfg: ArchConfig, sliding_window: Optional[int]) -> int:
    if sliding_window is not None:
        return sliding_window                   # explicit override
    if cfg.attention == AttentionKind.SLIDING:
        return cfg.sliding_window
    return 0


def block_apply(p_l: Dict, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, cfg: ArchConfig, gate: torch.Tensor, *,
                causal: bool = True, sliding_window: Optional[int] = None
                ) -> torch.Tensor:
    """One block.  ``gate``: a scalar, or ``lead`` per-client gates."""
    hd = cfg.resolved_head_dim
    window = _window(cfg, sliding_window)
    gate = torch.as_tensor(gate, device=x.device).to(x.dtype)
    gate = gate.reshape(gate.shape + (1, 1, 1))

    h = common.rms_norm(x, p_l["ln_attn"], cfg.norm_eps)
    q, k, v = attn.qkv_project(h, p_l["attn"], cfg.num_heads,
                               cfg.num_kv_heads, hd)
    q = common.apply_rope(q, cos[..., None, :], sin[..., None, :])
    k = common.apply_rope(k, cos[..., None, :], sin[..., None, :])
    o = attn.attend(q, k, v, causal=causal, sliding_window=window)
    x = x + gate * attn.output_project(o, p_l["attn"])

    h = common.rms_norm(x, p_l["ln_mlp"], cfg.norm_eps)
    mlp = p_l["mlp"]
    return x + gate * common.swiglu(h, mlp["w_gate"], mlp["w_up"],
                                    mlp["w_down"])


def stack_apply(params: Dict, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, cfg: ArchConfig,
                gates: Optional[torch.Tensor] = None, *,
                causal: bool = True, sliding_window: Optional[int] = None
                ) -> torch.Tensor:
    """Run the stacked blocks in order.  ``gates``: (W,) or ``lead + (W,)``
    per-layer gates (default all ones)."""
    lead = x.dim() - 3                      # index of the layer axis
    n = params["ln_attn"].shape[lead]
    for layer in range(n):
        p_l = tree_map(lambda a: a.select(lead, layer), params)
        g = (torch.ones((), dtype=x.dtype, device=x.device) if gates is None
             else gates[..., layer])
        x = block_apply(p_l, x, cos, sin, cfg, g, causal=causal,
                        sliding_window=sliding_window)
    return x


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------

def embed(params: Dict, tokens: torch.Tensor, cfg: ArchConfig,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """tokens ``lead + (B, S)`` -> ``lead + (B, S, D)`` from a
    ``lead + (V, D)`` table cast to the compute dtype."""
    dtype = dtype or getattr(torch, cfg.dtype)
    table = params["embed"].to(dtype)
    lead = table.shape[:-2]
    flat = table.reshape((-1,) + table.shape[-2:])
    idx = tokens.long().reshape((flat.shape[0],) + tokens.shape[len(lead):])
    rows = torch.arange(flat.shape[0], device=tokens.device)
    rows = rows.reshape((-1,) + (1,) * (idx.dim() - 1))
    out = flat[rows, idx]
    return out.reshape(tokens.shape + (table.shape[-1],))


def lm_logits(params: Dict, x: torch.Tensor, cfg: ArchConfig
              ) -> torch.Tensor:
    h = common.rms_norm(x, params["ln_f"], cfg.norm_eps)
    w = (params["embed"].transpose(-1, -2) if cfg.tie_embeddings
         else params["unembed"])
    return common.linear(h, w)
