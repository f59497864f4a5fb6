"""zamba2-style hybrid (counterpart of ``repro/models/hybrid.py``, training
path): a Mamba2 backbone and one *shared* attention block.

The shared transformer block (weights reused at every invocation) consumes
``concat([hidden, initial_embedding])`` (2 * d_model), per
arXiv:2411.15242, with a per-invocation output projection.  It runs before
each group of ``shared_attn_every`` mamba layers.

Unlike the reference, whose shared block calls the XLA ``attend``
directly, ``attention.attend`` here goes through the kernel dispatch: on
the card the shared block runs the hand-written K1 kernel.  Its contract
is still ``ref.attention_ref``.

FedPairing: the shared block is crossed by both flows of a pair, so it is a
permanent overlapping layer kept by its data owner (``split_plan`` labels
it ``bottom``); it is always executed.  ``gates`` gate the mamba layers,
the split unit.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import common, mamba2, transformer
from repro_torch.tree import tree_map


# the per-invocation ``out_proj`` takes the place of the shared attention's
# own output projection, which the forward never reads
UNREAD_LEAVES = ("shared/attn/wo",)


def num_invocations(cfg: ArchConfig) -> int:
    return (cfg.num_layers + cfg.shared_attn_every - 1) \
        // cfg.shared_attn_every


def _layer_groups(cfg: ArchConfig) -> List[Tuple[int, int]]:
    """Mamba layer index ranges between shared-block invocations."""
    k = cfg.shared_attn_every
    return [(s, min(s + k, cfg.num_layers))
            for s in range(0, cfg.num_layers, k)]


def shared_block_init(gen: Optional[torch.Generator], cfg: ArchConfig,
                      dtype=torch.float32, device=None) -> Dict:
    d2 = 2 * cfg.d_model
    hd = cfg.resolved_head_dim
    q_out = cfg.num_heads * hd
    return {
        "ln_attn": common.rms_norm_init(None, d2, dtype, device),
        "attn": attn.attn_init(gen, None, d2, cfg.num_heads,
                               cfg.num_kv_heads, hd, False, dtype, device),
        # per-invocation output projections
        "out_proj": common.dense_init(
            gen, (num_invocations(cfg), q_out, cfg.d_model), dtype, device),
        "ln_mlp": common.rms_norm_init(None, d2, dtype, device),
        "mlp": common.swiglu_init(gen, None, d2, cfg.d_ff, dtype, device),
    }


def hybrid_init(gen: Optional[torch.Generator], cfg: ArchConfig,
                dtype=torch.float32, device=None) -> Dict:
    p = transformer.lm_head_init(gen, cfg, dtype, device)
    p["mamba"] = mamba2.mamba_stack_init(gen, cfg, cfg.num_layers, dtype,
                                         device)
    p["shared"] = shared_block_init(gen, cfg, dtype, device)
    # the shared-block MLP's down-projection outputs d_model (its residual
    # is added to x)
    p["shared"]["mlp"]["w_down"] = common.dense_init(
        gen, (cfg.d_ff, cfg.d_model), dtype, device)
    return p


def shared_block_apply(p: Dict, x: torch.Tensor, emb0: torch.Tensor,
                       inv: int, cos: torch.Tensor, sin: torch.Tensor,
                       cfg: ArchConfig, *,
                       sliding_window: Optional[int] = None) -> torch.Tensor:
    """Invocation ``inv`` of the shared block; x and emb0 ``lead + (B, S,
    D)``, params ``lead + (...)``."""
    hd = cfg.resolved_head_dim
    window = sliding_window or 0
    h = common.rms_norm(torch.cat([x, emb0], dim=-1), p["ln_attn"],
                        cfg.norm_eps)
    q, k, v = attn.qkv_project(h, p["attn"], cfg.num_heads, cfg.num_kv_heads,
                               hd)
    q = common.apply_rope(q, cos[..., None, :], sin[..., None, :])
    k = common.apply_rope(k, cos[..., None, :], sin[..., None, :])
    o = attn.attend(q, k, v, causal=True, sliding_window=window)
    x = x + common.linear(o.flatten(-2), p["out_proj"][..., inv, :, :])
    h = common.rms_norm(torch.cat([x, emb0], dim=-1), p["ln_mlp"],
                        cfg.norm_eps)
    mlp = p["mlp"]
    return x + common.swiglu(h, mlp["w_gate"], mlp["w_up"], mlp["w_down"])


def hybrid_forward(params: Dict, tokens: torch.Tensor, cfg: ArchConfig,
                   gates: Optional[torch.Tensor] = None, *,
                   sliding_window: Optional[int] = None,
                   chunk: int = 64) -> torch.Tensor:
    """tokens ``lead + (B, S)`` -> hidden ``lead + (B, S, D)``.  ``gates``
    (W,) or ``lead + (W,)`` gate the mamba layers only."""
    x = transformer.embed(params, tokens, cfg)
    emb0 = x
    pos = torch.arange(tokens.shape[-1], device=x.device)[None, :]
    cos, sin = common.rope_cos_sin(pos, cfg.resolved_head_dim,
                                   cfg.rope_theta)
    lead = x.dim() - 3                      # index of the layer axis
    for inv, (lo, hi) in enumerate(_layer_groups(cfg)):
        x = shared_block_apply(params["shared"], x, emb0, inv, cos, sin,
                               cfg, sliding_window=sliding_window)
        for layer in range(lo, hi):
            p_l = tree_map(lambda a: a.select(lead, layer), params["mamba"])
            g = (torch.ones((), dtype=x.dtype, device=x.device)
                 if gates is None else gates[..., layer])
            x = mamba2.mamba_block_apply(p_l, x, cfg, g, chunk=chunk)
    return x
