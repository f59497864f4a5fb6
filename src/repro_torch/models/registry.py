"""Model registry, dense branch (counterpart of ``repro/models/registry.py``).

* ``init_params(cfg, seed, device)``            -> params tree
* ``forward_logits(params, batch, cfg, gates)``  -> logits
* ``loss_fn(params, batch, cfg, gates)``         -> (loss, metrics)
* ``boundary_profile(cfg, seq_len)``            -> split payload profile
* ``count_params_analytical(cfg)``              -> int

The param tree has the reference's keys and its stacked leading layer
axis, so a JAX tree loads leaf for leaf (``checkpoint.convert``).  Every
function also takes params with leading client dims ``lead`` and batches
``lead + (B, S)``; the loss is then one value per leading index.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ArchFamily
from repro_torch.models import common, transformer
from repro_torch.tree import tree_leaves, tree_map

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.family != ArchFamily.DENSE:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense family only; "
            f"{cfg.family.value} is ROADMAP item A.12")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, seed: Optional[int] = 0,
                device="cuda") -> Dict:
    """Random params drawn on the CPU from
    ``torch.Generator().manual_seed(seed)`` and moved to ``device``, so one
    seed gives one model on every device.  ``seed=None`` allocates on
    ``device`` without drawing (used on the meta device to count)."""
    _dense_only(cfg)
    dtype = DTYPES[cfg.param_dtype]
    if seed is None:
        gen, where = None, device
    else:
        gen, where = torch.Generator().manual_seed(seed), "cpu"
    p = transformer.lm_head_init(gen, cfg, dtype, where)
    p["blocks"] = transformer.block_stack_init(gen, cfg, cfg.num_layers,
                                               dtype, where)
    return p if where == device else tree_map(lambda a: a.to(device), p)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward_hidden(params: Dict, batch: Dict, cfg: ArchConfig,
                   gates: Optional[torch.Tensor] = None, *,
                   sliding_window: Optional[int] = None) -> torch.Tensor:
    """Training / prefill forward to final hidden states (pre-head)."""
    _dense_only(cfg)
    x = transformer.embed(params, batch["tokens"], cfg)
    S = x.shape[-2]
    pos = torch.arange(S, device=x.device)[None, :]
    cos, sin = common.rope_cos_sin(pos, cfg.resolved_head_dim,
                                   cfg.rope_theta)
    return transformer.stack_apply(params["blocks"], x, cos, sin, cfg,
                                   gates=gates,
                                   sliding_window=sliding_window)


def forward_logits(params: Dict, batch: Dict, cfg: ArchConfig,
                   gates: Optional[torch.Tensor] = None, *,
                   sliding_window: Optional[int] = None) -> torch.Tensor:
    """Training / prefill forward to logits (dense: no MoE aux term)."""
    h = forward_hidden(params, batch, cfg, gates,
                       sliding_window=sliding_window)
    return transformer.lm_logits(params, h, cfg)


def _ce_terms(logits: torch.Tensor, labels: torch.Tensor, vocab: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum token loss, valid count) over the trailing (B, S) dims;
    labels < 0 masked; padded vocab cut."""
    logits = logits.float()
    if vocab < logits.shape[-1]:
        pad = torch.full(logits.shape[:-1] + (logits.shape[-1] - vocab,),
                         -1e30, dtype=logits.dtype, device=logits.device)
        logits = torch.cat([logits[..., :vocab], pad], dim=-1)
    valid = labels >= 0
    lbl = labels.clamp(min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lbl[..., None])[..., 0]
    return (((logz - gold) * valid).sum(dim=(-2, -1)),
            valid.sum(dim=(-2, -1)))


def loss_fn(params: Dict, batch: Dict, cfg: ArchConfig,
            gates: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Next-token CE (labels < 0 are masked).  The dense family has no
    router, so the reference's ``router_aux_coef * aux`` term is zero."""
    logits = forward_logits(params, batch, cfg, gates)
    tot, cnt = _ce_terms(logits, batch["labels"], cfg.vocab_size)
    denom = cnt.clamp(min=1)
    ce = tot / denom
    return ce, {"ce": ce, "tokens": denom}


# ---------------------------------------------------------------------------
# split-boundary payloads (feeds the latency model's per-cut profiles)
# ---------------------------------------------------------------------------

def boundary_elements(cfg: ArchConfig, cut: int, seq_len: int) -> int:
    """Per-SAMPLE element count of the residual stream crossing the split
    boundary at depth ``cut`` (between block cut-1 and block cut)."""
    if not 1 <= cut <= cfg.num_layers - 1:
        raise ValueError(f"cut {cut} outside [1, {cfg.num_layers - 1}]")
    s_eff = seq_len
    if cfg.family == ArchFamily.VLM:
        s_eff += cfg.frontend_tokens
    if cfg.is_encdec:
        s_eff += cfg.encoder_seq_len
    return s_eff * cfg.d_model


def boundary_profile(cfg: ArchConfig, seq_len: int,
                     ) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """Per-cut (feature, gradient) boundary payloads in BYTES per sample,
    indexed ``cut - 1`` for cuts 1..W-1, both in ``cfg.dtype``'s width."""
    itemsize = DTYPES[cfg.dtype].itemsize
    feat = tuple(float(boundary_elements(cfg, cut, seq_len) * itemsize)
                 for cut in range(1, cfg.num_layers))
    return feat, feat


# ---------------------------------------------------------------------------
# param counting
# ---------------------------------------------------------------------------

def count_params_analytical(cfg: ArchConfig) -> int:
    """Exact param count: the leaves of ``init_params`` built on the meta
    device (shapes only, nothing allocated or drawn)."""
    shapes = init_params(cfg, seed=None, device="meta")
    return sum(math.prod(leaf.shape) for leaf in tree_leaves(shapes))
