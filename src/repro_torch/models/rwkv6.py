"""RWKV6 ("Finch") block (counterpart of ``repro/models/rwkv6.py``,
training path).

Attention-free, with a data-dependent decay (arXiv:2404.05892): token shift
with LoRA-interpolated mixing coefficients (5-way: w, k, v, r, g), decay
``w = exp(-exp(w0 + tanh(x W1) W2))``, the per-head WKV recurrence with
bonus ``u`` (through ``ops.wkv6``: on the card, the hand-written K3
kernel), per-head group norm and a gated output; then a squared-ReLU
channel mix.

Parameters may carry leading client dims ``lead`` in front of their own
shape, with activations ``lead + (B, S, D)``; see ``common``.  The WKV
call folds ``lead + (B,)`` into its batch and reads ``u`` per client.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import common

LORA_MIX = 32     # TIME_MIX_EXTRA_DIM
LORA_DECAY = 64   # TIME_DECAY_EXTRA_DIM


def dims(cfg: ArchConfig) -> Dict[str, int]:
    D = cfg.d_model
    return {"D": D, "H": D // cfg.rwkv_head_dim, "N": cfg.rwkv_head_dim}


def rwkv_stack_init(gen: Optional[torch.Generator], cfg: ArchConfig, n: int,
                    dtype=torch.float32, device=None) -> Dict:
    """Params for ``n`` stacked blocks (the reference's tree and shapes)."""
    d = dims(cfg)
    D, H, N = d["D"], d["H"], d["N"]
    sD = 1.0 / math.sqrt(D)

    def tn(shape, scale):
        return common.trunc_normal_init(gen, shape, scale, dtype, device)

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "ln1": common.rms_norm_init(n, D, dtype, device),
        "ln2": common.rms_norm_init(n, D, dtype, device),
        # token-shift mixing: base coefficients + LoRA producing 5 deltas
        "mu_base": common.uniform_init(gen, (n, 5, D), 0.25, 0.75, dtype,
                                       device),
        "mu_x": common.uniform_init(gen, (n, D), 0.25, 0.75, dtype, device),
        "mix_w1": tn((n, D, 5 * LORA_MIX), sD),
        "mix_w2": tn((n, 5, LORA_MIX, D), 1.0 / math.sqrt(LORA_MIX)),
        # data-dependent decay
        "w0": const((n, D), -2.0),     # exp(-exp(-2)) ~ 0.87 base decay
        "decay_w1": tn((n, D, LORA_DECAY), sD),
        "decay_w2": tn((n, LORA_DECAY, D), 1.0 / math.sqrt(LORA_DECAY)),
        # projections
        "w_r": tn((n, D, D), sD),
        "w_k": tn((n, D, D), sD),
        "w_v": tn((n, D, D), sD),
        "w_g": tn((n, D, D), sD),
        "w_o": tn((n, D, D), sD),
        "u": tn((n, H, N), 1.0),
        "gn_gamma": const((n, D), 1.0),
        # channel mix
        "cm": _channel_mix_init(gen, cfg, n, dtype, device),
    }


def _channel_mix_init(gen: Optional[torch.Generator], cfg: ArchConfig,
                      n: int, dtype, device) -> Dict:
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "mu_k": torch.full((n, D), 0.5, dtype=dtype, device=device),
        "mu_r": torch.full((n, D), 0.5, dtype=dtype, device=device),
        "w_k": common.trunc_normal_init(gen, (n, D, Fd), 1.0 / math.sqrt(D),
                                        dtype, device),
        "w_v": common.trunc_normal_init(gen, (n, Fd, D), 1.0 / math.sqrt(Fd),
                                        dtype, device),
        "w_r": common.trunc_normal_init(gen, (n, D, D), 1.0 / math.sqrt(D),
                                        dtype, device),
    }


def _token_shift(x: torch.Tensor) -> torch.Tensor:
    """Shift the sequence (dim -2) right by one; zeros fill position 0
    (a fresh state: the decode paths that carry it are ROADMAP A.13)."""
    return torch.cat([torch.zeros_like(x[..., :1, :]), x[..., :-1, :]],
                     dim=-2)


def _group_norm(y: torch.Tensor, gamma: torch.Tensor, H: int, N: int,
                eps: float) -> torch.Tensor:
    """Per-head normalization over the head channel dim (population
    variance, as ``jnp.var``)."""
    yh = y.reshape(y.shape[:-1] + (H, N)).float()
    mean = yh.mean(dim=-1, keepdim=True)
    var = yh.var(dim=-1, keepdim=True, correction=0)
    yh = (yh - mean) * torch.rsqrt(var + eps)
    return (yh.reshape(y.shape)
            * common.lead_broadcast(gamma, y).float()).to(y.dtype)


def _mix_deltas(lora: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """``einsum("bsfe,fed->bsfd")`` with leading dims: lora
    ``lead + (B, S, 5, E)``, w2 ``lead + (5, E, D)`` -> ``lead + (B, S, 5,
    D)``, one batched product over ``lead + (5,)``."""
    lead = w2.shape[:-3]
    f, e, d = w2.shape[-3:]
    l2 = lora.reshape(lead + (-1, f, e)).transpose(-3, -2)   # lead+(5,BS,E)
    out = torch.matmul(l2, w2.to(lora.dtype))                # lead+(5,BS,D)
    return out.transpose(-3, -2).reshape(lora.shape[:-1] + (d,))


def time_mix(p_l: Dict, x: torch.Tensor, cfg: ArchConfig, *,
             chunk: int = 16
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """WKV6 time mix from a fresh state.  x ``lead + (B, S, D)``.  Returns
    (out, new shift ``lead + (B, 1, D)``, final WKV state
    ``(prod(lead) * B, H, N, N)``), as the reference does."""
    d = dims(cfg)
    H, N = d["H"], d["N"]
    S = x.shape[-2]
    dtype = x.dtype

    xx = _token_shift(x) - x
    xxx = x + xx * common.lead_broadcast(p_l["mu_x"], x).to(dtype)
    lora = torch.tanh(common.linear(xxx, p_l["mix_w1"]))
    lora = lora.reshape(x.shape[:-1] + (5, LORA_MIX))
    deltas = _mix_deltas(lora, p_l["mix_w2"])                # lead+(B,S,5,D)
    mu_base = p_l["mu_base"].to(dtype)
    mu_base = mu_base.reshape(mu_base.shape[:-2] + (1, 1) + mu_base.shape[-2:])
    mixed = x[..., None, :] + xx[..., None, :] * (mu_base + deltas)
    xw, xk, xv, xr, xg = mixed.unbind(dim=-2)

    # data-dependent decay (fp32, <= 0 by construction)
    dd = common.linear(torch.tanh(common.linear(xw, p_l["decay_w1"])),
                       p_l["decay_w2"])
    log_w = -torch.exp(common.lead_broadcast(p_l["w0"], x).float()
                       + dd.float())

    r = common.linear(xr, p_l["w_r"])
    k = common.linear(xk, p_l["w_k"])
    v = common.linear(xv, p_l["w_v"])
    g = common.linear(xg, p_l["w_g"])

    def heads(t):                       # lead+(B,S,D) -> (-1,S,H,N)
        return t.reshape(-1, S, H, N).contiguous()

    y, final_state = ops.wkv6(heads(r), heads(k), heads(v), heads(log_w),
                              p_l["u"].reshape(-1, H, N).contiguous(),
                              chunk=chunk)
    y = _group_norm(y.reshape(x.shape), p_l["gn_gamma"], H, N, cfg.norm_eps)
    out = common.linear(y * F.silu(g), p_l["w_o"])
    return out, x[..., -1:, :], final_state


def channel_mix(p_l: Dict, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared-ReLU channel mix from a fresh state.  Returns (out, new
    shift)."""
    dtype = x.dtype
    xx = _token_shift(x) - x
    xk = x + xx * common.lead_broadcast(p_l["mu_k"], x).to(dtype)
    xr = x + xx * common.lead_broadcast(p_l["mu_r"], x).to(dtype)
    k = torch.square(F.relu(common.linear(xk, p_l["w_k"])))
    kv = common.linear(k, p_l["w_v"])
    rg = torch.sigmoid(common.linear(xr, p_l["w_r"]))
    return rg * kv, x[..., -1:, :]


def rwkv_block_apply(p_l: Dict, x: torch.Tensor, cfg: ArchConfig,
                     gate: torch.Tensor, *, chunk: int = 16) -> torch.Tensor:
    """Full-sequence RWKV6 block (fresh state) with residual gating.
    ``gate``: a scalar, or ``lead`` per-client gates."""
    gate = torch.as_tensor(gate, device=x.device).to(x.dtype)
    gate = gate.reshape(gate.shape + (1, 1, 1))
    h = common.rms_norm(x, p_l["ln1"], cfg.norm_eps)
    tm, _, _ = time_mix(p_l, h, cfg, chunk=chunk)
    x = x + gate * tm
    h = common.rms_norm(x, p_l["ln2"], cfg.norm_eps)
    cm, _ = channel_mix(p_l["cm"], h)
    return x + gate * cm
