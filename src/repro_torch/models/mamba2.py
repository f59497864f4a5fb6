"""Mamba2 (SSD) block (counterpart of ``repro/models/mamba2.py``, training
path), used inside the zamba2 hybrid.

In-projections to z, x, B, C and dt (kept separate, as the reference keeps
them), a causal depthwise conv, the SSD scan over heads with a scalar decay
per head (through ``ops.ssd``: on the card, the hand-written K2 kernel),
a gated RMSNorm and the out-projection.

Parameters may carry leading client dims ``lead`` in front of their own
shape, with activations ``lead + (B, S, D)``; see ``common``.  The scan
folds ``lead + (B,)`` into its batch.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import common


def dims(cfg: ArchConfig) -> Dict[str, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    return {"d_inner": d_inner, "n_heads": d_inner // cfg.ssm_head_dim}


def mamba_stack_init(gen: Optional[torch.Generator], cfg: ArchConfig, n: int,
                     dtype=torch.float32, device=None) -> Dict:
    """Params for ``n`` stacked blocks (the reference's tree and shapes)."""
    d = dims(cfg)
    D = cfg.d_model
    di, H, N, W = d["d_inner"], d["n_heads"], cfg.ssm_state, \
        cfg.ssm_conv_width
    if gen is None:
        dt_bias = torch.empty((n, H), dtype=dtype, device=device)
        a_log = torch.empty((n, H), dtype=dtype, device=device)
    else:
        dt = torch.exp(common.uniform_init(gen, (n, H), math.log(1e-3),
                                           math.log(1e-1), device=device))
        dt_bias = (dt + torch.log(-torch.expm1(-dt))).to(dtype)  # inv softplus
        a_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                       device=device)).repeat(n, 1).to(dtype)
    conv_scale = 1.0 / math.sqrt(W)

    def dense(d_in, d_out):
        return common.dense_init(gen, (n, d_in, d_out), dtype, device)

    def conv(width):
        return common.normal_init(gen, (n, W, width), conv_scale, dtype,
                                  device)

    def zeros(width):
        return torch.zeros((n, width), dtype=dtype, device=device)

    return {
        "ln": common.rms_norm_init(n, D, dtype, device),
        "w_z": dense(D, di),
        "w_x": dense(D, di),
        "w_b": dense(D, N),
        "w_c": dense(D, N),
        "w_dt": dense(D, H),
        "conv_x": conv(di),
        "conv_b": conv(N),
        "conv_c": conv(N),
        "conv_bias_x": zeros(di),
        "conv_bias_b": zeros(N),
        "conv_bias_c": zeros(N),
        "a_log": a_log,
        "d_skip": torch.ones((n, H), dtype=dtype, device=device),
        "dt_bias": dt_bias,
        "ln_gate": common.rms_norm_init(n, di, dtype, device),
        "out_proj": dense(di, D),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """x ``lead + (B, S, C)``, w ``lead + (W, C)``, b ``lead + (C,)`` ->
    causal depthwise conv along S, as W shifted adds (the reference's form;
    no convolution op, so no TF32 path)."""
    W = w.shape[-2]
    S = x.shape[-2]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[..., i:i + S, :] * common.lead_broadcast(w[..., i, :],
                                                                x)
    return out + common.lead_broadcast(b, x)


def mamba_block_apply(p_l: Dict, x: torch.Tensor, cfg: ArchConfig,
                      gate: torch.Tensor, *, chunk: int = 64
                      ) -> torch.Tensor:
    """Full-sequence Mamba2 block with residual gating (the FedPairing
    split).  ``gate``: a scalar, or ``lead`` per-client gates."""
    d = dims(cfg)
    S = x.shape[-2]
    N, H, P = cfg.ssm_state, d["n_heads"], cfg.ssm_head_dim
    dtype = x.dtype
    gate = torch.as_tensor(gate, device=x.device).to(dtype)
    gate = gate.reshape(gate.shape + (1, 1, 1))

    h = common.rms_norm(x, p_l["ln"], cfg.norm_eps)
    z = common.linear(h, p_l["w_z"])
    xs = common.linear(h, p_l["w_x"])
    b = common.linear(h, p_l["w_b"])
    c = common.linear(h, p_l["w_c"])
    dt = common.linear(h, p_l["w_dt"])

    def conv(t, name):
        return F.silu(_causal_depthwise_conv(
            t, p_l[f"conv_{name}"].to(dtype),
            p_l[f"conv_bias_{name}"].to(dtype)))

    xs, b, c = conv(xs, "x"), conv(b, "b"), conv(c, "c")

    dt = F.softplus(dt.float()
                    + common.lead_broadcast(p_l["dt_bias"], dt).float())
    a = -torch.exp(p_l["a_log"].float())                     # lead + (H,)
    log_decay = dt * common.lead_broadcast(a, dt)            # lead+(B,S,H)

    xh = xs.reshape(xs.shape[:-1] + (H, P))
    x_in = xh * dt[..., None].to(dtype)
    y, _ = ops.ssd(x_in.reshape(-1, S, H, P).contiguous(),
                   log_decay.reshape(-1, S, H).contiguous(),
                   b.reshape(-1, S, N).contiguous(),
                   c.reshape(-1, S, N).contiguous(), chunk=chunk)
    d_skip = p_l["d_skip"].to(dtype)
    d_skip = d_skip.reshape(d_skip.shape[:-1] + (1, 1, H, 1))
    y = y.reshape(xh.shape) + d_skip * xh
    y = y.reshape(xs.shape)

    y = common.rms_norm(y * F.silu(z), p_l["ln_gate"], cfg.norm_eps)
    return x + gate * common.linear(y, p_l["out_proj"])
