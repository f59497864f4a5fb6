"""Plain PyTorch oracles (counterparts of ``repro/kernels/ref.py``).

These are the semantics of the kernels, written as straightforward tensor
code.  On a CPU tensor the kernel dispatch (``ops``) runs them; on the
card the hand-written kernels are held against them.

* ``attention_ref`` — causal / sliding-window GQA attention (K1's contract).
* ``fit_chunk`` / ``ce_chunk_size`` — chunk sizing for the chunked CE head.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, sliding_window: int = 0
                  ) -> torch.Tensor:
    """q (B,S,Hq,d), k/v (B,L,Hkv,d) -> (B,S,Hq,d).  fp32 softmax.

    GQA is a grouped einsum: query head h reads KV head h // G, and the
    KV heads are never repeated."""
    B, S, Hq, d = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, d)
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bshgd,blhd->bhgsl", qg, k).float() * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(L, device=q.device)[None, :]
    mask = torch.ones((S, L), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if sliding_window:
        mask &= kpos > qpos - sliding_window
    scores = torch.where(mask, scores, torch.full((), NEG_INF,
                                                  device=q.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgsl,blhd->bshgd", probs, v)
    return out.reshape(B, S, Hq, d)


def fit_chunk(seq_len: int, chunk: int) -> int:
    """Largest divisor of ``seq_len`` that is <= ``chunk``."""
    c = min(chunk, seq_len)
    while seq_len % c:
        c -= 1
    return c


def ce_chunk_size(seq_len: int, chunk: int) -> int:
    """``fit_chunk`` with a sanity floor for the chunked-CE head.

    Raises when the best divisor degrades below a quarter of the request
    (e.g. prime seq lengths end at C=1, which silently destroys the
    memory win chunking exists for).
    """
    c = fit_chunk(seq_len, chunk)
    floor = max(1, min(chunk, seq_len) // 4)
    if c < floor:
        raise ValueError(
            f"ce_chunk={chunk} is incompatible with seq_len={seq_len}: the "
            f"largest divisor <= chunk is {c} (< floor {floor}), which "
            "degrades the chunked head to near token-at-a-time.  Pick a "
            "chunk sharing a factor with the sequence length.")
    return c
