"""Kernel dispatch (counterpart of ``repro/kernels/ops.py``).

Each op has two implementations:
  * ``eager`` — the plain PyTorch version from ``ref.py``; runs on CPU
                tensors (the CPU tests and the CPU side of a parity run).
  * ``cuda``  — the hand-written CUDA kernel; runs on CUDA tensors.

The device of the input selects: ``cuda`` for a CUDA tensor, ``eager``
otherwise.  An explicit ``impl=`` only asserts that choice: one that does
not match the tensor's device raises, and a kernel that fails to build or
launch raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref

_VALID = ("eager", "cuda")


def resolve_impl(x: torch.Tensor, impl: Optional[str] = None) -> str:
    which = impl if impl is not None else ("cuda" if x.is_cuda else "eager")
    if which not in _VALID:
        raise ValueError(f"impl must be one of {_VALID}, got {which!r}")
    if which == "cuda" and not x.is_cuda:
        raise ValueError(f"impl='cuda' runs the CUDA kernel and needs CUDA "
                         f"tensors; got a tensor on {x.device}")
    if which == "eager" and x.is_cuda:
        raise ValueError("impl='eager' is the CPU path; a CUDA tensor runs "
                         "the kernel (impl='cuda')")
    return which


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0,
                    impl: Optional[str] = None) -> torch.Tensor:
    """q (B,S,Hq,d), k/v (B,L,Hkv,d) -> (B,S,Hq,d)."""
    if resolve_impl(q, impl) == "eager":
        return ref.attention_ref(q, k, v, causal=causal,
                                 sliding_window=sliding_window)
    from repro_torch.kernels import flash_attention as fa
    return fa.flash_attention(q, k, v, causal=causal,
                              sliding_window=sliding_window)


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------

def ssd(x: torch.Tensor, log_decay: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, *, chunk: int = 64,
        initial_state: Optional[torch.Tensor] = None,
        impl: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P), log_decay (B,S,H) fp32, b/c (B,S,N) -> (y (B,S,H,P),
    final state (B,H,P,N) fp32).  ``chunk`` is the plain version's chunk;
    on the card it is the chunk of the backward pass's recompute."""
    if resolve_impl(x, impl) == "eager":
        return ref.ssd_chunked_ref(x, log_decay, b, c, chunk=chunk,
                                   initial_state=initial_state)
    from repro_torch.kernels import ssd_scan
    return ssd_scan.ssd(x, log_decay, b, c, chunk=chunk,
                        initial_state=initial_state)


# ---------------------------------------------------------------------------
# RWKV6 WKV
# ---------------------------------------------------------------------------

def wkv6_effective_chunk(chunk: int, impl: Optional[str] = None) -> int:
    """The chunk ``wkv6`` honours under ``impl`` (counterpart of the
    reference's query, which coerces requests up to its Pallas kernel's
    64-step tile).  The CUDA kernel runs the recurrence step by step and
    has no minimum chunk, so both impls honour the request: it is the
    plain version's chunk on the CPU and the backward recompute's chunk
    on the card.  Kept only for API parity with the reference: nothing in
    the port calls it."""
    if impl is not None and impl not in _VALID:
        raise ValueError(f"impl must be one of {_VALID}, got {impl!r}")
    return chunk


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         log_w: torch.Tensor, u: torch.Tensor, *, chunk: int = 16,
         initial_state: Optional[torch.Tensor] = None,
         impl: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k (B,S,H,N), v (B,S,H,M), log_w (B,S,H,N) fp32, u fp32 (H,N) or
    (U,H,N) with B // U consecutive batch rows per row (one ``u`` per
    client when the fed step folds clients into the batch) ->
    (out (B,S,H,M), final state (B,H,N,M) fp32)."""
    if resolve_impl(r, impl) == "eager":
        return ref.wkv6_chunked_ref(r, k, v, log_w, u, chunk=chunk,
                                    initial_state=initial_state)
    from repro_torch.kernels import wkv6 as wkv6_kernel
    return wkv6_kernel.wkv6(r, k, v, log_w, u, chunk=chunk,
                            initial_state=initial_state)
