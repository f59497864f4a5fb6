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

from typing import Optional

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
