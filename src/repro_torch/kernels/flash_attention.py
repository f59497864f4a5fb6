"""K1 on Hopper: the flash-attention forward kernel, its binding and its
autograd wrapper.

The kernel is CUDA C++ (``csrc/flash_attention.cu``), built by
``kernels.build`` with ``nvcc`` and called through ctypes on PyTorch's
current stream.  It replaces the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention``.

* ``flash_attention`` — differentiable attention on CUDA tensors.  The
  forward pass is the kernel; the backward pass recomputes the plain
  version under autograd and returns its gradients (the reference kernel
  has no backward either: JAX differentiates the XLA ``attend``).  A
  hand-written FA-2 backward kernel is a queued ROADMAP item.
* ``flash_attention_plain`` — the plain PyTorch version of the same
  function (``ref.attention_ref``): what the CPU runs, and what the card's
  kernel is held against.
* ``launches`` — how many times the kernel was launched (one per forward).

Nothing here falls back: a tensor the kernel does not take raises, a failed
build raises, and a refused launch raises with its CUDA error code.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_ref as flash_attention_plain

HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0      # kernel launches since import (or since a caller reset it)


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention kernel: {name} is on "
                             f"{t.device}, not a CUDA device")
        if t.device != q.device:
            raise ValueError("flash_attention kernel: q, k, v must share "
                             "one device")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention kernel: {name} is {t.dtype}, "
                             f"q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} is not "
                             f"contiguous")
        if t.dim() != 4:
            raise ValueError(f"flash_attention kernel: {name} must be 4-D, "
                             f"got shape {tuple(t.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    B, S, Hq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"flash_attention kernel: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"flash_attention kernel: {Hq} query heads are not "
                         f"a multiple of {k.shape[2]} KV heads")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, sliding_window: int = 0) -> torch.Tensor:
    """Run the forward kernel once: q (B,S,Hq,d), k/v (B,L,Hkv,d) ->
    (B,S,Hq,d), no autograd."""
    global launches
    _check(q, k, v)
    B, S, Hq, d = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = _lib().repro_flash_attention_fwd
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, L, Hq, Hkv, d, _DTYPE_CODES[q.dtype], int(bool(causal)),
            int(sliding_window),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {rc} at q {tuple(q.shape)} {q.dtype}")
    launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sliding_window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.sliding_window = causal, sliding_window
        return launch(q, k, v, causal=causal, sliding_window=sliding_window)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = flash_attention_plain(*qkv, causal=ctx.causal,
                                        sliding_window=ctx.sliding_window)
            grads = torch.autograd.grad(out, qkv, grad_out)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0
                    ) -> torch.Tensor:
    """q (B,S,Hq,d), k/v (B,L,Hkv,d) -> (B,S,Hq,d) on the card, through
    the kernel, differentiable."""
    return _FlashAttention.apply(q, k, v, causal, sliding_window)
