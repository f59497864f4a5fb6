"""K3 on Hopper: the RWKV6 WKV recurrence kernel, its binding and its
autograd wrapper.

The kernel is CUDA C++ (``csrc/wkv6.cu``), built by ``kernels.build`` with
``nvcc`` and called through ctypes on PyTorch's current stream.  It
replaces the Pallas kernel ``repro/kernels/wkv6.py::wkv6``.

* ``wkv6`` — differentiable WKV6 on CUDA tensors.  The forward pass is the
  kernel; the backward pass recomputes the plain version at ``chunk``
  under autograd and returns the gradients of r, k, v, log_w and u (the
  reference kernel has no backward either: JAX differentiates the XLA
  oracle).  The final state is returned but not differentiable, and an
  ``initial_state`` that requires grad is refused.
* ``wkv6_plain`` — the plain PyTorch version of the same function
  (``ref.wkv6_chunked_ref``): what the CPU runs, and what the card's
  kernel is held against.
* ``launches`` — how many times the kernel was launched (one per forward).

``u`` is (H, N), or (U, H, N) with B // U consecutive batch rows per row:
the fed step folds N clients, each with its own ``u``, into the batch, and
the kernel reads the row of its batch row's client.

Nothing here falls back: a tensor the kernel does not take raises, a failed
build raises, and a refused launch raises with its CUDA error code.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import wkv6_chunked_ref as wkv6_plain

HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0      # kernel launches since import (or since a caller reset it)


def _lib() -> ctypes.CDLL:
    lib = build.load("wkv6")
    fn = lib.repro_wkv6_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(r, k, v, log_w, u, initial_state) -> None:
    named = (("r", r), ("k", k), ("v", v), ("log_w", log_w), ("u", u))
    if initial_state is not None:
        named += (("initial_state", initial_state),)
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"wkv6 kernel: {name} is on {t.device}, not a "
                             f"CUDA device")
        if t.device != r.device:
            raise ValueError("wkv6 kernel: all inputs must share one device")
        if not t.is_contiguous():
            raise ValueError(f"wkv6 kernel: {name} is not contiguous")
    if r.dtype not in _DTYPE_CODES:
        raise ValueError(f"wkv6 kernel takes r/k/v in float32 or bfloat16, "
                         f"got {r.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != r.dtype:
            raise ValueError(f"wkv6 kernel: {name} is {t.dtype}, r is "
                             f"{r.dtype}")
    for name, t in (("log_w", log_w), ("u", u),
                    ("initial_state", initial_state)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"wkv6 kernel: {name} must be float32, got "
                             f"{t.dtype}")
    if r.dim() != 4 or v.dim() != 4:
        raise ValueError(f"wkv6 kernel: r/k/v must be 4-D, got r "
                         f"{tuple(r.shape)}, v {tuple(v.shape)}")
    B, S, H, N = r.shape
    M = v.shape[-1]
    if N not in HEAD_DIMS or M not in HEAD_DIMS:
        raise ValueError(f"wkv6 kernel takes head dims N, M in {HEAD_DIMS}, "
                         f"got N={N}, M={M}")
    if k.shape != r.shape or log_w.shape != r.shape \
            or v.shape != (B, S, H, M):
        raise ValueError(f"wkv6 kernel: k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, log_w {tuple(log_w.shape)} do "
                         f"not fit r {tuple(r.shape)}")
    if u.shape[-2:] != (H, N) or u.dim() not in (2, 3) \
            or (u.dim() == 3 and B % u.shape[0]):
        raise ValueError(f"wkv6 kernel: u {tuple(u.shape)} must be ({H}, "
                         f"{N}) or (U, {H}, {N}) with U dividing B={B}")
    if initial_state is not None and initial_state.shape != (B, H, N, M):
        raise ValueError(f"wkv6 kernel: initial_state "
                         f"{tuple(initial_state.shape)} is not "
                         f"{(B, H, N, M)}")


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           log_w: torch.Tensor, u: torch.Tensor,
           initial_state: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the forward kernel once, no autograd: -> (out (B,S,H,M) in v's
    dtype, final state (B,H,N,M) fp32)."""
    global launches
    _check(r, k, v, log_w, u, initial_state)
    B, S, H, N = r.shape
    M = v.shape[-1]
    U = 1 if u.dim() == 2 else u.shape[0]
    out = torch.empty_like(v)
    final = torch.empty((B, H, N, M), dtype=torch.float32, device=r.device)
    fn = _lib().repro_wkv6_fwd
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
            u.data_ptr(),
            None if initial_state is None else initial_state.data_ptr(),
            out.data_ptr(), final.data_ptr(), B, S, H, N, M, U,
            _DTYPE_CODES[r.dtype],
            torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed with CUDA error {rc} "
                           f"at r {tuple(r.shape)} {r.dtype}")
    launches += 1
    return out, final


class _WKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, log_w, u, initial_state, chunk):
        out, final = launch(r, k, v, log_w, u, initial_state)
        ctx.save_for_backward(r, k, v, log_w, u, initial_state)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(final)
        return out, final

    @staticmethod
    def backward(ctx, grad_out, _grad_final):
        r, k, v, log_w, u, initial_state = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (r, k, v, log_w, u)]
            out, _ = wkv6_plain(*ins, chunk=ctx.chunk,
                                initial_state=initial_state)
            grads = torch.autograd.grad(out, ins, grad_out)
        return (*grads, None, None)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         log_w: torch.Tensor, u: torch.Tensor, *, chunk: int = 16,
         initial_state: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 on the card, through the kernel, differentiable in r, k, v,
    log_w and u; ``chunk`` is the backward recompute's chunk."""
    if initial_state is not None and initial_state.requires_grad:
        raise ValueError("wkv6 kernel: the gradient of initial_state is not "
                         "computed; pass it detached")
    return _WKV6.apply(r, k, v, log_w, u, initial_state, chunk)
