"""K2 on Hopper: the Mamba2 SSD chunked-scan kernel, its binding and its
autograd wrapper.

The kernel is CUDA C++ (``csrc/ssd_scan.cu``), built by ``kernels.build``
with ``nvcc`` and called through ctypes on PyTorch's current stream.  It
replaces the Pallas kernel ``repro/kernels/ssd_scan.py::ssd``.

* ``ssd`` — the differentiable SSD scan on CUDA tensors.  The forward pass
  is the kernel; the backward pass recomputes the plain version at
  ``chunk`` under autograd and returns the gradients of x, log_decay, b
  and c (the reference kernel has no backward either: JAX differentiates
  the XLA oracle).  The final state is returned but not differentiable,
  and an ``initial_state`` that requires grad is refused.
* ``ssd_plain`` — the plain PyTorch version of the same function
  (``ref.ssd_chunked_ref``): what the CPU runs, and what the card's kernel
  is held against.
* ``launches`` — how many times the kernel was launched (one per forward).

Nothing here falls back: a tensor the kernel does not take raises, a failed
build raises, and a refused launch raises with its CUDA error code.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssd_chunked_ref as ssd_plain

HEAD_DIMS = (16, 32, 64)       # head dim P and state size N
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0      # kernel launches since import (or since a caller reset it)


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    fn = lib.repro_ssd_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(x, log_decay, b, c, initial_state) -> None:
    named = (("x", x), ("log_decay", log_decay), ("b", b), ("c", c))
    if initial_state is not None:
        named += (("initial_state", initial_state),)
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"ssd kernel: {name} is on {t.device}, not a "
                             f"CUDA device")
        if t.device != x.device:
            raise ValueError("ssd kernel: all inputs must share one device")
        if not t.is_contiguous():
            raise ValueError(f"ssd kernel: {name} is not contiguous")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"ssd kernel takes x/b/c in float32 or bfloat16, "
                         f"got {x.dtype}")
    for name, t in (("b", b), ("c", c)):
        if t.dtype != x.dtype:
            raise ValueError(f"ssd kernel: {name} is {t.dtype}, x is "
                             f"{x.dtype}")
    for name, t in (("log_decay", log_decay),
                    ("initial_state", initial_state)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"ssd kernel: {name} must be float32, got "
                             f"{t.dtype}")
    if x.dim() != 4:
        raise ValueError(f"ssd kernel: x must be 4-D, got shape "
                         f"{tuple(x.shape)}")
    B, S, H, P = x.shape
    N = b.shape[-1]
    if P not in HEAD_DIMS or N not in HEAD_DIMS:
        raise ValueError(f"ssd kernel takes head dim P and state size N in "
                         f"{HEAD_DIMS}, got P={P}, N={N}")
    if log_decay.shape != (B, S, H) or b.shape != (B, S, N) \
            or c.shape != (B, S, N):
        raise ValueError(f"ssd kernel: log_decay {tuple(log_decay.shape)}, "
                         f"b {tuple(b.shape)}, c {tuple(c.shape)} do not fit "
                         f"x {tuple(x.shape)}")
    if initial_state is not None and initial_state.shape != (B, H, P, N):
        raise ValueError(f"ssd kernel: initial_state "
                         f"{tuple(initial_state.shape)} is not "
                         f"{(B, H, P, N)}")


def launch(x: torch.Tensor, log_decay: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor, initial_state: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the forward kernel once, no autograd: -> (y (B,S,H,P) in x's
    dtype, final state (B,H,P,N) fp32)."""
    global launches
    _check(x, log_decay, b, c, initial_state)
    B, S, H, P = x.shape
    N = b.shape[-1]
    y = torch.empty_like(x)
    final = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    fn = _lib().repro_ssd_fwd
    rc = fn(x.data_ptr(), log_decay.data_ptr(), b.data_ptr(), c.data_ptr(),
            None if initial_state is None else initial_state.data_ptr(),
            y.data_ptr(), final.data_ptr(), B, S, H, P, N,
            _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd kernel launch failed with CUDA error {rc} "
                           f"at x {tuple(x.shape)} {x.dtype}")
    launches += 1
    return y, final


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, log_decay, b, c, initial_state, chunk):
        y, final = launch(x, log_decay, b, c, initial_state)
        ctx.save_for_backward(x, log_decay, b, c, initial_state)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(final)
        return y, final

    @staticmethod
    def backward(ctx, grad_y, _grad_final):
        x, log_decay, b, c, initial_state = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (x, log_decay, b, c)]
            y, _ = ssd_plain(*ins, chunk=ctx.chunk,
                             initial_state=initial_state)
            grads = torch.autograd.grad(y, ins, grad_y)
        return (*grads, None, None)


def ssd(x: torch.Tensor, log_decay: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, *, chunk: int = 64,
        initial_state: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan on the card, through the kernel, differentiable in x,
    log_decay, b and c; ``chunk`` is the backward recompute's chunk."""
    if initial_state is not None and initial_state.requires_grad:
        raise ValueError("ssd kernel: the gradient of initial_state is not "
                         "computed; pass it detached")
    return _SSD.apply(x, log_decay, b, c, initial_state, chunk)
