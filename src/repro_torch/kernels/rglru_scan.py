"""RG-LRU linear-recurrence scan: a CUDA kernel written by hand for Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/rglru_scan.py``
(``_rglru_kernel``, l.30, and ``rglru_scan_kernel``, l.83) and computes
the same function as ``ref.rglru``: per channel, ``h_t = a_t h_{t-1} +
sqrt(1 - a_t^2) x_t`` with ``a = exp(log_a)``, from ``h0``, in f32.

What bounds it on the H100: a few flops per element against 12 bytes
moved (x and log_a read, h written, all f32), so bytes. The design
(``csrc/rglru_scan.cu``) gives a block one batch row and 32 channels
(one lane each, so every warp access is one line) and walks its time
blocks of 256 steps in order with the running state in a register:
inside a time block each of 16 warps composes 16 steps' affine maps,
one warp folds the warps' maps into the state, and every thread writes
``h = Q + P carry``; the next time block's loads are in flight
meanwhile. Each byte is read and written once, and S and C need not
divide anything: the ragged time block and channel tile are masked.

The kernel's input weight is the TPU kernel's ``sqrt(max(1 -
exp(2 log_a), 0))`` (``rglru_scan.py:49``), evaluated as ``-expm1(2
log_a)`` so that it does not cancel when a is near 1; the plain version
keeps the JAX oracle's ``a * a`` form (``ref.py:83``), which does. The two
differ in their last bits, which a long recurrence carries and sums, so
at long S both are held to a float64 run of the plain version.

On a CPU tensor the wrapper computes the plain version instead; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

__all__ = ["LAUNCHES", "rglru_scan"]

# kernel launches since import (or since a caller last set it to 0)
LAUNCHES = 0

_fn = None


def _bind(lib: ctypes.CDLL):
    fn = lib.repro_rglru_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_int64] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_cuda_error_string


def _kernel():
    global _fn
    if _fn is None:
        _fn = _bind(_build.load("rglru_scan"))
    return _fn


def _check(x, log_a, h0) -> None:
    if x.dim() != 3 or log_a.shape != x.shape:
        raise ValueError(f"x and log_a must be (B, S, C) alike, got {tuple(x.shape)} and {tuple(log_a.shape)}")
    b, s, c = x.shape
    if s == 0:
        raise ValueError("empty sequence")
    if h0 is not None and h0.shape != (b, c):
        raise ValueError(f"h0 {tuple(h0.shape)} != {(b, c)}")
    tensors = [x, log_a] + ([h0] if h0 is not None else [])
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"rglru_scan takes float32, got {[t.dtype for t in tensors]}")
    if any(t.device != x.device for t in tensors):
        raise ValueError("rglru_scan inputs must lie on one device")


def rglru_scan(
    x: torch.Tensor,  # (B, S, C) f32 gated input, any batch/seq strides
    log_a: torch.Tensor,  # (B, S, C) f32 log decay, <= 0
    h0: torch.Tensor | None = None,  # (B, C) f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over (B, S, C); returns (h (B, S, C) f32, h_last (B, C) f32)."""
    global LAUNCHES
    _check(x, log_a, h0)
    if x.device.type == "cpu":
        return ref.rglru(x, log_a, h0)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cuda or cpu tensors, not {x.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, log_a, h0)):
        # the kernel's output is outside autograd: a loss through it would
        # give its inputs no gradient and raise nothing
        raise NotImplementedError(
            "rglru_scan has no backward kernel yet (it comes with recurrentgemma training); "
            "call it under torch.no_grad() or on inputs that do not require grad"
        )
    if x.stride(2) != 1 or log_a.stride(2) != 1:
        raise ValueError("x and log_a must be contiguous along channels")
    if h0 is not None and h0.stride(1) != 1:
        h0 = h0.contiguous()
    h, h_last = _launch(_kernel(), x, log_a, h0)
    LAUNCHES += 1
    return h, h_last


def _launch(kernel, x, log_a, h0):
    """One launch of ``kernel`` (a bound ``repro_rglru_scan_fwd``) on checked
    CUDA inputs; returns (h, h_last) or raises."""
    fn, err_str = kernel
    b, s, c = x.shape
    h = torch.empty((b, s, c), dtype=torch.float32, device=x.device)
    h_last = torch.empty((b, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(
            x.data_ptr(), log_a.data_ptr(), h0.data_ptr() if h0 is not None else None,
            h.data_ptr(), h_last.data_ptr(), b, s, c,
            x.stride(0), x.stride(1), log_a.stride(0), log_a.stride(1), h.stride(0), h.stride(1),
            h0.stride(0) if h0 is not None else 0, h_last.stride(0), stream,
        )
    if rc != 0:
        raise RuntimeError(f"rglru_scan launch failed: {err_str(rc).decode()} ({rc})")
    return h, h_last
