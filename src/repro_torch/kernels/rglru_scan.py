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
tensor it launches the kernel or raises. On meta tensors (the dry run, ``launch/dryrun.py``) it allocates what
the card path allocates and records the kernel's work
(``kernels/cost.py``), launching nothing and counting no launch.

The backward (:func:`rglru_scan_bwd`, ``csrc/rglru_scan_bwd.cu``) has no
TPU kernel behind it: JAX differentiates its plain associative scan
(``src/repro/models/rglru.py:93``). It is K3's design run backward in
time, bound by bytes too (24 an element: dh, x, log_a and h read, dx and
dlog_a written), its carry ``a_t g_t`` handed from each step to the one
before. :class:`RGLRUScan` joins the forward and the backward into one
differentiable op; ``rglru_scan`` goes through it whenever grad mode is on
and an input requires grad (on the CPU its two sides are the plain
versions, ``ref.rglru`` and ``ref.rglru_bwd``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cost, ref

__all__ = ["BWD_LAUNCHES", "LAUNCHES", "RGLRUScan", "rglru_scan", "rglru_scan_bwd"]

# kernel launches since import (or since a caller last set it to 0)
LAUNCHES = 0
BWD_LAUNCHES = 0  # of the backward kernel

_fn = None
_bwd_fn = None


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
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, log_a, h0)):
        # a kernel's output is outside autograd: RGLRUScan joins its backward there
        return RGLRUScan.apply(x, log_a, h0)
    if x.device.type == "cpu":
        return ref.rglru(x, log_a, h0)
    if x.device.type == "meta":
        return _meta_forward(x, log_a, h0)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cuda or cpu tensors, not {x.device}")
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


def _meta_forward(x, log_a, h0):
    """The card path on meta tensors, for the dry run: its checks and h0's
    copy, h and h_last, and K3's work recorded; no launch, no count."""
    if x.stride(2) != 1 or log_a.stride(2) != 1:
        raise ValueError("x and log_a must be contiguous along channels")
    if h0 is not None and h0.stride(1) != 1:
        h0 = h0.contiguous()
    b, s, c = x.shape
    h = torch.empty((b, s, c), dtype=torch.float32, device=x.device)
    h_last = torch.empty((b, c), dtype=torch.float32, device=x.device)
    cost.record("rglru_scan", cost.rglru_work(b, s, c, h0 is not None))
    return h, h_last


# ------------------------------------------------------------------ backward
def _bind_bwd(lib: ctypes.CDLL):
    fn = lib.repro_rglru_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p] + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_cuda_error_string


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        _bwd_fn = _bind_bwd(_build.load("rglru_scan_bwd"))
    return _bwd_fn


def _channels_unit(t: torch.Tensor | None) -> torch.Tensor | None:
    """``t`` itself where its channel stride is 1, else a contiguous copy."""
    return t if t is None or t.stride(-1) == 1 else t.contiguous()


def rglru_scan_bwd(
    x: torch.Tensor,  # (B, S, C) f32, as given to the forward
    log_a: torch.Tensor,  # (B, S, C) f32
    h0: torch.Tensor | None,  # (B, C) f32
    h: torch.Tensor,  # (B, S, C) f32, the forward's h
    dh: torch.Tensor,  # (B, S, C) f32, h's gradient
    dh_last: torch.Tensor | None = None,  # (B, C) f32, h_last's gradient (None: zero)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """(dx, dlog_a, dh0) of :func:`rglru_scan`, f32; dh0 None without h0.

    On CPU tensors the plain version, ``ref.rglru_bwd``. On CUDA tensors it
    launches the backward kernel or raises; inputs whose channel stride is
    not 1 are copied first (autograd may hand dh over in any layout)."""
    global BWD_LAUNCHES
    _check(x, log_a, h0)
    b, s, c = x.shape
    for name, t, shape in (("h", h, (b, s, c)), ("dh", dh, (b, s, c)), ("dh_last", dh_last, (b, c))):
        if t is not None and (t.shape != shape or t.dtype != torch.float32 or t.device != x.device):
            raise ValueError(f"{name} must be f32 {shape} on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if x.device.type == "cpu":
        return ref.rglru_bwd(x, log_a, h0, h, dh, dh_last)
    if x.device.type == "meta":
        return _meta_backward(x, log_a, h0, h, dh, dh_last)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan_bwd runs on cuda or cpu tensors, not {x.device}")
    x, log_a, h0, h, dh, dh_last = (_channels_unit(t) for t in (x, log_a, h0, h, dh, dh_last))
    dx = torch.empty((b, s, c), dtype=torch.float32, device=x.device)
    dlog_a = torch.empty((b, s, c), dtype=torch.float32, device=x.device)
    dh0 = torch.empty((b, c), dtype=torch.float32, device=x.device) if h0 is not None else None
    strides = (ctypes.c_int64 * 12)(*(st for t in (x, log_a, h, dh, dx, dlog_a) for st in (t.stride(0), t.stride(1))))

    def ptr(t):
        return t.data_ptr() if t is not None else None

    fn, err_str = _bwd_kernel()
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), log_a.data_ptr(), ptr(h0), h.data_ptr(), dh.data_ptr(), ptr(dh_last), dx.data_ptr(),
            dlog_a.data_ptr(), ptr(dh0), b, s, c, ctypes.cast(strides, ctypes.c_void_p),
            h0.stride(0) if h0 is not None else 0, dh_last.stride(0) if dh_last is not None else 0,
            dh0.stride(0) if dh0 is not None else 0, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"rglru_scan_bwd launch failed: {err_str(rc).decode()} ({rc})")
    BWD_LAUNCHES += 1
    return dx, dlog_a, dh0


def _meta_backward(x, log_a, h0, h, dh, dh_last):
    """The backward's card path on meta tensors, for the dry run: the
    copies of inputs whose channel stride is not 1, dx, dlog_a and dh0,
    and K3's backward's work recorded; no launch, no count."""
    x, log_a, h0, h, dh, dh_last = (_channels_unit(t) for t in (x, log_a, h0, h, dh, dh_last))
    b, s, c = x.shape
    dx = torch.empty((b, s, c), dtype=torch.float32, device=x.device)
    dlog_a = torch.empty((b, s, c), dtype=torch.float32, device=x.device)
    dh0 = torch.empty((b, c), dtype=torch.float32, device=x.device) if h0 is not None else None
    cost.record("rglru_scan_bwd", cost.rglru_bwd_work(b, s, c, h0 is not None, dh_last is not None))
    return dx, dlog_a, dh0


class RGLRUScan(torch.autograd.Function):
    """K3 and its backward kernel as one differentiable op over (B, S, C)
    f32; on CPU tensors both sides are the plain version. It saves x,
    log_a, h0 and the forward's h. h_last's gradient may be None (in
    training h_last feeds no loss)."""

    @staticmethod
    def forward(ctx, x, log_a, h0):
        h, h_last = rglru_scan(x, log_a, h0)
        ctx.save_for_backward(x, log_a, h0, h)
        ctx.set_materialize_grads(False)  # an unused output's gradient comes as None
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        x, log_a, h0, h = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(h)
        return rglru_scan_bwd(x, log_a, h0, h, dh, dh_last)
