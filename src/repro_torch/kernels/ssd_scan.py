"""Mamba-2 SSD chunk scan: a CUDA kernel written by hand for Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan.py``
(``_ssd_kernel``, l.33, and ``ssd_scan``, l.98) and computes the same
function as ``ref.ssd``: per (batch, head), chunk by chunk, the
intra-chunk quadratic form plus the carried (N, P) f32 state's share,
then the state update.

What bounds it on the H100: at the serving shape (B 4, H 80, S 2000,
P 64, N 128, bf16) the function moves ~0.19 GB and does ~52 GFLOP, so on
the tensor cores it is bound by bytes (~0.06 ms). The bf16 kernel
(``csrc/ssd_scan.cu``), the serving path, is chunk-parallel on ``wgmma``:
one call runs (1) each chunk's own state contribution B^T (xdt o decay)
on a (chunk, head, batch) grid, (2) the f32 recurrence across chunks,
elementwise over (N, P), and (3) each chunk's y from its incoming state
and its intra-chunk scores (64 x 64 tiles at or below the diagonal,
masked before the exp; two heads of a group share the B, C and score
tiles) on a (chunk, head pair, batch) grid, so one sequence fills the
card too. B and C of head h come from group h // (H / G) through strides
(no per-head copies). It replaces a kernel that walked each (batch,
head)'s chunks in order on the CUDA cores (6.1 ms at the serving shape).
Its cost over the function's bytes is the scratch allocated here,
B H n_chunks (3 N P / 2 + 1) f32: each chunk's state contribution in
f32, its incoming state in bf16, its decay. It rounds where the TPU
kernel does not: the decayed scores and the state's copy for C . state
to bf16 (both feed y only, stored in bf16), and the decayed xdt of the
state update to bf16 hi + lo (about 16 bits, so the carried state keeps
f32-level accuracy). The source note names each refinement (PERF.md has
their measured worth). ptxas, the same for every P (P pads to 64): phase
1 64 registers and 40 bytes of spills, 35,840 bytes of shared memory;
phase 2 54 registers; phase 3 168 registers and 4 bytes of spills,
232,448 bytes at two heads a block (135, none, 182,272 at one). In
f32 the first kernel runs unchanged: one block per (batch, head) walks
its chunks with every product as f32 FMAs on the CUDA cores, since bf16
operands would not hold the f32 tolerance.

x * dt is rounded to x's dtype inside the kernel, as the TPU wrapper does
before its kernel (``ssd_scan.py:117``); ``ref.ssd`` rounds dt to x's
dtype first (``ref.py:62``). The two agree exactly in f32 and within the
bf16 tolerance in bf16.

The bf16 kernel reads x, B and C in 16-byte vectors: a 16-byte aligned
base and batch / sequence / head (group) strides in multiples of 8
elements; :func:`check_layout` states what the kernel takes and the
wrapper raises on anything else. On a CPU tensor the wrapper computes the
plain version instead; on a CUDA tensor it launches the kernel or raises.
On meta tensors (the dry run, ``launch/dryrun.py``) it allocates what
the card path allocates and records the kernel's work
(``kernels/cost.py``), launching nothing and counting no launch.

The backward (:func:`ssd_scan_bwd`, ``csrc/ssd_scan_bwd.cu``) has no TPU
kernel behind it: JAX differentiates its plain ``ssd_chunked``
(``src/repro/models/ssm.py:123``). It takes what the forward takes. In
bf16 (the training path) every product runs on ``wgmma``: each chunk's
own state terms, the f32 recurrences across chunks (recomputed rather
than kept from the forward), then the gradients on a (chunk, 64-position
tile, block of heads, batch) grid whose blocks sum dB and dC over their
heads in f32 before one partial a block of heads. It reads x, B, C and dy
in 16-byte vectors as the forward reads x, B and C (:func:`check_layout`;
dy alone, which autograd hands over in any layout, is copied where it
does not fit). Its f32 path is the first kernel, f32 FMAs on the CUDA
cores, reading one element at a time. Both sum every reduction (the
heads of a group, A over batch and time) in a fixed order: the same bits
on every call. :class:`SSDScan` joins the forward and the backward into
one differentiable op; ``ssd_scan`` goes through it whenever grad mode
is on and an input requires grad (on the CPU its two sides are the plain
versions).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cost, ref

__all__ = ["BWD_LAUNCHES", "LAUNCHES", "SSDScan", "check_layout", "layout_error", "ssd_scan", "ssd_scan_bwd"]

# calls that launched the kernel since import (or since a caller last set
# it to 0); a bf16 call runs three CUDA kernels and counts once
LAUNCHES = 0
# calls that launched the backward (five CUDA kernels a call, counted once)
BWD_LAUNCHES = 0

_MAX_CHUNK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)
_MAX_STATE = 128
_fn = None
_bwd_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("ssd_scan")
        fn = lib.repro_ssd_scan_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 8
            + [ctypes.c_int] * 8
            + [ctypes.c_int64] * 19
            + [ctypes.c_void_p] * 2
        )
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.repro_cuda_error_string)
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        lib = _build.load("ssd_scan_bwd")
        fn = lib.repro_ssd_scan_bwd
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        scratch = lib.repro_ssd_scan_bwd_scratch
        scratch.argtypes = [ctypes.c_int] * 8
        scratch.restype = ctypes.c_int64
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _bwd_fn = (fn, scratch, lib.repro_cuda_error_string)
    return _bwd_fn


def _check(x, dt, A, Bm, Cm, init_state) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4 or Cm.dim() != 4:
        raise ValueError("x (B, H, S, P), dt (B, H, S), A (H,), Bm and Cm (B, G, S, N)")
    b, h, s, p = x.shape
    g, n = Bm.shape[1], Bm.shape[3]
    if dt.shape != (b, h, s) or A.shape != (h,):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}")
    if Cm.shape != Bm.shape or Bm.shape[0] != b or Bm.shape[2] != s:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    if h % g != 0:
        raise ValueError(f"{h} heads do not group over {g} groups")
    if init_state is not None and init_state.shape != (b, h, n, p):
        raise ValueError(f"init_state {tuple(init_state.shape)} != {(b, h, n, p)}")
    if not (x.dtype == Bm.dtype == Cm.dtype) or x.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x, Bm, Cm; got {x.dtype}/{Bm.dtype}/{Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}/{A.dtype}")
    if init_state is not None and init_state.dtype != torch.float32:
        raise TypeError(f"init_state must be float32, got {init_state.dtype}")
    tensors = [x, dt, A, Bm, Cm] + ([init_state] if init_state is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("ssd_scan inputs must lie on one device")


def _check_kernel_shape(p: int, n: int, chunk: int) -> int:
    """Raise unless the CUDA kernels take head dim ``p``, state dim ``n``
    and ``chunk`` (already cut to S); return ``chunk``."""
    if p not in _HEAD_DIMS:
        raise ValueError(f"head_dim {p} not in {_HEAD_DIMS}")
    if n % 16 or n > _MAX_STATE:
        raise ValueError(f"state_dim {n} must be a multiple of 16 up to {_MAX_STATE}")
    if chunk > _MAX_CHUNK:
        raise ValueError(f"chunk {chunk} > {_MAX_CHUNK}")
    return chunk


def _rows_of_states(t: torch.Tensor | None) -> torch.Tensor | None:
    """``t`` (B, H, N, P) f32 with (N, P) contiguous and its batch and head
    strides in multiples of 4 from a 16-byte aligned base, copied if not."""
    if t is None:
        return None
    p = t.shape[3]
    if t.stride(3) != 1 or t.stride(2) != p or t.stride(1) % 4 or t.stride(0) % 4 or t.data_ptr() % 16:
        return t.clone(memory_format=torch.contiguous_format)
    return t


def layout_error(name: str, shape, stride, data_ptr: int, dtype: torch.dtype) -> str | None:
    """Why the CUDA kernels do not take this view of ``shape`` and element
    ``stride`` starting at ``data_ptr`` (x or dy (B, H, S, P), Bm or Cm
    (B, G, S, N), or dt (B, H, S)), or None if they do.

    x, Bm, Cm and dy must be contiguous along their last axis in every
    dtype. In bf16 the kernels read their rows in 16-byte vectors, so the
    base must be 16-byte aligned and the batch, head (or group) and
    sequence strides multiples of 8 elements; an axis of extent 1 is never
    stepped, so its stride does not matter, and a stride of 0 (a broadcast
    view) reads one row again. dt is read one f32 at a time: any strides.
    """
    if len(shape) == 3:
        return None
    if stride[3] != 1:
        return f"{name} must be contiguous along its last dim"
    if dtype != torch.bfloat16:
        return None
    if data_ptr % 16:
        return f"bf16 {name} must start at a 16-byte aligned address"
    for axis, (extent, st) in enumerate(zip(shape[:3], stride[:3])):
        if extent > 1 and st % 8:
            return f"bf16 {name}: stride {st} of axis {axis} must be a multiple of 8 elements"
    return None


def check_layout(name: str, shape, stride, data_ptr: int, dtype: torch.dtype) -> None:
    """Raise ValueError where :func:`layout_error` finds one."""
    err = layout_error(name, shape, stride, data_ptr, dtype)
    if err is not None:
        raise ValueError(err)


def ssd_scan(
    x: torch.Tensor,  # (B, H, S, P), batch/head/seq strides as check_layout takes
    dt: torch.Tensor,  # (B, H, S) f32, post-softplus
    A: torch.Tensor,  # (H,) f32, negative
    Bm: torch.Tensor,  # (B, G, S, N), H % G == 0: head h reads group h // (H / G)
    Cm: torch.Tensor,  # (B, G, S, N)
    init_state: torch.Tensor | None = None,  # (B, H, N, P) f32
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD over (B, H, S, P) views; returns (y (B, H, S, P) in x's dtype,
    final state (B, H, N, P) f32).

    ``y`` is a (B, H, S, P) view of a contiguous (B, S, H, P) tensor, so
    the model's layout comes back without a copy. S need not divide
    ``chunk``: the last chunk is shorter and the final state is the state
    after exactly S positions.
    """
    global LAUNCHES
    _check(x, dt, A, Bm, Cm, init_state)
    b, h, s, p = x.shape
    g, n = Bm.shape[1], Bm.shape[3]
    if chunk <= 0:
        raise ValueError("chunk must be positive")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, dt, A, Bm, Cm, init_state)):
        # a kernel's output is outside autograd: SSDScan joins its backward there
        return SSDScan.apply(x, dt, A, Bm, Cm, init_state, chunk)
    if x.device.type == "cpu":
        rep = h // g
        br = Bm.repeat_interleave(rep, dim=1) if rep > 1 else Bm
        cr = Cm.repeat_interleave(rep, dim=1) if rep > 1 else Cm
        return ref.ssd(x, dt, A, br, cr, init_state)
    if x.device.type == "meta":
        return _meta_forward(x, dt, A, Bm, Cm, init_state, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu tensors, not {x.device}")
    chunk = _check_kernel_shape(p, n, min(chunk, s))
    for name, t in (("x", x), ("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        check_layout(name, t.shape, t.stride(), t.data_ptr(), t.dtype)
    A = A.contiguous()
    init_state = _rows_of_states(init_state)  # (N, P) rows, read four f32 at a time
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device).transpose(1, 2)
    st = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    work = None
    if x.dtype == torch.bfloat16:  # each chunk's (N, P) state in f32 and in bf16, and its decay
        work = torch.empty(b * h * -(-s // chunk) * (3 * n * p // 2 + 1), dtype=torch.float32, device=x.device)
    fn, err_str = _kernel()
    dev = x.get_device()
    args = (
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        init_state.data_ptr() if init_state is not None else None, y.data_ptr(), st.data_ptr(),
        _DTYPES[x.dtype], b, h, g, s, p, n, chunk,
        x.stride(0), x.stride(2), x.stride(1),
        dt.stride(0), dt.stride(2), dt.stride(1),
        Bm.stride(0), Bm.stride(2), Bm.stride(1),
        Cm.stride(0), Cm.stride(2), Cm.stride(1),
        y.stride(0), y.stride(2), y.stride(1),
        init_state.stride(0) if init_state is not None else 0,
        init_state.stride(1) if init_state is not None else 0,
        st.stride(0), st.stride(1), torch.cuda.current_stream(dev).cuda_stream,
        work.data_ptr() if work is not None else None,
    )
    if dev == torch.cuda.current_device():  # the launch goes to the current card
        rc = fn(*args)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: {err_str(rc).decode()} ({rc})")
    LAUNCHES += 1
    return y, st


def ssd_scan_bwd(
    x: torch.Tensor,  # (B, H, S, P), as given to the forward
    dt: torch.Tensor,  # (B, H, S) f32
    A: torch.Tensor,  # (H,) f32
    Bm: torch.Tensor,  # (B, G, S, N)
    Cm: torch.Tensor,  # (B, G, S, N)
    init_state: torch.Tensor | None,  # (B, H, N, P) f32
    dy: torch.Tensor,  # (B, H, S, P), y's gradient
    dfinal: torch.Tensor | None = None,  # (B, H, N, P) f32, the final state's gradient (None: zero)
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, ...]:
    """(dx, ddt, dA, dBm, dCm, d init_state) of :func:`ssd_scan`, each in its
    input's dtype and shape (dBm and dCm summed over the heads of each
    group; d init_state None without an initial state).

    On CPU tensors the plain version, ``ref.ssd_bwd`` (autograd through
    ``ref.ssd`` with B and C repeated to the heads). On CUDA tensors it
    launches the backward kernel or raises.
    """
    global BWD_LAUNCHES
    _check(x, dt, A, Bm, Cm, init_state)
    b, h, s, p = x.shape
    g, n = Bm.shape[1], Bm.shape[3]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x {tuple(x.shape)} {x.dtype}")
    if dfinal is not None and (dfinal.shape != (b, h, n, p) or dfinal.dtype != torch.float32
                               or dfinal.device != x.device):
        raise ValueError(f"dfinal must be f32 {(b, h, n, p)} on {x.device}, got {dfinal.dtype} {tuple(dfinal.shape)}")
    if chunk <= 0:
        raise ValueError("chunk must be positive")
    if x.device.type == "cpu":
        return ref.ssd_bwd(x, dt, A, Bm, Cm, init_state, dy, dfinal)
    if x.device.type == "meta":
        return _meta_backward(x, dt, A, Bm, Cm, init_state, dy, dfinal, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd runs on cuda or cpu tensors, not {x.device}")
    chunk = _check_kernel_shape(p, n, min(chunk, s))
    if layout_error("dy", dy.shape, dy.stride(), dy.data_ptr(), dy.dtype):  # autograd's gradient may
        dy = dy.clone(memory_format=torch.contiguous_format)  # come in any layout: dy alone is copied
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        check_layout(name, t.shape, t.stride(), t.data_ptr(), t.dtype)
    A = A.contiguous()
    init_state, dfinal = _rows_of_states(init_state), _rows_of_states(dfinal)
    dev = x.device
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=dev).transpose(1, 2)
    ddt = torch.empty((b, s, h), dtype=torch.float32, device=dev).transpose(1, 2)
    dA = torch.empty((h,), dtype=torch.float32, device=dev)
    dB = torch.empty((b, s, g, n), dtype=x.dtype, device=dev).transpose(1, 2)
    dC = torch.empty((b, s, g, n), dtype=x.dtype, device=dev).transpose(1, 2)
    dst0 = torch.empty((b, h, n, p), dtype=torch.float32, device=dev) if init_state is not None else None
    strides = (ctypes.c_int64 * 31)(
        *(st for t in (x, dt, Bm, Cm, dy, dx, ddt, dB, dC) for st in (t.stride(0), t.stride(2), t.stride(1))),
        *((init_state.stride(0), init_state.stride(1)) if init_state is not None else (0, 0)),
        *((dfinal.stride(0), dfinal.stride(1)) if dfinal is not None else (0, 0)),
    )
    fn, scratch, err_str = _bwd_kernel()
    work = torch.empty(scratch(b, h, g, s, p, n, chunk, _DTYPES[x.dtype]), dtype=torch.float32, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), ptr(init_state),
            dy.data_ptr(), ptr(dfinal), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), ptr(dst0), _DTYPES[x.dtype], b, h, g, s, p, n, chunk,
            ctypes.cast(strides, ctypes.c_void_p), work.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd launch failed: {err_str(rc).decode()} ({rc})")
    BWD_LAUNCHES += 1
    return dx, ddt, dA, dB, dC, dst0


def _meta_forward(x, dt, A, Bm, Cm, init_state, chunk):
    """The card path on meta tensors, for the dry run: its checks, copies
    and outputs (y a (B, H, S, P) view of (B, S, H, P), the f32 final
    state), the bf16 path's per-chunk scratch, and K2's work recorded; no
    launch, no count (a meta tensor's address is 0, so the alignment
    checks pass)."""
    b, h, s, p = x.shape
    g, n = Bm.shape[1], Bm.shape[3]
    chunk = _check_kernel_shape(p, n, min(chunk, s))
    for name, t in (("x", x), ("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        check_layout(name, t.shape, t.stride(), t.data_ptr(), t.dtype)
    A = A.contiguous()
    init_state = _rows_of_states(init_state)
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device).transpose(1, 2)
    st = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    work = None
    if x.dtype == torch.bfloat16:
        work = torch.empty(b * h * -(-s // chunk) * (3 * n * p // 2 + 1), dtype=torch.float32, device=x.device)
    cost.record("ssd_scan", cost.ssd_work(b, h, g, s, p, n, chunk, cost.dtype_name(x.dtype), init_state is not None))
    del work, A, init_state  # the kernel's scratch and copies, live for its span
    return y, st


def _bwd_scratch_floats(b: int, h: int, g: int, s: int, p: int, n: int, q: int, dtype: torch.dtype) -> int:
    """``repro_ssd_scan_bwd_scratch`` (``csrc/ssd_scan_bwd.cu``) in Python,
    with its HEADS_PER_BLOCK (40) and THREADS (256); ``chip_smoke.py``
    holds the two equal on the card."""
    nc = -(-s // q)
    if dtype != torch.bfloat16:
        return 2 * b * h * nc * (n * p + 1) + 2 * b * h * s * n
    nhb, nsb = -(-(h // g) // 40), -(-(n * p) // (4 * 256))
    return 3 * b * h * nc * n * p + 2 * b * g * nhb * s * n + 4 * b * h * s + b * h * nc * (1 + nsb)


def _meta_backward(x, dt, A, Bm, Cm, init_state, dy, dfinal, chunk):
    """The backward's card path on meta tensors, for the dry run: its
    checks and copies, the gradients in the card's layouts, the f32
    scratch, and K2's backward's work recorded; no launch, no count."""
    b, h, s, p = x.shape
    g, n = Bm.shape[1], Bm.shape[3]
    chunk = _check_kernel_shape(p, n, min(chunk, s))
    if layout_error("dy", dy.shape, dy.stride(), dy.data_ptr(), dy.dtype):
        dy = dy.clone(memory_format=torch.contiguous_format)
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        check_layout(name, t.shape, t.stride(), t.data_ptr(), t.dtype)
    A = A.contiguous()
    init_state, dfinal = _rows_of_states(init_state), _rows_of_states(dfinal)
    dev = x.device
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=dev).transpose(1, 2)
    ddt = torch.empty((b, s, h), dtype=torch.float32, device=dev).transpose(1, 2)
    dA = torch.empty((h,), dtype=torch.float32, device=dev)
    dB = torch.empty((b, s, g, n), dtype=x.dtype, device=dev).transpose(1, 2)
    dC = torch.empty((b, s, g, n), dtype=x.dtype, device=dev).transpose(1, 2)
    dst0 = torch.empty((b, h, n, p), dtype=torch.float32, device=dev) if init_state is not None else None
    work = torch.empty(_bwd_scratch_floats(b, h, g, s, p, n, chunk, x.dtype), dtype=torch.float32, device=dev)
    cost.record("ssd_scan_bwd", cost.ssd_bwd_work(b, h, g, s, p, n, chunk, cost.dtype_name(x.dtype),
                                                  init_state is not None))
    del work, dy, A, dfinal  # the kernel's scratch and copies, live for its span
    return dx, ddt, dA, dB, dC, dst0


class SSDScan(torch.autograd.Function):
    """K2 forward and its backward kernel as one differentiable op over
    (B, H, S, P) / (B, G, S, N) views; on CPU tensors both sides are the
    plain version. The final state's gradient may be None: in training
    the new state feeds no loss."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state, chunk: int):
        y, st = ssd_scan(x, dt, A, Bm, Cm, init_state, chunk=chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)  # an unused output's gradient comes as None
        return y, st

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, Bm, Cm, init_state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = ssd_scan_bwd(x, dt, A, Bm, Cm, init_state, dy, dfinal, chunk=ctx.chunk)
        return (*grads, None)
