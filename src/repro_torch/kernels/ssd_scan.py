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
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

__all__ = ["LAUNCHES", "check_layout", "ssd_scan"]

# calls that launched the kernel since import (or since a caller last set
# it to 0); a bf16 call runs three CUDA kernels and counts once
LAUNCHES = 0

_MAX_CHUNK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)
_MAX_STATE = 128
_fn = None


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


def check_layout(name: str, shape, stride, data_ptr: int, dtype: torch.dtype) -> None:
    """Raise ValueError unless the CUDA kernel takes this view of ``shape``
    and element ``stride`` starting at ``data_ptr``: x (B, H, S, P), Bm or
    Cm (B, G, S, N), or dt (B, H, S).

    x, Bm and Cm must be contiguous along their last axis in every dtype.
    In bf16 the kernel reads their rows in 16-byte vectors, so the base
    must be 16-byte aligned and the batch, head (or group) and sequence
    strides multiples of 8 elements; an axis of extent 1 is never stepped,
    so its stride does not matter, and a stride of 0 (a broadcast view)
    reads one row again. dt is read one f32 at a time: any strides.
    """
    if len(shape) == 3:
        return
    if stride[3] != 1:
        raise ValueError(f"{name} must be contiguous along its last dim")
    if dtype != torch.bfloat16:
        return
    if data_ptr % 16:
        raise ValueError(f"bf16 {name} must start at a 16-byte aligned address")
    for axis, (extent, st) in enumerate(zip(shape[:3], stride[:3])):
        if extent > 1 and st % 8:
            raise ValueError(f"bf16 {name}: stride {st} of axis {axis} must be a multiple of 8 elements")


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
    if x.device.type == "cpu":
        rep = h // g
        br = Bm.repeat_interleave(rep, dim=1) if rep > 1 else Bm
        cr = Cm.repeat_interleave(rep, dim=1) if rep > 1 else Cm
        return ref.ssd(x, dt, A, br, cr, init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu tensors, not {x.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, dt, A, Bm, Cm, init_state)):
        # the kernel's output is outside autograd: a loss through it would
        # give its inputs no gradient and raise nothing
        raise NotImplementedError(
            "ssd_scan has no backward kernel yet (it comes with mamba2 training); "
            "call it under torch.no_grad() or on inputs that do not require grad"
        )
    chunk = min(chunk, s)
    if p not in _HEAD_DIMS:
        raise ValueError(f"head_dim {p} not in {_HEAD_DIMS}")
    if n % 16 or n > _MAX_STATE:
        raise ValueError(f"state_dim {n} must be a multiple of 16 up to {_MAX_STATE}")
    if chunk > _MAX_CHUNK:
        raise ValueError(f"chunk {chunk} > {_MAX_CHUNK}")
    for name, t in (("x", x), ("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        check_layout(name, t.shape, t.stride(), t.data_ptr(), t.dtype)
    A = A.contiguous()
    if init_state is not None and (
        init_state.stride(3) != 1 or init_state.stride(2) != p or init_state.stride(1) % 4
        or init_state.stride(0) % 4 or init_state.data_ptr() % 16
    ):  # (N, P) rows, read four f32 at a time
        init_state = init_state.clone(memory_format=torch.contiguous_format)
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
