"""Flash attention forward: a CUDA kernel written by hand for Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``_attn_kernel``, l.34, and ``flash_attention``, l.115) and computes the
same function as ``ref.mha``: causal / sliding-window / softcap attention
with an online softmax in f32.

What bounds it on the H100: at the prefill shapes (S 512 to 3000, D 128
for yi-6b, 256 for recurrentgemma's windowed local attention) attention
does hundreds of flops for every byte it must move, far above the card's
ridge, so it is bound by the tensor cores' rate (989 TFLOP/s in bf16).
The bf16 kernel (``csrc/flash_attention.cu``), the serving path, keeps
them fed: per (128-query tile, head, batch) block, one producer thread
brings Q once and the K and V tiles through a two-slot TMA ring in shared
memory with mbarriers, and two consumer warpgroups run both products as
``wgmma`` (S = Q.K^T from shared memory; P rounded to bf16 in registers
times the V tile), each running one tile's softmax (base 2, the
per-element mask only on tiles at an edge) under its previous tile's PV
and taking turns with the other to issue. It skips the key tiles the mask
rules out entirely (halving causal work, as ``pl.when`` does on the TPU)
and reads the kv head of each query head from the unrepeated GQA tensors
by the tensor maps' coordinates. It replaces an Ampere-style
``mma.sync`` kernel with no load/compute overlap. ptxas: 168 registers a
thread at launch (then 40 for the producer, 232 for the consumers), no
spills, 83,016 / 164,936 / 197,704 bytes of shared memory at D 64 / 128 /
256. In f32 the products run as FMAs on the CUDA cores, since TF32 would
not hold the f32 tolerance.

The bf16 kernel reads through TMA, which takes a 16-byte aligned data
pointer and batch / sequence / head strides that are positive multiples
of 16 bytes (8 elements) where the extent is above 1;
:func:`check_layout` states what the kernel takes and the wrapper raises
on anything else. On a CPU tensor the wrapper computes the plain version
instead; on a CUDA tensor it launches the kernel or raises.

The gradient. With ``return_lse=True`` the forward also returns each
row's base-2 log-sum-exp (``lse2``, f32 (B, H, S)), and
:func:`flash_attention_bwd` launches the backward kernel
(``csrc/flash_attention_bwd.cu``, no TPU counterpart: JAX differentiates
its plain ``_chunked_attention``) from the saved q, k, v, o and lse2.
:class:`FlashAttention` joins the two as a ``torch.autograd.Function``;
its plain version on the CPU is autograd through ``ref.mha``. The
backward takes head dims 64 and 128 and no softcap.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref

__all__ = [
    "BWD_LAUNCHES",
    "FlashAttention",
    "LAUNCHES",
    "check_bwd_layout",
    "check_layout",
    "flash_attention",
    "flash_attention_bwd",
]

# kernel launches since import (or since a caller last set it to 0)
LAUNCHES = 0
BWD_LAUNCHES = 0  # of the backward's C entry point (three kernels each)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
_BWD_HEAD_DIMS = (64, 128)
_fn = None
_bwd_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("flash_attention")
        fn = lib.repro_flash_attention_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 6
            + [ctypes.c_int64] * 12
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.repro_cuda_error_string)
    return _fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, D) and (B, Kv, S, D)")
    b, h, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != s or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if h % k.shape[1] != 0:
        raise ValueError(f"{h} query heads do not group over {k.shape[1]} kv heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")


def check_layout(name: str, shape, stride, data_ptr: int, dtype: torch.dtype) -> None:
    """Raise ValueError unless the CUDA kernel takes this (B, heads, S, D)
    view of ``shape`` and element ``stride`` starting at ``data_ptr``.

    Every dtype needs a head_dim of 64, 128 or 256, contiguous. bf16 reads
    through TMA tensor maps, which take a 16-byte aligned base and strides
    that are positive multiples of 16 bytes; a dimension of extent 1 is
    never stepped, so its stride does not matter.
    """
    if shape[3] not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {shape[3]} not in {_HEAD_DIMS}")
    if stride[3] != 1:
        raise ValueError(f"{name} must be contiguous along head_dim")
    if dtype != torch.bfloat16:
        return
    if data_ptr % 16:
        raise ValueError(f"bf16 {name} must start at a 16-byte aligned address for TMA")
    for axis, (n, st) in enumerate(zip(shape[:3], stride[:3])):
        if n > 1 and (st <= 0 or st % 8):
            raise ValueError(
                f"bf16 {name}: stride {st} of axis {axis} must be a positive multiple of 8 elements for TMA"
            )


def flash_attention(
    q: torch.Tensor,  # (B, H, S, D), any batch/head/seq strides
    k: torch.Tensor,  # (B, Kv, S, D), H % Kv == 0: query head h reads kv head h // (H / Kv)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    return_lse: bool = False,
):
    """Attention over (B, H, S, D) views; returns (B, H, S, D) in q's dtype,
    and with ``return_lse`` also each row's base-2 log-sum-exp of its
    scaled scores, ``log2(sum_k exp(s_k))``, as a contiguous (B, H, S) f32
    tensor (what :func:`flash_attention_bwd` takes).

    The output is a (B, H, S, D) view of a contiguous (B, S, H, D) tensor,
    so the model's layout comes back without a copy.
    """
    global LAUNCHES
    _check(q, k, v)
    if q.device.type == "cpu":
        kr, vr = _repeat(q, k), _repeat(q, v)
        out = ref.mha(q, kr, vr, causal=causal, window=window, softcap=softcap)
        if not return_lse:
            return out
        sc = ref.scores(q, kr, causal=causal, window=window, softcap=softcap)
        return out, torch.logsumexp(sc, dim=-1) * _LOG2E
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    b, h, s, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_layout(name, t.shape, t.stride(), t.data_ptr(), t.dtype)
    if window is not None and window <= 0:
        raise ValueError("window must be positive")
    if softcap is not None and softcap <= 0:
        raise ValueError("softcap must be positive")
    dev = q.get_device()
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    fn, err_str = _kernel()
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        _DTYPES[q.dtype], b, h, k.shape[1], s, d,
        q.stride(0), q.stride(2), q.stride(1),
        k.stride(0), k.stride(2), k.stride(1),
        v.stride(0), v.stride(2), v.stride(1),
        out.stride(0), out.stride(2), out.stride(1),
        1.0 / math.sqrt(d), int(causal), window or 0, float(softcap or 0.0),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if dev == torch.cuda.current_device():  # the launch goes to the current card
        rc = fn(*args)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: {err_str(rc).decode()} ({rc})")
    LAUNCHES += 1
    return (out, lse) if return_lse else out


_LOG2E = 1.0 / math.log(2.0)


def _repeat(q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """(B, Kv, S, D) -> (B, H, S, D): kv head j serves query heads j*rep .. j*rep + rep - 1."""
    rep = q.shape[1] // kv.shape[1]
    return kv.repeat_interleave(rep, dim=1) if rep > 1 else kv


# ------------------------------------------------------------------ backward
def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        lib = _build.load("flash_attention_bwd")
        fn = lib.repro_flash_attention_bwd
        fn.argtypes = (
            [ctypes.c_void_p] * 10
            + [ctypes.c_int] * 6
            + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _bwd_fn = (fn, lib.repro_cuda_error_string)
    return _bwd_fn


def check_bwd_layout(name: str, shape, stride, data_ptr: int, dtype: torch.dtype) -> None:
    """Raise ValueError unless the backward kernel takes this (B, heads, S,
    D) view: a unit head_dim stride and, in bf16 (read 16 bytes at a
    time), a 16-byte aligned base and batch / sequence / head strides in
    multiples of 8 elements where the extent is above 1. Head dims other
    than 64 and 128 raise NotImplementedError."""
    if shape[3] not in _BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"{name}: the flash-attention backward takes head_dim 64 or 128, not {shape[3]} "
            "(no trained model needs another yet)"
        )
    if stride[3] != 1:
        raise ValueError(f"{name} must be contiguous along head_dim")
    if dtype != torch.bfloat16:
        return
    if data_ptr % 16:
        raise ValueError(f"bf16 {name} must start at a 16-byte aligned address")
    for axis, (n, st) in enumerate(zip(shape[:3], stride[:3])):
        if n > 1 and (st <= 0 or st % 8):
            raise ValueError(f"bf16 {name}: stride {st} of axis {axis} must be a positive multiple of 8 elements")


def _fits_bwd(t: torch.Tensor) -> bool:
    try:
        check_bwd_layout("t", t.shape, t.stride(), t.data_ptr(), t.dtype)
    except ValueError:
        return False
    return True


def flash_attention_bwd(
    q: torch.Tensor,  # (B, H, S, D), as given to the forward
    k: torch.Tensor,  # (B, Kv, S, D)
    v: torch.Tensor,
    o: torch.Tensor,  # (B, H, S, D), the forward's output
    do: torch.Tensor,  # (B, H, S, D), the output's gradient
    lse: torch.Tensor,  # (B, H, S) f32, the forward's base-2 log-sum-exp
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of :func:`flash_attention` (each in its input's dtype and
    shape; dk and dv summed over the query heads of each kv group).

    On CPU tensors the plain version: autograd through ``ref.mha``. On
    CUDA tensors it launches the backward kernel or raises: softcap and
    head dims other than 64 and 128 raise NotImplementedError.
    """
    global BWD_LAUNCHES
    _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse {tuple(lse.shape)} do not match q {tuple(q.shape)}")
    if q.device.type == "cpu":
        with torch.enable_grad():
            qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = ref.mha(qq, _repeat(qq, kk), _repeat(qq, vv), causal=causal, window=window, softcap=softcap)
            return torch.autograd.grad(out, (qq, kk, vv), do)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors, not {q.device}")
    if softcap is not None:
        raise NotImplementedError("the flash-attention backward takes no softcap yet (no trained model needs it)")
    if window is not None and window <= 0:
        raise ValueError("window must be positive")
    if do.dtype != q.dtype or o.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"o and do must be {q.dtype} and lse float32, got {o.dtype}, {do.dtype}, {lse.dtype}")
    if not _fits_bwd(do):  # autograd's gradient may come in any layout
        do = do.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        check_bwd_layout(name, t.shape, t.stride(), t.data_ptr(), t.dtype)
    lse = lse.contiguous()
    b, h, s, d = q.shape
    kv = k.shape[1]
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((b, s, kv, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((b, s, kv, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 24)(*(
        st for t in (q, k, v, o, do, dq, dk, dv) for st in (t.stride(0), t.stride(2), t.stride(1))
    ))
    fn, err_str = _bwd_kernel()
    dev = q.get_device()
    with torch.cuda.device(dev):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPES[q.dtype], b, h, kv, s, d, ctypes.cast(strides, ctypes.c_void_p),
            1.0 / math.sqrt(d), int(causal), window or 0,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: {err_str(rc).decode()} ({rc})")
    BWD_LAUNCHES += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K1 forward (with its row log-sum-exp) and the backward kernel as
    one differentiable op over (B, H, S, D) views; on CPU tensors both
    sides are the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int | None, softcap: float | None):
        if q.device.type == "cuda" and (softcap is not None or q.shape[3] not in _BWD_HEAD_DIMS):
            raise NotImplementedError(
                f"no flash-attention backward for head_dim {q.shape[3]}"
                + (" with softcap" if softcap is not None else "")
                + ": it takes head_dim 64 or 128 and no softcap"
            )
        out, lse = flash_attention(q, k, v, causal=causal, window=window, softcap=softcap, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap = ctx.opts
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window, softcap=softcap)
        return dq, dk, dv, None, None, None
