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
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref

__all__ = ["LAUNCHES", "check_layout", "flash_attention"]

# kernel launches since import (or since a caller last set it to 0)
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("flash_attention")
        fn = lib.repro_flash_attention_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 4
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
) -> torch.Tensor:
    """Attention over (B, H, S, D) views; returns (B, H, S, D) in q's dtype.

    The output is a (B, H, S, D) view of a contiguous (B, S, H, D) tensor,
    so the model's layout comes back without a copy.
    """
    global LAUNCHES
    _check(q, k, v)
    if q.device.type == "cpu":
        rep = q.shape[1] // k.shape[1]
        kr = k.repeat_interleave(rep, dim=1) if rep > 1 else k
        vr = v.repeat_interleave(rep, dim=1) if rep > 1 else v
        return ref.mha(q, kr, vr, causal=causal, window=window, softcap=softcap)
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
    fn, err_str = _kernel()
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
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
    return out
