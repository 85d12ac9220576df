"""The 8-bit AdamW update of one leaf: a CUDA kernel written by hand for Hopper.

No TPU kernel stands behind it: the JAX package's ``adamw8bit`` is XLA
ops (``src/repro/train/optimizer.py:237-247``, ``upd``), which XLA fuses
into a few loops. Written as eager torch ops the same update makes some
twenty passes over each parameter (dequantize, log2, exp2, the block
reductions, requantize), so the port does it in one kernel
(``csrc/adamw8bit.cu``): read p, g, the m codes and scale and the v codes
and ``(lo, step)``; scale g by the global-norm clip (a device scalar from
``kernels.grad_norm``) as it is read; dequantize; update m, v and p in f32
in ``upd``'s order; requantize m (absmax) and v (log2 grid); write p, the
codes and the scales in place. Its plain version is
``ref.adamw8bit_update``.

What bounds it on the H100: its arithmetic, against about 10 bytes an
element (bf16 p read and written, g read, each code read and written, the
scales). The design cuts the arithmetic without changing a bit:
reciprocals with an exact correction in place of IEEE divisions, no
branch among an element's operations, no conversion instructions,
redux.sync for the block reductions, a persistent grid of 4 thread blocks
an SM (the source's note holds the measurements).

On a CPU tensor the wrapper computes the plain version instead; on a CUDA
tensor it launches the kernel or raises. On meta tensors (the dry run,
``launch/dryrun.py``) it records the update's work (``kernels/cost.py``),
launching nothing and counting no launch: the update is in place.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cost, ref

__all__ = ["LAUNCHES", "adamw8bit_update", "check"]

# kernel launches since import (or since a caller last set it to 0)
LAUNCHES = 0

_fn = None


def _bind(lib: ctypes.CDLL):
    fn = lib.repro_adamw8bit_update
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 2 + [ctypes.c_float] * 9 + [
        ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_cuda_error_string


def _kernel():
    global _fn
    if _fn is None:
        _fn = _bind(_build.load("adamw8bit"))
    return _fn


def check(p, g, m_codes, m_scales, v_codes, v_scales) -> None:
    """Raise on what the update does not take: dtypes, shapes, devices."""
    if p.dim() == 0:
        raise ValueError("adamw8bit blocks the trailing dim: a 0-d leaf has none")
    if p.dtype not in (torch.float32, torch.bfloat16) or g.dtype not in (p.dtype, torch.float32):
        raise TypeError(f"p must be f32 or bf16 and g of its dtype or f32, got {p.dtype} and {g.dtype}")
    if m_codes.dtype != torch.int8 or v_codes.dtype != torch.int8:
        raise TypeError(f"codes must be int8, got {m_codes.dtype} and {v_codes.dtype}")
    if m_scales.dtype != torch.float32 or v_scales.dtype != torch.float32:
        raise TypeError(f"scales must be f32, got {m_scales.dtype} and {v_scales.dtype}")
    nblk = ref.pad_to_block(p.shape[-1]) // ref.QBLOCK
    want = {
        "g": (g, tuple(p.shape)), "m codes": (m_codes, tuple(p.shape)), "v codes": (v_codes, tuple(p.shape)),
        "m scales": (m_scales, tuple(p.shape[:-1]) + (nblk,)),
        "v scales": (v_scales, tuple(p.shape[:-1]) + (nblk, 2)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape} for a leaf of {tuple(p.shape)}")
    if any(t.device != p.device for t, _ in want.values()):
        raise ValueError("adamw8bit_update inputs must lie on one device")


def adamw8bit_update(
    p: torch.Tensor,  # (..., n) f32 or bf16, updated in place
    g: torch.Tensor,  # (..., n) p's dtype (or f32 for a bf16 p), read only
    m_codes: torch.Tensor,  # (..., n) int8, in place
    m_scales: torch.Tensor,  # (..., nblk) f32, in place
    v_codes: torch.Tensor,  # (..., n) int8, in place
    v_scales: torch.Tensor,  # (..., nblk, 2) f32 (lo, step), in place
    *,
    lr: torch.Tensor,  # 0-d f32 on the host
    bc1: torch.Tensor,  # 0-d f32 on the host
    bc2: torch.Tensor,  # 0-d f32 on the host
    b1: float,
    b2: float,
    eps: float,
    weight_decay: float,
    clip_scale: torch.Tensor | None = None,  # 0-d f32 on p's device: g's clip scale; None: g as given
) -> None:
    """One leaf of ``adamw8bit``'s update, in place (nblk = ceil(n / 256)).
    g may be f32 for a bf16 p (a microbatched step's f32 sums): then each
    layer slice of p is updated in f32 and rounded back, one launch a
    slice."""
    check(p, g, m_codes, m_scales, v_codes, v_scales)
    if clip_scale is not None and (clip_scale.dtype != torch.float32 or clip_scale.numel() != 1
                                   or clip_scale.device != p.device):
        raise ValueError(f"clip_scale must be one f32 on {p.device}, got {clip_scale.dtype} {tuple(clip_scale.shape)} "
                         f"on {clip_scale.device}")
    if p.device.type == "cpu":
        ref.adamw8bit_update(p, g, m_codes, m_scales, v_codes, v_scales, lr=lr, bc1=bc1, bc2=bc2, b1=b1, b2=b2, eps=eps,
                             weight_decay=weight_decay, clip_scale=clip_scale)
        return
    if p.device.type not in ("cuda", "meta"):
        raise ValueError(f"adamw8bit_update runs on cuda or cpu tensors, not {p.device}")
    tensors = (p, g, m_codes, m_scales, v_codes, v_scales)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("adamw8bit_update updates contiguous leaves in place")
    if p.numel() == 0:
        return
    scalars = (lr, bc1, bc2, b1, b2, eps, weight_decay, clip_scale)
    if g.dtype == p.dtype:
        _update(tensors, scalars)
        return
    # f32 gradients of a bf16 leaf (a microbatched step sums them in f32, as
    # JAX's does): the f32 kernel on an f32 copy of each layer slice of p,
    # rounded back to bf16 to nearest even, as the bf16 kernel stores it
    for ps, *rest in zip(*(ref.layer_slices(t, p) for t in tensors)):
        pf = ps.float()
        _update((pf, *rest), scalars)
        ps.copy_(pf)


def _update(tensors: tuple, scalars: tuple) -> None:
    """One launch of the kernel on checked, contiguous, non-empty tensors
    of one dtype; on meta tensors (the dry run) the update's work is
    recorded instead, with no launch and no count."""
    global LAUNCHES
    p, g, m_codes, m_scales, v_codes, v_scales = tensors
    lr, bc1, bc2, b1, b2, eps, weight_decay, clip_scale = scalars
    if p.device.type == "meta":
        cost.record("adamw8bit", cost.opt8_work([p]))
        return
    n = p.shape[-1]
    # 8 neighbouring elements a lane (16-byte loads) where every row starts
    # on 8 elements and every base on 16 bytes; else one element a lane per
    # 32 (any n, any alignment)
    vec = n % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
    fn, err_str = _kernel()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = fn(
            p.data_ptr(), g.data_ptr(), m_codes.data_ptr(), m_scales.data_ptr(), v_codes.data_ptr(),
            v_scales.data_ptr(), p.numel() // n, n, int(p.dtype == torch.bfloat16), int(vec),
            # the host's f32 scalars: no sync on the card
            float(lr), b1, 1 - b1, b2, 1 - b2, eps, weight_decay, float(bc1), float(bc2),
            None if clip_scale is None else clip_scale.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"adamw8bit launch failed: {err_str(rc).decode()} ({rc})")
    LAUNCHES += 1
