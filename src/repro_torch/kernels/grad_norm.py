"""The global gradient norm and its clip scale: CUDA kernels written by hand for Hopper.

No TPU kernel stands behind it: the JAX package's ``clip_by_global_norm``
is XLA ops (``src/repro/train/optimizer.py:48-52``). Written as eager torch
ops, the clip of a tree of bf16 gradients squares, sums, scales and casts
each layer slice in passes of their own and writes the gradients back;
the port's ``adamw8bit`` needs only the scale, which its update kernel
applies as it reads g. So the norm is two kernels
(``csrc/grad_norm.cu``): one launch a leaf writes f32 partial sums of its
squares into one scratch buffer, and a one-block launch adds them in a
fixed order and writes ``(norm, scale)`` to the device, with no sync and
the same bits on every call. Its plain version is ``ref.global_norm``.

What bounds it on the H100: the bytes of the gradients, each read once (2
an element in bf16); 16-byte loads, four in flight a thread.

On CPU tensors the wrapper computes the plain version instead; on CUDA
tensors it launches the kernels or raises. On meta tensors (the dry run, ``launch/dryrun.py``) it allocates what
the card path allocates and records the kernel's work
(``kernels/cost.py``), launching nothing and counting no launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cost, ref

__all__ = ["LAUNCHES", "check", "global_norm"]

# kernel launches since import (or since a caller last set it to 0): one a
# non-empty leaf and one for the final sum, a call
LAUNCHES = 0

_fns = None


def _kernel():
    global _fns
    if _fns is None:
        lib = _build.load("grad_norm")
        lib.repro_grad_sumsq_parts.argtypes = [ctypes.c_int64]
        lib.repro_grad_sumsq_parts.restype = ctypes.c_int64
        lib.repro_grad_sumsq.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_void_p]
        lib.repro_grad_sumsq.restype = ctypes.c_int
        lib.repro_grad_norm_finish.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p,
                                               ctypes.c_void_p]
        lib.repro_grad_norm_finish.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _fns = lib
    return _fns


def check(leaves: list[torch.Tensor]) -> None:
    """Raise on what the norm does not take: no leaves, dtypes, devices."""
    if not leaves:
        raise ValueError("global_norm needs at least one leaf")
    for g in leaves:
        if g.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"gradients must be f32 or bf16, got {g.dtype}")
        if g.device != leaves[0].device:
            raise ValueError("global_norm's leaves must lie on one device")


def _parts(numel: int) -> int:
    """``repro_grad_sumsq_parts`` (``csrc/grad_norm.cu``) in Python: a
    partial sum per PART_ELEMS (65536) elements, at most MAX_PARTS (1024)
    a leaf; ``chip_smoke.py`` holds the two equal on the card."""
    return min(-(-numel // 65536), 1024) if numel > 0 else 0


def _meta_norm(leaves: list[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """The card path on meta tensors, for the dry run: the partial sums'
    scratch and the (norm, scale) pair, and the norm's work recorded; no
    launch, no count."""
    dev = leaves[0].device
    partials = torch.empty(max(sum(_parts(g.numel()) for g in leaves), 1), dtype=torch.float32, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    cost.record("grad_norm", cost.norm_work(leaves))
    del partials  # the kernels' scratch, live for their span
    return out[0], out[1]


def global_norm(leaves: list[torch.Tensor], max_norm: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(norm, scale) of the gradient ``leaves`` as 0-d f32 tensors on their
    device: scale = min(1, max_norm / (norm + 1e-9)) in ``ref.global_norm``'s
    form."""
    global LAUNCHES
    check(leaves)
    dev = leaves[0].device
    if dev.type == "cpu":
        return ref.global_norm(leaves, max_norm)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"global_norm runs on cuda or cpu tensors, not {dev}")
    if not all(g.is_contiguous() for g in leaves):
        raise ValueError("global_norm reads contiguous leaves")
    if dev.type == "meta":
        return _meta_norm(leaves)
    lib = _kernel()
    parts = [lib.repro_grad_sumsq_parts(g.numel()) for g in leaves]
    partials = torch.empty(max(sum(parts), 1), dtype=torch.float32, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        at = 0
        for g, n in zip(leaves, parts):
            if n == 0:
                continue
            vec = g.data_ptr() % 16 == 0
            rc = lib.repro_grad_sumsq(g.data_ptr(), g.numel(), int(g.dtype == torch.bfloat16), int(vec),
                                      partials.data_ptr() + 4 * at, stream)
            if rc != 0:
                raise RuntimeError(f"grad_norm launch failed: {lib.repro_cuda_error_string(rc).decode()} ({rc})")
            LAUNCHES += 1
            at += n
        rc = lib.repro_grad_norm_finish(partials.data_ptr(), at, float(max_norm), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"grad_norm launch failed: {lib.repro_cuda_error_string(rc).decode()} ({rc})")
    LAUNCHES += 1
    return out[0], out[1]
