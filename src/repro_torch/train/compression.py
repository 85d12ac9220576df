"""Gradient compression for the data-parallel all-reduce (port of
``repro.train.compression``) over a ``torch.distributed`` process group.

Two phases a leaf, as in the JAX package:

  1. ``reduce_scatter_tensor`` of the flat gradient in bf16 (a sum): each
     rank keeps the sum of its contiguous 1/n of the leaf, which it
     divides by n in f32;
  2. that shard quantized to int8 codes with one f32 absmax scale a
     256-element block (:func:`int8_encode`), and codes and scales
     ``all_gather_into_tensor``-ed in rank order, so every rank decodes
     the same mean (:func:`int8_decode`).

Lossy only in phase 2, and every rank decodes the same codes, so the
replicas stay bit-identical. A leaf whose size is not a multiple of
n * 256 takes the plain f32 mean instead (``all_reduce``, then / n), as
JAX's does. Leaves are visited in JAX's order (sorted keys). Used by
``repro_torch.train.trainer.dp_train_step``.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.train.optimizer import tree_leaves, tree_unflatten

__all__ = ["compressed_psum_mean", "gathered_codes", "int8_decode", "int8_encode", "psum_mean"]

_BLOCK = 256


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d by IEEE division, as the reference divides: the divisor a 0-d
    tensor on x's device (CUDA divides by a Python number through its
    reciprocal, whose product rounds otherwise on about 4% of values)."""
    return x / x.new_full((), d)


def int8_encode(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Flatten, pad with zeros to whole blocks of 256, and quantize each
    block by its absmax / 127 (a zero scale divides by 1): codes rounded
    half to even and clipped to +-127. Returns (codes (nb, 256) int8,
    scales (nb,) f32)."""
    flat = x.reshape(-1)
    n = flat.numel()
    npad = -(-n // _BLOCK) * _BLOCK
    if npad != n:
        flat = F.pad(flat, (0, npad - n))
    blocks = flat.reshape(-1, _BLOCK).float()
    scale = _div(blocks.abs().amax(dim=-1, keepdim=True), 127.0)
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return codes, scale[:, 0]


def int8_decode(codes: torch.Tensor, scales: torch.Tensor, shape, dtype) -> torch.Tensor:
    """Codes times their block's scale in f32, cut to ``shape``, cast to
    ``dtype``."""
    out = codes.float() * scales[:, None]
    return out.reshape(-1)[: math.prod(shape)].reshape(shape).to(dtype)


def psum_mean(g: torch.Tensor, group=None) -> torch.Tensor:
    """The plain mean of ``g`` over the group: an f32 sum, / n, cast back."""
    t = g.float().clone()
    dist.all_reduce(t, group=group)
    return _div(t, dist.get_world_size(group)).to(g.dtype)


def gathered_codes(g: torch.Tensor, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Phases 1 and 2 of one leaf whose size is a multiple of n * 256: the
    bf16 reduce-scatter, / n in f32, the encode, and the all-gather.
    Returns every rank's (codes (nb, 256), scales (nb,)), rank 0's first."""
    n = dist.get_world_size(group)
    flat = g.reshape(-1).to(torch.bfloat16).contiguous()
    shard = torch.empty(flat.numel() // n, dtype=torch.bfloat16, device=flat.device)
    dist.reduce_scatter_tensor(shard, flat, group=group)
    codes, scales = int8_encode(_div(shard.float(), n))
    codes_g = codes.new_empty((n * codes.shape[0], _BLOCK))
    scales_g = scales.new_empty((n * scales.shape[0],))
    dist.all_gather_into_tensor(codes_g, codes, group=group)
    dist.all_gather_into_tensor(scales_g, scales, group=group)
    return codes_g, scales_g


def compressed_psum_mean(grads, group=None):
    """Mean-all-reduce a gradient tree over ``group`` (the default group
    when None): each leaf through :func:`gathered_codes` and decoded in
    its shape and dtype, or, where its size is not a multiple of n * 256,
    through :func:`psum_mean`. Returns a new tree."""
    n = dist.get_world_size(group)
    out = []
    for g in tree_leaves(grads):
        if g.numel() % (n * _BLOCK):
            out.append(psum_mean(g, group))
        else:
            out.append(int8_decode(*gathered_codes(g, group), g.shape, g.dtype))
    return tree_unflatten(grads, out)
