"""The port's attention entry point against the JAX package's.

On the CPU the port's ``attention_op`` computes the plain version of its
kernel; the JAX ``attention_op`` runs its Pallas kernel in interpret mode,
as tests/test_kernels.py runs it. Inputs come from numpy seeds; f32 is held
at that file's 2e-5, bf16 at its 2e-2. The CUDA kernel itself is held
against the plain version on the card by tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ops import attention_op as jax_attention_op
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ops import attention_op

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, b, s, h, kv, d):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))
    )


def _both(arrays, dtype, **kw):
    """(JAX attention_op, port attention_op) on the same inputs, as f32 numpy."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    got_j = jax_attention_op(*(jnp.asarray(a, jdt) for a in arrays), **kw)
    kw.pop("block_q", None)
    kw.pop("block_k", None)
    got_t = attention_op(*(torch.from_numpy(a).to(tdt) for a in arrays), **kw)
    return np.asarray(got_j, np.float32), got_t.float().numpy()


@pytest.mark.parametrize("b,h,s,d", [(1, 1, 128, 64), (2, 4, 256, 64), (1, 2, 512, 128)])
@pytest.mark.parametrize("causal,window,cap", [
    (True, None, None), (False, None, None), (True, 128, None), (True, None, 50.0),
])
def test_attention_op_matches_jax(b, h, s, d, causal, window, cap):
    arrays = _inputs(b * 1000 + h, b, s, h, h, d)
    want, got = _both(arrays, "float32", causal=causal, window=window, softcap=cap,
                      block_q=128, block_k=128)
    np.testing.assert_allclose(got, want, atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("blocks", [(64, 64), (128, 64), (64, 128), (256, 256)])
def test_attention_op_matches_jax_block_shapes(blocks):
    arrays = _inputs(0, 1, 256, 2, 2, 64)
    want, got = _both(arrays, "float32", block_q=blocks[0], block_k=blocks[1])
    np.testing.assert_allclose(got, want, atol=TOL["float32"], rtol=TOL["float32"])


def test_attention_op_matches_jax_bf16():
    arrays = _inputs(5, 2, 256, 4, 4, 64)
    want, got = _both(arrays, "bfloat16", block_q=128, block_k=128)
    np.testing.assert_allclose(got, want, atol=TOL["bfloat16"], rtol=TOL["bfloat16"])


def test_attention_op_gqa_matches_jax():
    """Grouped K/V: query head h reads kv head h // (H / Kv)."""
    arrays = _inputs(7, 2, 128, 8, 2, 32)
    want, got = _both(arrays, "float32", block_q=64, block_k=64)
    np.testing.assert_allclose(got, want, atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("causal,window", [(True, None), (True, 64), (False, None)])
def test_attention_op_ragged_matches_jax_ref(causal, window):
    """S = 200 divides no tile: held against the JAX oracle ``ref.mha``."""
    q, k, v = _inputs(11, 1, 200, 8, 2, 64)
    move = lambda a: jnp.moveaxis(jnp.asarray(a), 1, 2)  # noqa: E731
    kr = jnp.repeat(move(k), 4, axis=1)
    vr = jnp.repeat(move(v), 4, axis=1)
    want = np.asarray(jnp.moveaxis(jref.mha(move(q), kr, vr, causal=causal, window=window), 1, 2))
    got = attention_op(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal, window=window)
    assert got.shape == (1, 200, 8, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("window", [None, 64])
def test_attention_op_head_dim_256_matches_jax(window):
    """recurrentgemma's head dim, one kv head over 4 query heads, causal,
    with and without a window shorter than S."""
    arrays = _inputs(13, 1, 256, 4, 1, 256)
    want, got = _both(arrays, "float32", window=window, block_q=128, block_k=128)
    np.testing.assert_allclose(got, want, atol=TOL["float32"], rtol=TOL["float32"])


def test_cpu_path_counts_no_launch():
    before = fa.LAUNCHES
    attention_op(*(torch.from_numpy(a) for a in _inputs(1, 1, 64, 2, 2, 64)))
    assert fa.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "heads", "seq", "rank"])
def test_flash_attention_rejects_bad_inputs(bad):
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 1, 32, 4, 2, 64))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "heads":
        k, v = k[:, :1].expand(1, 3, 32, 64), v[:, :1].expand(1, 3, 32, 64)
    elif bad == "seq":
        k, v = k[:, :, :16], v[:, :, :16]
    else:
        q = q[0]
    with pytest.raises((TypeError, ValueError)):
        fa.flash_attention(q, k, v)



def _view(shape, stride, offset=0, dtype=torch.bfloat16):
    """A (B, heads, S, D) view with element ``stride`` into a fresh buffer,
    ``offset`` elements from its start."""
    n = offset + 1 + sum((d - 1) * st for d, st in zip(shape, stride))
    return torch.zeros(n, dtype=dtype).as_strided(shape, stride, offset)


def _fused_qkv(b, s, h, kv, d):
    """q, k, v as slices of one (B, S, H + 2 Kv, D) projection, in (B, heads, S, D)."""
    buf = torch.zeros((b, s, h + 2 * kv, d), dtype=torch.bfloat16)
    return tuple(t.transpose(1, 2) for t in (buf[:, :, :h], buf[:, :, h:h + kv], buf[:, :, h + kv:]))


@pytest.mark.parametrize("case", [
    "contiguous", "heads_major", "fused_qkv", "padded_heads", "batch_1_odd_batch_stride",
    "heads_1_odd_head_stride", "f32_any_stride",
])
def test_check_layout_accepts(case):
    """Layouts the CUDA kernel takes: head_dim contiguous; in bf16 a 16-byte
    aligned base and positive strides in multiples of 8 elements, except
    along an axis of extent 1, which is never stepped."""
    views = {
        "contiguous": lambda: [torch.zeros((2, 64, 8, 128), dtype=torch.bfloat16).transpose(1, 2)],
        "heads_major": lambda: [torch.zeros((2, 8, 64, 256), dtype=torch.bfloat16)],
        "fused_qkv": lambda: list(_fused_qkv(2, 50, 8, 2, 128)),
        "padded_heads": lambda: [torch.zeros((1, 40, 4, 192), dtype=torch.bfloat16)[..., :128].transpose(1, 2)],
        "batch_1_odd_batch_stride": lambda: [_view((1, 4, 40, 64), (3, 64, 256, 1))],
        "heads_1_odd_head_stride": lambda: [_view((2, 1, 40, 64), (40 * 64, 5, 64, 1))],
        "f32_any_stride": lambda: [_view((2, 3, 40, 64), (3 * 40 * 68, 68, 3 * 68, 1), dtype=torch.float32)],
    }[case]()
    for t in views:
        fa.check_layout("t", t.shape, t.stride(), t.data_ptr(), t.dtype)


@pytest.mark.parametrize("case", [
    "head_dim_96", "head_dim_strided", "misaligned_base", "seq_stride_not_in_8s",
    "head_stride_not_in_8s", "zero_seq_stride", "zero_head_stride",
])
def test_check_layout_refuses(case):
    """Layouts the CUDA kernel does not take raise ValueError before any
    launch: a head_dim other than 64/128/256 or not contiguous; in bf16 a
    base off 16 bytes, or a stride of an axis longer than 1 that is not a
    positive multiple of 8 elements (TMA's 16 bytes)."""
    t = {
        "head_dim_96": lambda: torch.zeros((1, 4, 40, 96), dtype=torch.bfloat16),
        "head_dim_strided": lambda: torch.zeros((1, 4, 64, 40), dtype=torch.float32).transpose(2, 3),
        "misaligned_base": lambda: _view((1, 4, 40, 64), (4 * 40 * 64, 40 * 64, 64, 1), offset=1),
        "seq_stride_not_in_8s": lambda: _view((1, 4, 40, 64), (40 * 260, 64, 260, 1)),
        "head_stride_not_in_8s": lambda: _view((1, 4, 40, 64), (40 * 4 * 72, 68, 4 * 72, 1)),
        "zero_seq_stride": lambda: torch.zeros((1, 4, 1, 64), dtype=torch.bfloat16).expand(1, 4, 40, 64),
        "zero_head_stride": lambda: torch.zeros((1, 1, 40, 64), dtype=torch.bfloat16).expand(1, 4, 40, 64),
    }[case]()
    with pytest.raises(ValueError):
        fa.check_layout("t", t.shape, t.stride(), t.data_ptr(), t.dtype)


@pytest.mark.parametrize("arch,head_dim", [("yi-6b", 128), ("recurrentgemma-9b", 256)])
def test_check_layout_accepts_the_models_views(arch, head_dim):
    """The q, k, v views the model hands the kernel (``_project_qkv``, then
    ``attention_op``'s transpose) in bf16, at the published head dims."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy

    cfg = dataclasses.replace(configs.get_reduced(arch), head_dim=head_dim)
    model = StreamModel(cfg, Policy(compute_dtype="bfloat16"), device="cpu", generator=0)
    kind, _, _, _, p = next(layer for layer in model._layer_params() if layer[0] in ("attn", "local"))
    x = torch.randn((2, 37, cfg.d_model), generator=torch.Generator().manual_seed(0)).bfloat16()
    q, k, v = L._project_qkv(p["mixer"], x, cfg.attn_params(kind), torch.arange(37))
    for name, t in (("q", q), ("k", k), ("v", v)):
        t = t.transpose(1, 2)
        assert t.dtype == torch.bfloat16 and t.shape[-1] == head_dim
        fa.check_layout(name, t.shape, t.stride(), t.data_ptr(), t.dtype)
