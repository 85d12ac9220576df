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


# ------------------------------------------------------------------ backward
@pytest.mark.parametrize("b,h,kv,s,d,causal,window", [
    (2, 4, 2, 33, 64, True, None),
    (1, 8, 1, 40, 128, True, 7),
    (1, 2, 2, 20, 64, False, None),
])
def test_attention_gradient_matches_jax(b, h, kv, s, d, causal, window):
    """Under grad mode ``attention_op`` goes through ``FlashAttention``,
    whose plain version on the CPU is autograd through ``ref.mha``; its
    gradients (dk, dv summed over each kv group) against ``jax.grad`` of
    the JAX oracle on repeated K/V, at 1e-5 of each gradient's largest
    element (f32)."""
    import jax

    q, k, v = _inputs(11, b, s, h, kv, d)
    do = np.random.default_rng(12).standard_normal((b, s, h, d)).astype(np.float32)
    rep = h // kv

    def jloss(q, k, v):
        t = lambda x: jnp.swapaxes(x, 1, 2)
        kr, vr = jnp.repeat(t(k), rep, axis=1), jnp.repeat(t(v), rep, axis=1)
        out = jref.mha(t(q), kr, vr, causal=causal, window=window)
        return jnp.sum(t(out) * do)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = attention_op(tq, tk, tv, causal=causal, window=window)
    assert "FlashAttention" in type(out.grad_fn).__name__ or any(
        "FlashAttention" in type(f[0]).__name__ for f in out.grad_fn.next_functions if f[0] is not None
    )
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_attention_op_serves_without_the_function():
    """No grad (or no input that requires it): the forward alone, as it serves."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(13, 1, 16, 4, 2, 64))
    assert attention_op(q, k, v).grad_fn is None
    with torch.no_grad():
        assert attention_op(q.requires_grad_(True), k, v).grad_fn is None


def test_flash_attention_returns_base2_lse_on_cpu():
    q, k, v = (torch.from_numpy(x).transpose(1, 2) for x in _inputs(14, 2, 24, 4, 2, 64))
    out, lse = fa.flash_attention(q, k, v, causal=True, window=9, return_lse=True)
    assert lse.shape == (2, 4, 24) and lse.dtype == torch.float32
    sc = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(2, 1)) / 8.0
    pos = torch.arange(24)
    ok = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - 9)
    want = torch.logsumexp(sc.masked_fill(~ok, float("-inf")), -1) / np.log(2.0)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(out, fa.flash_attention(q, k, v, causal=True, window=9))


@pytest.mark.parametrize("case", ["contiguous", "fused_qkv", "batch_1_odd_batch_stride", "f32_any_stride"])
def test_check_bwd_layout_accepts(case):
    """The backward kernel reads bf16 16 bytes at a time: a 16-byte aligned
    base, strides in multiples of 8 elements (an axis of extent 1 is never
    stepped), head_dim contiguous; f32 any strides."""
    views = {
        "contiguous": lambda: [torch.zeros((2, 64, 8, 128), dtype=torch.bfloat16).transpose(1, 2)],
        "fused_qkv": lambda: list(_fused_qkv(2, 50, 8, 2, 64)),
        "batch_1_odd_batch_stride": lambda: [_view((1, 4, 40, 64), (3, 64, 256, 1))],
        "f32_any_stride": lambda: [_view((2, 3, 40, 64), (3 * 40 * 68, 68, 3 * 68, 1), dtype=torch.float32)],
    }[case]()
    for t in views:
        fa.check_bwd_layout("t", t.shape, t.stride(), t.data_ptr(), t.dtype)


@pytest.mark.parametrize("case,err", [
    ("head_dim_256", NotImplementedError),
    ("head_dim_96", NotImplementedError),
    ("head_dim_strided", ValueError),
    ("misaligned_base", ValueError),
    ("seq_stride_not_in_8s", ValueError),
    ("zero_head_stride", ValueError),
])
def test_check_bwd_layout_refuses(case, err):
    t = {
        "head_dim_256": lambda: torch.zeros((1, 4, 40, 256), dtype=torch.bfloat16),
        "head_dim_96": lambda: torch.zeros((1, 4, 40, 96), dtype=torch.float32),
        "head_dim_strided": lambda: torch.zeros((1, 4, 64, 40), dtype=torch.float32).transpose(2, 3),
        "misaligned_base": lambda: _view((1, 4, 40, 64), (4 * 40 * 64, 40 * 64, 64, 1), offset=1),
        "seq_stride_not_in_8s": lambda: _view((1, 4, 40, 64), (40 * 260, 64, 260, 1)),
        "zero_head_stride": lambda: torch.zeros((1, 1, 40, 64), dtype=torch.bfloat16).expand(1, 4, 40, 64),
    }[case]()
    with pytest.raises(err):
        fa.check_bwd_layout("t", t.shape, t.stride(), t.data_ptr(), t.dtype)


def test_cpu_backward_counts_no_launch():
    fa.BWD_LAUNCHES = 0
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _inputs(15, 1, 16, 4, 2, 64))
    attention_op(q, k, v).sum().backward()
    assert fa.BWD_LAUNCHES == 0 and q.grad is not None
