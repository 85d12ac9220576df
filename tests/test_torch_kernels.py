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

