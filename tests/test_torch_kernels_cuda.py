"""The port's CUDA kernel on the card: held against its plain version, and
driven through the model.

Every test here needs a CUDA device: they carry the ``cuda`` marker and
skip without one. The file imports no JAX, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels.ops import attention_op
from repro_torch.models.model import StreamModel
from repro_torch.models.policy import Policy

pytestmark = pytest.mark.cuda

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    # f32 references on the card: full-precision matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, b, s, h, kv, d, dtype, device):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, getattr(torch, dtype))
        for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,kv,d,causal,window,cap", [
    (1000, 32, 4, 128, True, None, None),
    (300, 8, 2, 64, False, 128, None),
    (257, 4, 4, 128, True, None, 50.0),
])
def test_flash_attention_kernel_on_card(card, dtype, s, h, kv, d, causal, window, cap):
    """The CUDA kernel against its plain version, on the card."""
    q, k, v = _inputs(3, 1, s, h, kv, d, dtype, card)
    before = fa.LAUNCHES
    got = attention_op(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kr, vr = kt.repeat_interleave(h // kv, 1), vt.repeat_interleave(h // kv, 1)
    want = ref.mha(qt, kr, vr, causal=causal, window=window, softcap=cap).transpose(1, 2)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_bf16_kernel_rejects_misaligned_rows(card):
    """The bf16 kernel stages rows with 16-byte loads: a head stride that
    is not a multiple of 8 elements raises before any launch."""
    q, k, v = _inputs(4, 1, 64, 4, 4, 68, "bfloat16", card)
    before = fa.LAUNCHES
    with pytest.raises(ValueError):
        attention_op(q[..., :64], k[..., :64], v[..., :64])
    assert fa.LAUNCHES == before


def test_model_forward_on_card_runs_the_kernel(card):
    """A small dense model on the card launches the kernel once a layer
    and gives the logits its CPU twin (plain attention) gives."""
    cfg = dataclasses.replace(configs.get_reduced("yi-6b"), d_model=128, n_heads=2, n_kv_heads=1, head_dim=64)
    policy = Policy("float32", "float32", "float32")
    on_card = StreamModel(cfg, policy, device=card, generator=0)
    on_cpu = StreamModel(cfg, policy, device="cpu", generator=None)
    on_cpu.load_params(on_card.param_tree())
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (2, 150)))
    before = fa.LAUNCHES
    got = on_card(tokens.to(card))
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), on_cpu(tokens), atol=1e-4, rtol=1e-4)
