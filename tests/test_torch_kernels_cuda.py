"""The port's CUDA kernels on the card: each held against its plain version,
and driven through a model.

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
from repro_torch.kernels import rglru_scan as K3
from repro_torch.kernels import ssd_scan as K2
from repro_torch.kernels.ops import attention_op, rglru_op, ssd_op
from repro_torch.models.model import StreamModel
from repro_torch.models.policy import Policy

pytestmark = pytest.mark.cuda

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py
# the SSD scan's: error relative to max(|want|.max(), 1), tests/test_kernels.py:66-74
SSD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}


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
    (1000, 16, 1, 256, True, 128, None),  # recurrentgemma's heads, ragged S
    (2500, 4, 1, 256, True, 2048, None),  # its window, whose skipped key tiles matter past S 2048
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
    """The bf16 kernel reads through TMA, whose strides are multiples of
    16 bytes: a head stride that is not a multiple of 8 elements raises
    before any launch."""
    q, k, v = _inputs(4, 1, 64, 4, 4, 68, "bfloat16", card)
    before = fa.LAUNCHES
    with pytest.raises(ValueError):
        attention_op(q[..., :64], k[..., :64], v[..., :64])
    assert fa.LAUNCHES == before


def _hold_attention(q, k, v, causal=True, window=None, cap=None):
    """attention_op on the card against ref.mha on repeated K/V, at
    chip_smoke.py's criterion |got - want| <= tol + tol |want|; one launch."""
    h, kv = q.shape[2], k.shape[2]
    before = fa.LAUNCHES
    got = attention_op(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    assert got.shape == q.shape and got.dtype == q.dtype
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kr, vr = kt.repeat_interleave(h // kv, 1), vt.repeat_interleave(h // kv, 1)
    want = ref.mha(qt, kr, vr, causal=causal, window=window, softcap=cap).transpose(1, 2)
    tol = TOL[str(q.dtype).removeprefix("torch.")]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# The bf16 kernel's tiles: 128 query rows a block (two warpgroups of 64),
# key tiles of 128 at D 64 / 128 and 64 at D 256; S around each edge
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 1000, 2047])
def test_flash_attention_bf16_tile_edges(card, s, d):
    """Ragged S at and around the query and key tiles' edges, causal."""
    _hold_attention(*_inputs(s + d, 2, s, 4, 2, d, "bfloat16", card))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("window", [127, 128, 129])
def test_flash_attention_bf16_window_edges(card, window, d, causal):
    """Windows one short of, at and one past a tile, causal or not: the
    window's edge cuts key tiles the kernel masks, and tiles wholly outside
    it are skipped."""
    _hold_attention(*_inputs(window + d, 1, 700, 4, 1, d, "bfloat16", card), causal=causal, window=window)


@pytest.mark.parametrize("rep", [1, 4, 16])
def test_flash_attention_bf16_gqa(card, rep):
    """Query head h reads kv head h // rep through the tensor maps' coordinates."""
    _hold_attention(*_inputs(rep, 1, 300, 16, 16 // rep, 128, "bfloat16", card))


@pytest.mark.parametrize("d,s,causal", [(128, 512, False), (128, 1000, True), (256, 512, False)])
def test_flash_attention_bf16_softcap(card, d, s, causal):
    """Softcap 50 applies on every tile, the interior ones (no mask) too."""
    q, k, v = _inputs(d + s, 1, s, 4, 2, d, "bfloat16", card)
    _hold_attention(q * 8, k * 8, v, causal=causal, cap=50.0)  # scores of tens: the cap bites


def _strided_views(case, b, s, h, kv, d, device):
    """(q, k, v) in model layout (B, S, heads, D), not contiguous."""
    rng = np.random.default_rng(17)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, torch.bfloat16)

    if case == "fused_qkv":  # slices of one (B, S, H + 2 Kv, D) projection
        buf = t(b, s, h + 2 * kv, d)
        return buf[:, :, :h], buf[:, :, h:h + kv], buf[:, :, h + kv:]
    if case == "padded_heads":  # rows of D + 64, the last 64 unused
        return t(b, s, h, d + 64)[..., :d], t(b, s, kv, d + 64)[..., :d], t(b, s, kv, d + 64)[..., :d]
    # heads-major memory: (B, heads, S, D) tensors seen in model layout
    return t(b, h, s, d).transpose(1, 2), t(b, kv, s, d).transpose(1, 2), t(b, kv, s, d).transpose(1, 2)


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("case", ["fused_qkv", "padded_heads", "heads_major"])
def test_flash_attention_bf16_strided_views(card, case, d):
    """Non-contiguous q, k, v views, read through the strides in the tensor maps."""
    q, k, v = _strided_views(case, 2, 333, 8, 2, d, card)
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    _hold_attention(q, k, v)


@pytest.mark.parametrize("case", ["misaligned_base", "seq_stride_not_in_8s", "zero_seq_stride", "head_dim_96"])
def test_flash_attention_bf16_rejects_layouts_tma_does_not_take(card, case):
    """What TMA does not take raises before any launch."""
    q, k, v = _inputs(4, 1, 64, 4, 4, 64, "bfloat16", card)
    if case == "misaligned_base":  # one element past a 16-byte boundary
        flat = torch.zeros(q.numel() + 1, dtype=q.dtype, device=card)
        q = flat[1:].view(q.shape)
    elif case == "seq_stride_not_in_8s":
        q = torch.zeros((1, 64, 4 * 64 + 4), dtype=q.dtype, device=card)[..., :256].unflatten(-1, (4, 64))
    elif case == "zero_seq_stride":
        k = k[:, :1].expand(k.shape)
    else:
        q, k, v = (torch.zeros((1, 64, 4, 96), dtype=q.dtype, device=card) for _ in range(3))
    before = fa.LAUNCHES
    with pytest.raises(ValueError):
        attention_op(q, k, v)
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


def _ssd_inputs(seed, b, s, h, p, n, g, dtype, device, state):
    rng = np.random.default_rng(seed)

    def t(*shape, dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, getattr(torch, dt))

    x, bm, cm = t(b, s, h, p), t(b, s, g, n), t(b, s, g, n)
    dt = torch.nn.functional.softplus(t(b, s, h, dt="float32"))
    A = -torch.exp(t(h, dt="float32"))
    st0 = t(b, h, n, p, dt="float32") if state else None
    return x, dt, A, bm, cm, st0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,g,chunk,state", [
    (2, 256, 4, 64, 128, 2, 64, True),  # grouped, chunks divide S
    (1, 300, 8, 32, 64, 1, 128, True),  # ragged last chunk
    (1, 64, 4, 16, 32, 4, 64, False),  # one group a head, zero initial state
    (1, 100, 80, 64, 128, 1, 256, False),  # mamba2's heads, S shorter than the chunk
])
def test_ssd_kernel_on_card(card, dtype, b, s, h, p, n, g, chunk, state):
    """The CUDA kernel against its plain version (groups repeated), on the card."""
    x, dt, A, bm, cm, st0 = _ssd_inputs(7 + s, b, s, h, p, n, g, dtype, card, state)
    before = K2.LAUNCHES
    y, st = ssd_op(x, dt, A, bm, cm, st0, chunk=chunk)
    torch.cuda.synchronize()
    assert K2.LAUNCHES == before + 1
    rep = h // g
    yr, sr = ref.ssd(
        x.transpose(1, 2), dt.transpose(1, 2), A,
        bm.transpose(1, 2).repeat_interleave(rep, 1), cm.transpose(1, 2).repeat_interleave(rep, 1), st0,
    )
    assert y.dtype == x.dtype and st.dtype == torch.float32
    for got, want in ((y, yr.transpose(1, 2)), (st, sr)):
        err = float((got.float() - want.float()).abs().max() / max(float(want.float().abs().max()), 1.0))
        assert err < SSD_TOL[dtype], err


def test_ssd_kernel_chunk_invariance(card):
    """As tests/test_models.py:122 holds ``ssd_chunked``: the kernel's y and
    final state do not depend on the chunk (24 divides no tile and leaves a
    ragged last chunk; 256 is longer than S)."""
    x, dt, A, bm, cm, st0 = _ssd_inputs(1, 1, 64, 2, 16, 16, 1, "float32", card, True)
    outs = [ssd_op(x, dt, A, bm, cm, st0, chunk=c) for c in (8, 16, 24, 32, 64, 256)]
    for y, st in outs[1:]:
        torch.testing.assert_close(y, outs[0][0], atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(st, outs[0][1], atol=1e-4, rtol=1e-4)


def test_ssd_kernel_rejects_unsupported_shapes(card):
    """Head dims other than 16/32/64 and state dims off the multiple of 16
    raise before any launch."""
    before = K2.LAUNCHES
    for p, n in ((48, 32), (32, 24)):
        x, dt, A, bm, cm, _ = _ssd_inputs(1, 1, 32, 2, p, n, 1, "float32", card, False)
        with pytest.raises(ValueError):
            ssd_op(x, dt, A, bm, cm)
    assert K2.LAUNCHES == before


# the bf16 kernel's edges (chunk-parallel, wgmma): each call held to its
# plain version by chip_smoke.check_ssd's two criteria at SSD_TOL, the
# error relative to max(|want|.max(), 1) and, element by element,
# |got - want| <= tol (rms(want) + |want|); dt on the bf16 grid, where the
# plain version's x * dt rounding (ref.py:62) and the kernel's
# (ssd_scan.py:117) are the same number
def _bf16_case(seed, b, s, h, p, n, g, state, device):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)

    x, bm, cm = t(b, s, h, p).bfloat16(), t(b, s, g, n).bfloat16(), t(b, s, g, n).bfloat16()
    dt = torch.nn.functional.softplus(t(b, s, h)).bfloat16().float()
    A = -torch.exp(t(h))
    st0 = {None: None, "zero": torch.zeros((b, h, n, p), device=device), "random": t(b, h, n, p)}[state]
    return x, dt, A, bm, cm, st0


def _held(got, want, tol):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rel = float(err.max()) / max(float(want.abs().max()), 1.0)
    el = float((err / (float(want.square().mean().sqrt()) + want.abs())).max())
    return bool(torch.isfinite(got).all()) and rel < tol and el <= tol, (rel, el)


def _hold_ssd(x, dt, A, bm, cm, st0, chunk, tol=SSD_TOL["bfloat16"]):
    """One kernel call (one launch counted) against ref.ssd; returns (y, state)."""
    before = K2.LAUNCHES
    y, st = ssd_op(x, dt, A, bm, cm, st0, chunk=chunk)
    torch.cuda.synchronize()
    assert K2.LAUNCHES == before + 1
    assert y.shape == x.shape and y.dtype == x.dtype and st.dtype == torch.float32
    rep = x.shape[2] // bm.shape[2]
    yr, sr = ref.ssd(
        x.transpose(1, 2), dt.transpose(1, 2), A, bm.transpose(1, 2).repeat_interleave(rep, 1),
        cm.transpose(1, 2).repeat_interleave(rep, 1), st0,
    )
    for name, got, want in (("y", y, yr.transpose(1, 2)), ("state", st, sr)):
        ok, errs = _held(got, want, tol)
        assert ok, (name, errs)
    return y, st


@pytest.mark.parametrize("s", [1, 63, 64, 65, 255, 256, 257, 2000, 2015])
def test_ssd_bf16_sequence_edges(card, s):
    """S at the 64-row tiles' and the 256-position chunks' edges, and the
    serving and forward lengths; a random initial state."""
    _hold_ssd(*_bf16_case(s, 1, s, 4, 64, 128, 1, "random", card), chunk=256)


@pytest.mark.parametrize("chunk", [8, 64, 100, 256])
def test_ssd_bf16_chunks(card, chunk):
    """Chunks that are shorter than a tile, one tile, ragged (100) and
    four tiles, over a ragged S."""
    _hold_ssd(*_bf16_case(chunk, 2, 300, 4, 64, 128, 2, "random", card), chunk=chunk)


@pytest.mark.parametrize("g", [1, 2, 8])
def test_ssd_bf16_groups(card, g):
    """B and C of head h from group h // (H / G): one group, two, one a head."""
    _hold_ssd(*_bf16_case(3 + g, 2, 200, 8, 32, 64, g, "random", card), chunk=64)


@pytest.mark.parametrize("n", [16, 64, 128])
@pytest.mark.parametrize("p", [16, 32, 64])
def test_ssd_bf16_head_and_state_dims(card, p, n):
    """P padded to 64 and N to a multiple of 64 inside; only the real ones stored."""
    _hold_ssd(*_bf16_case(p + n, 1, 150, 4, p, n, 2, "random", card), chunk=128)


@pytest.mark.parametrize("state", [None, "zero", "random"])
def test_ssd_bf16_initial_state(card, state):
    _hold_ssd(*_bf16_case(11, 2, 520, 8, 64, 128, 1, state, card), chunk=256)


@pytest.mark.parametrize("chunk", [8, 64, 100])
def test_ssd_bf16_chunk_invariance(card, chunk):
    """y and the final state do not depend on the chunk beyond the bf16 gate."""
    args = _bf16_case(5, 1, 333, 4, 64, 128, 1, "random", card)
    y0, st0 = ssd_op(*args, chunk=256)
    y, st = ssd_op(*args, chunk=chunk)
    for got, want in ((y, y0), (st, st0)):
        ok, errs = _held(got, want, SSD_TOL["bfloat16"])
        assert ok, errs


@pytest.mark.parametrize("case", ["fused_bc", "heads_major_x"])
def test_ssd_bf16_strided_views(card, case):
    """The model's views: x the heads of a (B, S, H P) activation, B and C
    slices of one fused (B, S, 2 G N) projection (ssm_mixer); and x stored
    heads-major, handed over as a transposed view."""
    b, s, h, p, n, g = 2, 300, 8, 64, 128, 2
    x, dt, A, bm, cm, st0 = _bf16_case(17, b, s, h, p, n, g, "random", card)
    if case == "fused_bc":
        x = x.reshape(b, s, h * p).reshape(b, s, h, p)
        bc = torch.cat([bm.reshape(b, s, g * n), cm.reshape(b, s, g * n)], dim=-1)
        bm, cm = bc[..., : g * n].reshape(b, s, g, n), bc[..., g * n :].reshape(b, s, g, n)
        assert bm.stride(1) == 2 * g * n and cm.data_ptr() != bm.data_ptr()
    else:
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    _hold_ssd(x, dt, A, bm, cm, st0, chunk=256)


@pytest.mark.parametrize("case", ["misaligned_base", "seq_stride_not_in_8s", "last_dim_strided"])
def test_ssd_bf16_rejects_layouts_it_does_not_take(card, case):
    """Views that 16-byte vector loads cannot read raise before any launch."""
    b, s, h, p, n = 1, 64, 2, 32, 32
    x, dt, A, bm, cm, _ = _bf16_case(1, b, s, h, p, n, 1, None, card)
    if case == "misaligned_base":
        x = torch.zeros(b * s * h * p + 1, dtype=torch.bfloat16, device=card)[1:].view(b, s, h, p)
    elif case == "seq_stride_not_in_8s":
        bm = torch.zeros((b, s, 1, n + 4), dtype=torch.bfloat16, device=card)[..., :n]
    else:
        cm = torch.zeros((b, s, 1, 2 * n), dtype=torch.bfloat16, device=card)[..., ::2]
    before = K2.LAUNCHES
    with pytest.raises(ValueError):
        ssd_op(x, dt, A, bm, cm)
    assert K2.LAUNCHES == before


def test_mamba2_on_card_runs_the_kernel(card):
    """Reduced mamba2 on the card: the forward launches the kernel once a
    layer and gives the logits its CPU twin (plain scan) gives; a prefill
    leaves the states the CPU prefill leaves."""
    cfg = configs.get_reduced("mamba2-2.7b")
    policy = Policy("float32", "float32", "float32")
    on_card = StreamModel(cfg, policy, device=card, generator=0)
    on_cpu = StreamModel(cfg, policy, device="cpu", generator=None)
    on_cpu.load_params(on_card.param_tree())
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (2, 150)))
    before = K2.LAUNCHES
    got = on_card(tokens.to(card))
    torch.cuda.synchronize()
    assert K2.LAUNCHES == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), on_cpu(tokens), atol=1e-4, rtol=1e-4)
    lg, cache = on_card.prefill(tokens[:, :37].to(card), 0, cache_dtype=torch.float32)
    lg_cpu, cache_cpu = on_cpu.prefill(tokens[:, :37], 0, cache_dtype=torch.float32)
    torch.testing.assert_close(lg.cpu(), lg_cpu, atol=1e-4, rtol=1e-4)
    for key in ("conv", "ssd"):
        torch.testing.assert_close(cache["slots"]["s0"][key].cpu(), cache_cpu["slots"]["s0"][key], atol=1e-4, rtol=1e-4)


# K3 is held to a float64 run of its plain version: on the card the f32
# plain version's 1 - a * a, which cancels when a is near 1, alone strays
# past tests/test_kernels.py:86's 1e-5
RGLRU_TOL = 1e-5


def _rglru_inputs(seed, b, s, c, device, model_decays=False):
    """x and log_a: the tests' decays -|N| * 0.3, or the model's, log a =
    log(u) r / 2 with u ~ U(0.81, 0.998) and r a sigmoid gate (a up to
    about 0.9995); h0 drawn."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    if model_decays:
        u = rng.uniform(0.81, 0.998, c).astype(np.float32)
        r = 1 / (1 + np.exp(-rng.standard_normal((b, s, c))))
        log_a = (np.log(u) * r / 2).astype(np.float32)
    else:
        log_a = (-np.abs(rng.standard_normal((b, s, c))) * 0.3).astype(np.float32)
    h0 = rng.standard_normal((b, c)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (x, log_a, h0))


def _hold_to_float64(x, log_a, h0, tol):
    h, hl = rglru_op(x, log_a, h0)
    want, want_last = ref.rglru(x.double(), log_a.double(), h0.double())
    assert h.dtype == hl.dtype == torch.float32
    torch.testing.assert_close(h.double(), want, atol=tol, rtol=tol)
    torch.testing.assert_close(hl.double(), want_last, atol=tol, rtol=tol)


@pytest.mark.parametrize("b,s,c", [
    (1, 128, 64), (2, 256, 128), (3, 64, 256),  # tests/test_kernels.py:77's shapes
    (2, 1000, 96), (1, 1000, 512),  # ragged S
])
def test_rglru_kernel_on_card(card, b, s, c):
    """The CUDA kernel against its plain version, with h0, on the card, at
    tests/test_kernels.py:86's 1e-5."""
    x, log_a, h0 = _rglru_inputs(s + c, b, s, c, card)
    before = K3.LAUNCHES
    _hold_to_float64(x, log_a, h0, RGLRU_TOL)
    torch.cuda.synchronize()
    assert K3.LAUNCHES == before + 1


@pytest.mark.parametrize("model_decays", [False, True])
def test_rglru_kernel_long_sequence_against_float64(card, model_decays):
    """S 3000 over the model's 4096 channels, with the tests' decays and
    with the model's (a up to about 0.9995), within 1e-4: the tolerance
    chip_smoke.py holds the path's call to."""
    _hold_to_float64(*_rglru_inputs(2, 1, 3000, 4096, card, model_decays=model_decays), 1e-4)


def test_recurrentgemma_on_card_runs_the_kernels(card):
    """Reduced recurrentgemma with K1's head dim 64 on the card: the forward
    launches K3 once a recurrent layer and K1 once a local layer and gives
    the logits its CPU twin (plain versions) gives; a prefill past the
    window and decode steps past the ring's wrap leave the logits and
    states the CPU leaves."""
    cfg = dataclasses.replace(configs.get_reduced("recurrentgemma-9b"), head_dim=64)
    policy = Policy("float32", "float32", "float32")
    on_card = StreamModel(cfg, policy, device=card, generator=0)
    on_cpu = StreamModel(cfg, policy, device="cpu", generator=None)
    on_cpu.load_params(on_card.param_tree())
    n_rec = sum(kind == "rec" for kind, *_ in on_card._layer_params())
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (2, 150)))
    k1, k3 = fa.LAUNCHES, K3.LAUNCHES
    got = on_card(tokens.to(card))
    torch.cuda.synchronize()
    assert (K3.LAUNCHES - k3, fa.LAUNCHES - k1) == (n_rec, cfg.n_layers - n_rec) == (4, 1)
    torch.testing.assert_close(got.cpu(), on_cpu(tokens), atol=1e-4, rtol=1e-4)
    lg, cache = on_card.prefill(tokens[:, :37].to(card), 48, cache_dtype=torch.float32)
    lg_cpu, cache_cpu = on_cpu.prefill(tokens[:, :37], 48, cache_dtype=torch.float32)
    for i in range(37, 45):
        torch.testing.assert_close(lg.cpu(), lg_cpu, atol=1e-4, rtol=1e-4)
        lg, cache = on_card.decode_step(cache, tokens[:, i : i + 1].to(card))
        lg_cpu, cache_cpu = on_cpu.decode_step(cache_cpu, tokens[:, i : i + 1])
        lg, lg_cpu = lg[:, 0], lg_cpu[:, 0]
    for sec in cache:
        for name, st in cache[sec].items():
            for key, t in st.items():
                torch.testing.assert_close(t.cpu(), cache_cpu[sec][name][key], atol=1e-4, rtol=1e-4)
