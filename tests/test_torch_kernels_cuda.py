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
from repro_torch.kernels import adamw8bit as K8
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grad_norm as GN
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


def _machine() -> str:
    """The card, its power limit and clocks, the host's CPU and the CPU
    kernels torch picks there, the build, and the matmul settings a
    comparison in f32 depends on."""
    import platform
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    try:
        cpu = next(ln.split(":", 1)[1].strip() for ln in open("/proc/cpuinfo") if ln.startswith("model name"))
    except (OSError, StopIteration):
        cpu = platform.processor()
    mkldnn = getattr(getattr(torch.backends.mkldnn, "matmul", None), "fp32_precision", "n/a")
    return (f"host {platform.node()}, {smi}, cpu {cpu}, {torch.get_num_threads()} threads, "
            f"cpu capability {torch.backends.cpu.get_cpu_capability()}, mkldnn matmul fp32 {mkldnn}, "
            f"torch {torch.__version__}, cuda {torch.version.cuda}, "
            f"matmul allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
            f"float32 matmul precision {torch.get_float32_matmul_precision()}, "
            f"cudnn allow_tf32 {torch.backends.cudnn.allow_tf32}")


def _forward_diagnosis(card, cfg, on_card, on_cpu, tokens, got, want) -> str:
    """What a mismatch of the card's logits with the CPU twin's needs to
    tell its causes apart: the card's forward run again (the same bits, or
    not), each layer's K1 output on the card against ``ref.mha`` on the
    card on the same q, k, v, both sides against a float64 forward on the
    CPU (attention by ``ref.mha`` in float64), the CPU twin run again and
    on one thread, and the machine."""
    from unittest import mock

    from repro_torch.models import layers as L

    lines = []
    again = on_card(tokens.to(card))
    torch.cuda.synchronize()
    lines.append(f"card forward again: bit-identical {torch.equal(again, got)}, "
                 f"max abs diff {float((again - got).abs().max()):.3g}")
    seen = []
    real = L.attention_op

    def spy(q, k, v, **kw):
        out = real(q, k, v, **kw)
        seen.append((q, k, v, kw, out))
        return out

    with mock.patch.object(L, "attention_op", spy):
        on_card(tokens.to(card))
    for i, (q, k, v, kw, out) in enumerate(seen):
        rep = q.shape[2] // k.shape[2]
        plain = ref.mha(q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(rep, 1),
                        v.transpose(1, 2).repeat_interleave(rep, 1), **kw).transpose(1, 2)
        lines.append(f"layer {i}: K1 vs ref.mha on the card, max abs {float((out - plain).abs().max()):.3g}")

    def mha64(q, k, v, **kw):
        rep = q.shape[2] // k.shape[2]
        return ref.mha(q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(rep, 1),
                       v.transpose(1, 2).repeat_interleave(rep, 1), **kw).transpose(1, 2)

    on64 = StreamModel(cfg, Policy("float64", "float64", "float64"), device="cpu", generator=None)
    on64.load_params(on_card.param_tree())
    with mock.patch.object(L, "attention_op", mha64):
        ref64 = on64(tokens).double()
    for side, x in (("card", got.cpu()), ("cpu", want)):
        lines.append(f"{side} vs float64 forward: max abs {float((x.double() - ref64).abs().max()):.3g}")
    lines.append(f"cpu forward again: bit-identical {torch.equal(on_cpu(tokens), want)}")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = on_cpu(tokens)
    finally:
        torch.set_num_threads(n)
    lines.append(f"cpu forward on 1 thread (of {n}) vs float64 forward: max abs "
                 f"{float((one.double() - ref64).abs().max()):.3g}")
    lines.append(f"card vs cpu: max abs {float((got.cpu() - want).abs().max()):.3g}")
    lines.append(_machine())
    return "\n".join(lines)


def test_model_forward_on_card_runs_the_kernel(card):
    """A small dense model on the card launches the kernel once a layer
    and gives the logits its CPU twin (plain attention) gives. On a
    mismatch it reports what tells the causes apart (``_forward_diagnosis``)."""
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
    want = on_cpu(tokens)
    try:
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    except AssertionError as e:
        report = _forward_diagnosis(card, cfg, on_card, on_cpu, tokens, got, want)
        print(report)
        raise AssertionError(f"{e}\n{report}") from None


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


# K2's backward (csrc/ssd_scan_bwd.cu) against the plain version,
# ref.ssd_bwd (autograd through ref.ssd, groups repeated): each gradient's
# error relative to its largest element within the forward's SSD_TOL; dt
# on the bf16 grid in bf16, where the two round x * dt alike
SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dst0")


def _ssd_bwd_case(seed, b, s, h, p, n, g, dtype, device, state=True):
    rng = np.random.default_rng(seed)
    wdt = getattr(torch, dtype)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)

    x, bm, cm, dy = t(b, s, h, p).to(wdt), t(b, s, g, n).to(wdt), t(b, s, g, n).to(wdt), t(b, s, h, p).to(wdt)
    dt = torch.nn.functional.softplus(t(b, s, h)).to(wdt).float()
    A = -torch.exp(t(h))
    st0, dsf = (t(b, h, n, p), t(b, h, n, p)) if state else (None, None)
    return x, dt, A, bm, cm, st0, dy, dsf


def _ssd_heads(x, dt, A, bm, cm, st0, dy, dsf):
    return (x.transpose(1, 2), dt.transpose(1, 2), A, bm.transpose(1, 2), cm.transpose(1, 2), st0,
            dy.transpose(1, 2), dsf)


def _hold_bwd(args, chunk, dtype):
    """One backward kernel call (one launch counted) against ref.ssd_bwd."""
    before = K2.BWD_LAUNCHES
    got = K2.ssd_scan_bwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert K2.BWD_LAUNCHES == before + 1
    want = ref.ssd_bwd(*args)
    for name, gv, wv in zip(SSD_GRADS, got, want):
        if wv is None:
            assert gv is None, name
            continue
        assert gv.shape == wv.shape and gv.dtype == wv.dtype, name
        assert bool(torch.isfinite(gv).all()), name
        err = float((gv.float() - wv.float()).abs().max() / wv.float().abs().max())
        assert err <= SSD_TOL[dtype], (name, err)
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,g,chunk", [
    (1, 128, 2, 32, 64, 1, 32),  # chip_smoke.SSD_SWEEP's shapes: G 1, 2 and H
    (2, 256, 4, 64, 128, 2, 64),
    (1, 64, 4, 16, 32, 4, 64),
    (2, 1000, 8, 64, 128, 1, 256),  # a ragged last chunk
    (1, 300, 4, 64, 128, 1, 100),  # a ragged chunk of a ragged tile count
])
def test_ssd_bwd_kernel_on_card(card, dtype, b, s, h, p, n, g, chunk):
    """The backward kernel against its plain version, with a random
    initial state and d(final state)."""
    args = _ssd_heads(*_ssd_bwd_case(b + s + g, b, s, h, p, n, g, dtype, card))
    _hold_bwd(args, chunk, dtype)


# the bf16 path's edges (a block of HEADS_PER_BLOCK heads of one group a
# (chunk, 64-position tile), P padded to 64 and N to 128 in shared memory)
@pytest.mark.parametrize("b,s,h,p,n,g,chunk", [
    (1, 300, 86, 64, 128, 2, 256),  # 43 heads a group: a block of 40 and one of 3
    (1, 250, 41, 32, 64, 1, 128),  # 41 heads: a block of 40 and one of 1 (warpgroup 1 idle)
    (2, 256, 8, 32, 64, 4, 128),  # G 4: two heads a group
    (1, 200, 4, 16, 64, 1, 256),  # P 16 and N 64 padded
    (1, 200, 4, 32, 32, 2, 256),  # P 32 and N 32 padded
    (1, 333, 4, 64, 128, 1, 256),  # a short last chunk: one full tile and 13 positions
    (1, 77, 2, 64, 128, 1, 256),  # one chunk shorter than two tiles
])
@pytest.mark.parametrize("state", [False, True])
def test_ssd_bwd_bf16_edges(card, b, s, h, p, n, g, chunk, state):
    args = _ssd_heads(*_ssd_bwd_case(b + s + h, b, s, h, p, n, g, "bfloat16", card, state=state))
    _hold_bwd(args, chunk, "bfloat16")


def test_ssd_bwd_bf16_copies_a_dy_it_cannot_read(card):
    """dy at a base that is not 16-byte aligned (autograd may hand any
    layout): the wrapper copies dy alone and the result holds."""
    b, s, h, p, n, g = 1, 200, 4, 64, 128, 1
    x, dt, A, bm, cm, st0, dy, dsf = _ssd_bwd_case(21, b, s, h, p, n, g, "bfloat16", card)
    wide = torch.zeros((b, s, h, p + 8), dtype=dy.dtype, device=card)
    wide[..., 1 : p + 1] = dy
    dy = wide[..., 1 : p + 1]
    assert dy.data_ptr() % 16 and K2.layout_error("dy", dy.shape, dy.stride(), dy.data_ptr(), dy.dtype)
    _hold_bwd(_ssd_heads(x, dt, A, bm, cm, st0, dy, dsf), 256, "bfloat16")


def test_ssd_bwd_bf16_refuses_unaligned_inputs(card):
    """x, B and C are read in 16-byte vectors: a view the bf16 kernels do
    not take raises before any launch (only dy is copied)."""
    b, s, h, p, n, g = 1, 64, 2, 32, 32, 1
    x, dt, A, bm, cm, st0, dy, dsf = _ssd_bwd_case(22, b, s, h, p, n, g, "bfloat16", card)
    wide = torch.zeros((b, s, g, n + 8), dtype=bm.dtype, device=card)
    wide[..., 1 : n + 1] = bm
    before = K2.BWD_LAUNCHES
    with pytest.raises(ValueError):
        K2.ssd_scan_bwd(*_ssd_heads(x, dt, A, wide[..., 1 : n + 1], cm, st0, dy, dsf))
    assert K2.BWD_LAUNCHES == before


def test_ssd_bwd_bf16_same_bits_across_head_blocks(card):
    """Groups of more heads than a block takes: the blocks' partials add in
    order, no atomics, so three calls give the same bits."""
    args = _ssd_heads(*_ssd_bwd_case(23, 2, 600, 86, 64, 128, 2, "bfloat16", card))
    first = K2.ssd_scan_bwd(*args, chunk=256)
    for _ in range(2):
        again = K2.ssd_scan_bwd(*args, chunk=256)
        assert all(torch.equal(u, v) for u, v in zip(first, again))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_bwd_without_states(card, dtype):
    """No initial state and no d(final state), as the training path calls
    it: d(initial state) is None."""
    args = _ssd_heads(*_ssd_bwd_case(3, 2, 333, 8, 64, 128, 2, dtype, card, state=False))
    got = _hold_bwd(args, 256, dtype)
    assert got[5] is None


def test_ssd_bwd_strided_views(card):
    """The mixer's views: x the heads of a (B, S, H P) activation, B and C
    slices of one fused (B, S, 2 G N) projection; dy in a layout autograd
    may hand over (its last axis strided: copied before the launch)."""
    b, s, h, p, n, g = 2, 300, 8, 64, 128, 2
    x, dt, A, bm, cm, st0, dy, dsf = _ssd_bwd_case(17, b, s, h, p, n, g, "bfloat16", card)
    x = x.reshape(b, s, h * p).reshape(b, s, h, p)
    bc = torch.cat([bm.reshape(b, s, g * n), cm.reshape(b, s, g * n)], dim=-1)
    bm, cm = bc[..., : g * n].reshape(b, s, g, n), bc[..., g * n :].reshape(b, s, g, n)
    assert bm.stride(1) == 2 * g * n
    dy = torch.stack([dy, dy], dim=-1)[..., 0]
    assert dy.stride(3) == 2
    _hold_bwd(_ssd_heads(x, dt, A, bm, cm, st0, dy, dsf), 256, "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_bwd_same_bits_on_every_call(card, dtype):
    """Every reduction (the heads of a group, A over batch and time) adds
    in a fixed order with no atomics: three calls give the same bits."""
    args = _ssd_heads(*_ssd_bwd_case(5, 2, 700, 8, 64, 128, 1, dtype, card))
    first = K2.ssd_scan_bwd(*args, chunk=256)
    for _ in range(2):
        again = K2.ssd_scan_bwd(*args, chunk=256)
        assert all(torch.equal(u, v) for u, v in zip(first, again))


def test_ssd_bwd_refuses_unsupported_shapes(card):
    """Head dims off 16/32/64, state dims off the multiple of 16 and a last
    axis that is not contiguous raise before any launch."""
    before = K2.BWD_LAUNCHES
    for p, n in ((48, 32), (32, 24)):
        args = _ssd_heads(*_ssd_bwd_case(1, 1, 32, 2, p, n, 1, "float32", card))
        with pytest.raises(ValueError):
            K2.ssd_scan_bwd(*args)
    x, dt, A, bm, cm, st0, dy, dsf = _ssd_bwd_case(2, 1, 32, 2, 32, 32, 1, "float32", card)
    bm = torch.stack([bm, bm], dim=-1)[..., 0]
    with pytest.raises(ValueError):
        K2.ssd_scan_bwd(*_ssd_heads(x, dt, A, bm, cm, st0, dy, dsf))
    assert K2.BWD_LAUNCHES == before


def test_ssd_scan_under_grad_matches_plain(card):
    """K2 on inputs that require grad (ssd_op, and ssd_scan itself) goes
    through SSDScan: one forward and one backward launch, and gradients
    equal to the plain version's within SSD_TOL."""
    x, dt, A, bm, cm, st0, dy, dsf = _ssd_bwd_case(9, 1, 200, 4, 64, 128, 2, "float32", card)
    leaves = [t.requires_grad_(True) for t in (x, dt, A, bm, cm, st0)]
    fwd, bwd = K2.LAUNCHES, K2.BWD_LAUNCHES
    y, st = ssd_op(*leaves, chunk=64)
    got = torch.autograd.grad((y * dy).sum() + (st * dsf).sum(), leaves)
    torch.cuda.synchronize()
    assert (K2.LAUNCHES, K2.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    want = ref.ssd_bwd(*_ssd_heads(x, dt, A, bm, cm, st0, dy, dsf))
    back = [lambda t: t.transpose(1, 2)] * 2 + [lambda t: t] + [lambda t: t.transpose(1, 2)] * 2 + [lambda t: t]
    for name, gv, wv, f in zip(SSD_GRADS, got, want, back):
        err = float((gv - f(wv)).abs().max() / wv.abs().max())
        assert err <= SSD_TOL["float32"], (name, err)
    y2, _ = K2.ssd_scan(*_ssd_heads(*leaves, dy, None)[:6], chunk=64)
    assert y2.grad_fn is not None


def test_mamba2_gradients_on_card_match_cpu(card):
    """Reduced mamba2 (head dim 32, state 16, chunk 16) on the card: its
    loss and every gradient leaf through K2 forward + backward against
    the CPU twin's (the plain scan), at K2's f32 tolerance of each leaf's
    largest element; one backward launch a layer."""
    from repro_torch.train.optimizer import tree_leaves

    cfg = dataclasses.replace(configs.get_reduced("mamba2-2.7b"), vocab=250)
    policy = Policy("float32", "float32", "float32")
    on_card = StreamModel(cfg, policy, device=card, generator=0)
    on_cpu = StreamModel(cfg, policy, device="cpu", generator=None)
    on_cpu.load_params(on_card.param_tree())
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (2, 70)))
    out = []
    for model, tok in ((on_card, tokens.to(card)), (on_cpu, tokens)):
        params = model.param_tree()
        model.requires_grad_(True)
        before = K2.BWD_LAUNCHES
        loss, _ = model.loss(params, {"tokens": tok})
        grads = torch.autograd.grad(loss, tree_leaves(params))
        model.requires_grad_(False)
        out.append((float(loss.detach()), [g.cpu() for g in grads], K2.BWD_LAUNCHES - before))
    (lc, gc_, nc), (lp, gp, npl) = out
    assert (nc, npl) == (cfg.n_layers, 0)
    assert abs(lc - lp) <= 1e-5 * abs(lp)
    for a, b in zip(gc_, gp):
        assert a.dtype == b.dtype
        assert float((a - b).abs().max() / b.abs().max()) <= SSD_TOL["float32"]


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


def _held64(x, log_a, h0, tol):
    """The kernel against the float64 plain version, element by element."""
    h, hl = rglru_op(x, log_a, h0)
    want, want_last = ref.rglru(x.double(), log_a.double(), None if h0 is None else h0.double())
    torch.testing.assert_close(h.double(), want, atol=tol, rtol=tol)
    torch.testing.assert_close(hl.double(), want_last, atol=tol, rtol=tol)


# the kernel's tiles (csrc/rglru_scan.cu): 32 channels a block, 16 steps a
# warp, time blocks of 256 steps
@pytest.mark.parametrize("s", [1, 15, 16, 17, 255, 256, 257, 845])
def test_rglru_kernel_sequence_edges(card, s):
    """S at a warp's steps and the time block, and past three time blocks,
    at B 3 and a C off the channel tile, with h0, within 1e-5."""
    _held64(*_rglru_inputs(s, 3, s, 100, card), RGLRU_TOL)


@pytest.mark.parametrize("c", [1, 31, 32, 33, 100, 4096])
def test_rglru_kernel_channel_edges(card, c):
    """C below, at and above the channel tile, and the model's, at B 1."""
    _held64(*_rglru_inputs(c, 1, 300, c, card), RGLRU_TOL)


@pytest.mark.parametrize("h0", [None, "zero", "random"])
def test_rglru_kernel_initial_state(card, h0):
    """No h0, the zero h0 the cache hands the path, and a random one, with
    the model's decays over S 3000, against float64 at the path's 1e-4."""
    x, log_a, h_init = _rglru_inputs(8, 2, 3000, 256, card, model_decays=True)
    h_init = {None: None, "zero": torch.zeros_like(h_init), "random": h_init}[h0]
    _held64(x, log_a, h_init, 1e-4)


@pytest.mark.parametrize("case", ["fused_x_log_a", "sequence_major", "strided_h0"])
def test_rglru_kernel_strided_views(card, case):
    """Views the wrapper takes with their strides: x and log_a halves of
    one (B, S, 2C) tensor, a (S, B, C) tensor seen as (B, S, C), and an h0
    with a channel stride (made contiguous by the wrapper)."""
    b, s, c = 2, 600, 96
    x, log_a, h0 = _rglru_inputs(21, b, s, c, card)
    if case == "fused_x_log_a":
        both = torch.cat([x, log_a], dim=2)
        x, log_a = both[..., :c], both[..., c:]
    elif case == "sequence_major":
        x, log_a = (t.transpose(0, 1).contiguous().transpose(0, 1) for t in (x, log_a))
    else:
        h0 = torch.stack([h0, h0], dim=2).flatten(1)[:, ::2]
    assert x.stride(2) == 1 and (case != "strided_h0" or h0.stride(1) == 2)
    _held64(x, log_a, h0, RGLRU_TOL)


def test_rglru_kernel_rejects_channel_strides(card):
    """x and log_a must have a unit channel stride: anything else raises,
    and nothing is launched."""
    x, log_a, h0 = _rglru_inputs(4, 1, 64, 32, card)
    before = K3.LAUNCHES
    with pytest.raises(ValueError):
        K3.rglru_scan(x.transpose(1, 2).contiguous().transpose(1, 2), log_a, h0)
    assert K3.LAUNCHES == before


def test_rglru_kernel_time_tile_invariance(card, tmp_path):
    """The same input through the kernel and through a build of its source
    with 4 warps of 3 steps (time blocks of 12 instead of 256): within 1e-5
    of each other, with the model's decays."""
    import ctypes
    import subprocess

    from repro_torch.kernels import _build

    src = (_build.CSRC / "rglru_scan.cu").read_text()
    for old, new in (("constexpr int WARPS = 16;", "constexpr int WARPS = 4;"),
                     ("constexpr int STEPS = 16;", "constexpr int STEPS = 3;")):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    (tmp_path / "rglru_scan.cu").write_text(src)
    lib = tmp_path / "librglru_scan.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(tmp_path / "rglru_scan.cu")],
                   check=True, capture_output=True)
    x, log_a, h0 = _rglru_inputs(13, 2, 1000, 100, card, model_decays=True)
    h, hl = rglru_op(x, log_a, h0)
    h12, hl12 = K3._launch(K3._bind(ctypes.CDLL(str(lib))), x, log_a, h0)
    torch.testing.assert_close(h12, h, atol=RGLRU_TOL, rtol=RGLRU_TOL)
    torch.testing.assert_close(hl12, hl, atol=RGLRU_TOL, rtol=RGLRU_TOL)
    assert not torch.equal(h12, h)  # the two builds round differently: the tiles took effect


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


# ------------------------------------------------------------- K3 backward
# dx, dlog_a and dh0 against ref.rglru_bwd run in float64, element by
# element, |got - want| <= tol + tol * scale (chip_smoke.check_rglru_bwd):
# the scale is the adjoint of |dh| for dx and dh0, and for dlog_a its
# chain G times (|a h_{t-1}| + |a^2 x / w|) (g and dlog_a's bracket each
# cross 0); tol RGLRU_TOL at the tests' decays, 1e-4 at the model's


def _rglru_bwd_case(seed, b, s, c, device, model_decays=False, h0=True, dh_last=True):
    x, log_a, hh0 = _rglru_inputs(seed, b, s, c, device, model_decays=model_decays)
    rng = np.random.default_rng(seed + 1)
    dh = torch.from_numpy(rng.standard_normal((b, s, c)).astype(np.float32)).to(device)
    dl = torch.from_numpy(rng.standard_normal((b, c)).astype(np.float32)).to(device) if dh_last else None
    return x, log_a, hh0 if h0 else None, dh, dl


def _rglru_bwd_scales(x, la, h0, h, dh, dl):
    a = torch.exp(la)
    v = -torch.expm1(2 * la)
    w = torch.sqrt(torch.where(v > 0, v, torch.zeros_like(v)))
    hprev = torch.cat([(torch.zeros_like(h[:, 0]) if h0 is None else h0)[:, None], h[:, :-1]], 1)
    size = ref.rglru_bwd(x, la, h0, h, dh.abs(), None if dl is None else dl.abs())
    return size[0], size[0] / w * ((a * hprev).abs() + (a * a * x / w).abs()), size[2]


def _hold_rglru_bwd(x, log_a, h0, dh, dl, tol):
    """K3's backward (h from K3) against the float64 plain version; one launch."""
    with torch.no_grad():
        h, _ = rglru_op(x, log_a, h0)
    n = K3.BWD_LAUNCHES
    got = K3.rglru_scan_bwd(x, log_a, h0, h, dh, dl)
    torch.cuda.synchronize()
    assert K3.BWD_LAUNCHES == n + 1
    d64 = [None if t is None else t.double() for t in (x, log_a, h0, dh, dl)]
    h64, _ = ref.rglru(*d64[:3])
    want = ref.rglru_bwd(*d64[:3], h64, d64[3], d64[4])
    for name, g, wv, sc in zip(("dx", "dlog_a", "dh0"), got, want, _rglru_bwd_scales(*d64[:3], h64, *d64[3:])):
        if wv is None:
            assert g is None
            continue
        assert g.dtype == torch.float32 and g.shape == wv.shape and bool(torch.isfinite(g).all())
        err = float(((g.double() - wv).abs() / (tol + tol * sc)).max())
        assert err <= 1.0, (name, err)
    return got


@pytest.mark.parametrize("b,s,c", [(1, 128, 64), (2, 256, 128), (3, 64, 256), (2, 1000, 96), (1, 1000, 512)])
def test_rglru_bwd_kernel_on_card(card, b, s, c):
    """K3's backward against its plain version in float64, with h0 and
    d(h_last), at the forward's sweep and tests/test_kernels.py:86's 1e-5."""
    _hold_rglru_bwd(*_rglru_bwd_case(s + c, b, s, c, card), RGLRU_TOL)


# the backward's tiles (csrc/rglru_scan_bwd.cu): 32 channels a block, 8
# steps a warp, time blocks of 128 steps; and K3's (16 steps, 256)
@pytest.mark.parametrize("s", [1, 7, 8, 9, 127, 128, 129, 255, 256, 257, 845])
@pytest.mark.parametrize("h0", [True, False])
def test_rglru_bwd_kernel_sequence_edges(card, s, h0):
    """S at a warp's steps and both kernels' time blocks, and past several,
    at B 3 and a C off the channel tile, with h0 and d(h_last) present or
    absent."""
    _hold_rglru_bwd(*_rglru_bwd_case(s, 3, s, 100, card, h0=h0, dh_last=h0), RGLRU_TOL)


@pytest.mark.parametrize("c", [1, 31, 32, 33, 4096])
def test_rglru_bwd_kernel_channel_edges(card, c):
    """C below, at and above the channel tile, and the model's, at B 1."""
    _hold_rglru_bwd(*_rglru_bwd_case(c, 1, 300, c, card), RGLRU_TOL)


@pytest.mark.parametrize("b,s,c,h0", [(4, 1024, 4096, False), (2, 3000, 256, True)])
def test_rglru_bwd_kernel_model_decays(card, b, s, c, h0):
    """The model's decays (a up to about 0.9995): the training call (no h0,
    no d(h_last), as the mixer hands it) and S 3000 with both, against
    float64 at the path's 1e-4."""
    _hold_rglru_bwd(*_rglru_bwd_case(40 + s, b, s, c, card, model_decays=True, h0=h0, dh_last=h0), 1e-4)


@pytest.mark.parametrize("case", ["fused_x_log_a", "sequence_major", "strided_dh", "strided_h0_dh_last"])
def test_rglru_bwd_kernel_strided_views(card, case):
    """Views the wrapper takes with their strides (x and log_a halves of one
    (B, S, 2C) tensor; (S, B, C) storage seen as (B, S, C)) and views it
    copies (dh, h0 and d(h_last) with a channel stride of 2): the bits of
    the contiguous inputs."""
    b, s, c = 2, 600, 96
    x, log_a, h0, dh, dl = _rglru_bwd_case(32, b, s, c, card)
    with torch.no_grad():
        h, _ = rglru_op(x, log_a, h0)
    want = K3.rglru_scan_bwd(x, log_a, h0, h, dh, dl)
    if case == "fused_x_log_a":
        both = torch.cat([x, log_a], dim=2)
        x, log_a = both[..., :c], both[..., c:]
    elif case == "sequence_major":
        x, log_a, h, dh = (t.transpose(0, 1).contiguous().transpose(0, 1) for t in (x, log_a, h, dh))
        assert not x.is_contiguous()
    elif case == "strided_dh":
        dh = torch.stack([dh, dh], dim=3).flatten(2)[..., ::2]
        assert dh.stride(2) == 2
    else:
        h0, dl = (torch.stack([v, v], dim=2).flatten(1)[:, ::2] for v in (h0, dl))
    got = K3.rglru_scan_bwd(x, log_a, h0, h, dh, dl)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_rglru_bwd_kernel_same_bits_on_every_call(card):
    """Three calls on one input at the training shape give the same bits."""
    x, log_a, h0, dh, dl = _rglru_bwd_case(33, 4, 1024, 4096, card, model_decays=True)
    with torch.no_grad():
        h, _ = rglru_op(x, log_a, h0)
    first = K3.rglru_scan_bwd(x, log_a, h0, h, dh, dl)
    for _ in range(2):
        assert all(torch.equal(p, q) for p, q in zip(first, K3.rglru_scan_bwd(x, log_a, h0, h, dh, dl)))


def test_rglru_bwd_kernel_time_tile_invariance(card, tmp_path, monkeypatch):
    """The same input through the backward and through a build of its
    source with 4 warps of 3 steps (time blocks of 12 instead of 128):
    within 1e-5 of each gradient's largest element, with the model's
    decays, and not the same bits (the tiles took effect)."""
    import ctypes
    import subprocess

    from repro_torch.kernels import _build

    src = (_build.CSRC / "rglru_scan_bwd.cu").read_text()
    for old, new in (("constexpr int WARPS = 16;", "constexpr int WARPS = 4;"),
                     ("constexpr int STEPS = 8;", "constexpr int STEPS = 3;")):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    (tmp_path / "rglru_scan_bwd.cu").write_text(src)
    lib = tmp_path / "librglru_scan_bwd.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(tmp_path / "rglru_scan_bwd.cu")],
                   check=True, capture_output=True)
    x, log_a, h0, dh, dl = _rglru_bwd_case(34, 2, 1000, 100, card, model_decays=True)
    with torch.no_grad():
        h, _ = rglru_op(x, log_a, h0)
    want = K3.rglru_scan_bwd(x, log_a, h0, h, dh, dl)
    monkeypatch.setattr(K3, "_bwd_fn", K3._bind_bwd(ctypes.CDLL(str(lib))))
    got = K3.rglru_scan_bwd(x, log_a, h0, h, dh, dl)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
    assert not all(torch.equal(g, w) for g, w in zip(got, want))


def test_recurrentgemma_gradients_on_card_match_cpu(card):
    """Reduced recurrentgemma (K1's head dim 64) on the card: its loss and
    every gradient leaf through K3 and K1 forward + backward against the
    CPU twin's (the plain versions), at 1e-4 of each leaf's largest element
    (the two sides sum in other orders through five layers); one K3
    backward launch an RG-LRU layer and one K1 backward launch a local
    layer."""
    from repro_torch.train.optimizer import tree_leaves

    cfg = dataclasses.replace(configs.get_reduced("recurrentgemma-9b"), head_dim=64, vocab=250)
    policy = Policy("float32", "float32", "float32")
    on_card = StreamModel(cfg, policy, device=card, generator=0)
    on_cpu = StreamModel(cfg, policy, device="cpu", generator=None)
    on_cpu.load_params(on_card.param_tree())
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (2, 70)))
    out = []
    for model, tok in ((on_card, tokens.to(card)), (on_cpu, tokens)):
        params = model.param_tree()
        model.requires_grad_(True)
        k3, k1 = K3.BWD_LAUNCHES, fa.BWD_LAUNCHES
        loss, _ = model.loss(params, {"tokens": tok})
        grads = torch.autograd.grad(loss, tree_leaves(params))
        model.requires_grad_(False)
        out.append((float(loss.detach()), [g.cpu() for g in grads], (K3.BWD_LAUNCHES - k3, fa.BWD_LAUNCHES - k1)))
    (lc, gc_, nc), (lp, gp, npl) = out
    assert nc == (4, 1) and npl == (0, 0)
    assert abs(lc - lp) <= 1e-5 * abs(lp)
    for a, b in zip(gc_, gp):
        assert a.dtype == b.dtype
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4


# ------------------------------------------------------------- K1 backward
# dq, dk, dv against autograd through the plain version, each relative to
# its largest element: f32 at the forward's 2e-5 (FMAs in another order),
# bf16 at the forward's 2e-2 (P and dS enter their products as bf16)
BWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _bwd_case(seed, b, s, h, kv, d, dtype, device):
    q, k, v = (t.transpose(1, 2) for t in _inputs(seed, b, s, h, kv, d, dtype, device))
    rng = np.random.default_rng(seed + 1)
    do = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32)).to(device, getattr(torch, dtype))
    return q, k, v, do.transpose(1, 2)


def _plain_grads(q, k, v, do, causal, window, softcap=None, q_offset=0):
    rep = q.shape[1] // k.shape[1]
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = ref.mha(leaves[0], leaves[1].repeat_interleave(rep, 1), leaves[2].repeat_interleave(rep, 1),
                  causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    return torch.autograd.grad(out, leaves, do)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,d,causal,window", [
    (2, 256, 8, 8, 64, True, None),     # rep 1, tile-aligned S
    (1, 333, 8, 4, 128, True, None),    # rep 2, ragged S
    (2, 1024, 32, 4, 128, True, None),  # rep 8, yi-6b's heads
    (1, 777, 16, 2, 64, True, 100),     # rep 8, causal window, ragged
    (1, 300, 4, 2, 128, False, 50),     # window alone
    (1, 200, 4, 1, 64, False, None),    # no mask
    (1, 300, 16, 1, 256, True, None),   # recurrentgemma's heads, rep 16, ragged S
    (2, 777, 16, 1, 256, True, 100),    # its heads with a window that binds
    (1, 300, 8, 2, 256, False, 50),     # head dim 256, window alone
])
def test_flash_attention_bwd_on_card(card, dtype, b, s, h, kv, d, causal, window):
    q, k, v, do = _bwd_case(21, b, s, h, kv, d, dtype, card)
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    n = fa.BWD_LAUNCHES
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window)
    want = _plain_grads(q, k, v, do, causal, window)
    torch.cuda.synchronize()
    assert fa.BWD_LAUNCHES == n + 1
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype
        err = float((g.float() - w.float()).abs().max() / w.float().abs().max())
        assert err <= BWD_TOL[dtype], err


# the bf16 kernels' tiles (csrc/flash_attention_bwd.cu): dK/dV blocks of
# 128 keys walking 64-query steps, dQ blocks of 128 queries walking key
# tiles of 128 (at head dim 256 64-key dK/dV blocks and dQ tiles); S at,
# below and above each
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("s", [63, 64, 65, 127, 128, 129, 255, 257])
def test_flash_attention_bwd_ragged_tiles(card, d, s):
    q, k, v, do = _bwd_case(27, 2, s, 8, 2, d, "bfloat16", card)
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True)
    for g, w in zip(got, _plain_grads(q, k, v, do, True, None)):
        assert float((g.float() - w.float()).abs().max() / w.float().abs().max()) <= BWD_TOL["bfloat16"]


# GQA groups of 1 to 16 query heads (the split takes up to GQA_SPLIT
# blocks a kv head), under the causal mask, a window, and both
@pytest.mark.parametrize("rep", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("causal,window", [(True, None), (False, 96), (True, 96)])
def test_flash_attention_bwd_gqa_and_masks(card, rep, causal, window):
    q, k, v, do = _bwd_case(28, 1, 333, 2 * rep, 2, 128 if rep % 2 else 64, "bfloat16", card)
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window)
    for g, w in zip(got, _plain_grads(q, k, v, do, causal, window)):
        assert float((g.float() - w.float()).abs().max() / w.float().abs().max()) <= BWD_TOL["bfloat16"]


# head dim 256 (recurrentgemma's local attention): GQA 1 to 16 over one or
# two kv heads, the causal mask, windows that bind inside a 64-key tile,
# one that S does not reach (the model's 2048) and a window alone
@pytest.mark.parametrize("rep", [1, 4, 16])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 100), (True, 2048), (False, 64)])
def test_flash_attention_bwd_head_dim_256_gqa_and_masks(card, rep, causal, window):
    q, k, v, do = _bwd_case(35, 2, 333, rep, 1, 256, "bfloat16", card)
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window)
    for g, w in zip(got, _plain_grads(q, k, v, do, causal, window)):
        assert float((g.float() - w.float()).abs().max() / w.float().abs().max()) <= BWD_TOL["bfloat16"]


def test_attention_op_gradient_at_head_dim_256(card):
    """Under grad mode recurrentgemma's local attention (16/1 heads, head
    dim 256, a window that binds) runs the forward with lse and the
    backward kernel once each and gives autograd's gradients."""
    q, k, v = (t.requires_grad_(True) for t in _inputs(36, 2, 300, 16, 1, 256, "bfloat16", card))
    do = torch.randn((2, 300, 16, 256), device=card, dtype=torch.bfloat16)
    n_f, n_b = fa.LAUNCHES, fa.BWD_LAUNCHES
    got = torch.autograd.grad(attention_op(q, k, v, causal=True, window=100), (q, k, v), do)
    assert (fa.LAUNCHES - n_f, fa.BWD_LAUNCHES - n_b) == (1, 1)
    want = _plain_grads(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), do.transpose(1, 2), True, 100)
    for g, w in zip(got, want):
        assert float((g.float() - w.transpose(1, 2).float()).abs().max() / w.float().abs().max()) <= 2e-2


@pytest.mark.parametrize("b,s,h,kv,d", [(4, 1024, 32, 4, 128), (2, 777, 8, 2, 64), (1, 300, 4, 4, 128),
                                        (4, 1024, 16, 1, 256)])
def test_flash_attention_bwd_is_deterministic(card, b, s, h, kv, d):
    """Two calls on one input give the same dq, dk and dv to the bit: the
    GQA split's partial sums are added in a fixed order, with no atomics."""
    q, k, v, do = _bwd_case(29, b, s, h, kv, d, "bfloat16", card)
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    first = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True)
    for _ in range(3):
        again = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True)
        assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_attention_bwd_strided_views(card, d):
    """q, k, v as views of one fused (B, S, H + 2 Kv, D) projection, o and
    do in (B, H, S, D) storage, do also sliced from a head dim 4 wider (a
    row stride TMA refuses, so the wrapper makes it contiguous): the
    gradients of the contiguous inputs, to the bit."""
    b, s, h, kv = 2, 300, 8, 2
    rng = np.random.default_rng(30)
    fused = torch.from_numpy(rng.standard_normal((b, s, h + 2 * kv, d)).astype(np.float32)).to(card, torch.bfloat16)
    q, k, v = (fused[:, :, a:z].transpose(1, 2) for a, z in ((0, h), (h, h + kv), (h + kv, h + 2 * kv)))
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    wide = torch.from_numpy(rng.standard_normal((b, h, s, d + 4)).astype(np.float32)).to(card, torch.bfloat16)
    do = wide[..., :d]
    assert not do.is_contiguous() and do.stride(2) % 8
    got = fa.flash_attention_bwd(q, k, v, out.contiguous(), do, lse, causal=True)
    want = fa.flash_attention_bwd(*(t.contiguous() for t in (q, k, v, out)), do.contiguous(), lse, causal=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(got, _plain_grads(q, k, v, do, True, None)):
        assert float((g.float() - w.float()).abs().max() / w.float().abs().max()) <= BWD_TOL["bfloat16"]


def test_flash_attention_bwd_builds_without_spills(card, tmp_path):
    """ptxas's report of the backward's source: every kernel spills nothing
    and setmaxnreg is kept."""
    import re
    import subprocess

    from repro_torch.kernels import _build

    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp_path / "lib.so"),
                          str(_build.CSRC / "flash_attention_bwd.cu")], check=True, capture_output=True, text=True)
    log = res.stdout + res.stderr
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    # dQ, dK/dV, f32 dQ, f32 dK/dV at three head dims and again with the
    # softcap at head dim 256, Di, the reduction
    assert len(spills) >= 18, log
    assert all(a == "0" and b == "0" for a, b in spills), log
    assert "C7508" not in log and "setmaxnreg ignored" not in log, log


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,kv,d,window", [(1000, 32, 4, 128, None), (777, 8, 2, 64, 100), (300, 4, 1, 256, 64)])
def test_flash_attention_lse_on_card(card, dtype, s, h, kv, d, window):
    """The forward's base-2 row log-sum-exp against torch.logsumexp of the
    plain version's scores (every head dim the forward takes)."""
    q, k, v = (t.transpose(1, 2) for t in _inputs(22, 2, s, h, kv, d, dtype, card))
    _, lse = fa.flash_attention(q, k, v, causal=True, window=window, return_lse=True)
    sc = ref.scores(q, k.repeat_interleave(h // kv, 1), causal=True, window=window)
    want = torch.logsumexp(sc, -1) / np.log(2.0)
    assert lse.shape == (2, h, s) and float((lse - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_serving_output_identical_with_and_without_lse(card, dtype, d):
    q, k, v = (t.transpose(1, 2) for t in _inputs(23, 1, 517, 8, 2, d, dtype, card))
    with_lse, _ = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    assert torch.equal(with_lse, fa.flash_attention(q, k, v, causal=True))


def test_attention_op_gradient_through_the_kernels(card):
    """Under grad mode attention_op runs the forward with lse and the
    backward kernel, once each, and gives autograd's gradients."""
    q, k, v = (t.requires_grad_(True) for t in _inputs(24, 2, 300, 8, 2, 128, "bfloat16", card))
    do = torch.randn((2, 300, 8, 128), device=card, dtype=torch.bfloat16)
    n_f, n_b = fa.LAUNCHES, fa.BWD_LAUNCHES
    got = torch.autograd.grad(attention_op(q, k, v, causal=True), (q, k, v), do)
    assert (fa.LAUNCHES - n_f, fa.BWD_LAUNCHES - n_b) == (1, 1)
    want = _plain_grads(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), do.transpose(1, 2), True, None)
    for g, w in zip(got, want):
        assert float((g.float() - w.transpose(1, 2).float()).abs().max() / w.float().abs().max()) <= 2e-2


@pytest.mark.parametrize("d,cap", [(128, 50.0), (64, 50.0)])
def test_flash_attention_bwd_refuses_what_it_lacks(card, d, cap):
    """The backward takes a softcap at head dim 256 only (gemma2-2b's;
    no config has one at 64 or 128): under grad an input that requires
    it raises at the forward, and the backward itself refuses it; head
    dim 256 with a softcap is taken (test_attention_op_gradient_with_softcap)."""
    q, k, v = (t.requires_grad_(True) for t in _inputs(25, 1, 64, 4, 2, d, "bfloat16", card))
    with pytest.raises(NotImplementedError):
        attention_op(q, k, v, causal=True, softcap=cap)
    qt, kt, vt = (t.detach().transpose(1, 2) for t in (q, k, v))
    out, lse = fa.flash_attention(qt, kt, vt, causal=True, softcap=cap, return_lse=True)
    with pytest.raises(NotImplementedError):
        fa.flash_attention_bwd(qt, kt, vt, out, torch.ones_like(out), lse, causal=True, softcap=cap)


# K1's backward with a softcap at head dim 256 (gemma2-2b's 50, and 2,
# where tanh bends every score and 1 - t^2 moves dS far from 1): the
# heads and masks of the rows above at D 256, and gemma2's 8/4 heads
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [50.0, 2.0])
@pytest.mark.parametrize("b,s,h,kv,causal,window", [
    (1, 300, 16, 1, True, None),   # rep 16, ragged S
    (2, 777, 16, 1, True, 100),    # a window that binds inside a tile
    (1, 300, 8, 2, False, 50),     # window alone
    (2, 333, 8, 4, True, None),    # gemma2's heads, rep 2
    (1, 129, 8, 4, True, 64),      # gemma2's heads, a tile + 1, a window of a tile
])
def test_flash_attention_bwd_softcap_on_card(card, dtype, cap, b, s, h, kv, causal, window):
    q, k, v, do = _bwd_case(37, b, s, h, kv, 256, dtype, card)
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window, softcap=cap, return_lse=True)
    n = fa.BWD_LAUNCHES
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window, softcap=cap)
    want = _plain_grads(q, k, v, do, causal, window, cap)
    torch.cuda.synchronize()
    assert fa.BWD_LAUNCHES == n + 1
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype
        err = float((g.float() - w.float()).abs().max() / w.float().abs().max())
        assert err <= BWD_TOL[dtype], err


@pytest.mark.parametrize("b,s,h,kv,window", [(4, 1024, 8, 4, None), (1, 777, 16, 1, 100)])
def test_flash_attention_bwd_softcap_is_deterministic(card, b, s, h, kv, window):
    """With the softcap too (gemma2's training call and a window that
    binds): the same dq, dk and dv to the bit on every call."""
    q, k, v, do = _bwd_case(38, b, s, h, kv, 256, "bfloat16", card)
    out, lse = fa.flash_attention(q, k, v, causal=True, window=window, softcap=50.0, return_lse=True)
    first = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True, window=window, softcap=50.0)
    for _ in range(3):
        again = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True, window=window, softcap=50.0)
        assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_attention_op_gradient_with_softcap(card):
    """Under grad mode gemma2's local attention (8/4 heads, head dim 256,
    softcap 50, a window that binds) runs the forward with lse and the
    backward kernel once each and gives autograd's gradients."""
    q, k, v = (t.requires_grad_(True) for t in _inputs(39, 2, 300, 8, 4, 256, "bfloat16", card))
    do = torch.randn((2, 300, 8, 256), device=card, dtype=torch.bfloat16)
    n_f, n_b = fa.LAUNCHES, fa.BWD_LAUNCHES
    got = torch.autograd.grad(attention_op(q, k, v, causal=True, window=100, softcap=50.0), (q, k, v), do)
    assert (fa.LAUNCHES - n_f, fa.BWD_LAUNCHES - n_b) == (1, 1)
    want = _plain_grads(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), do.transpose(1, 2), True, 100, 50.0)
    for g, w in zip(got, want):
        assert float((g.float() - w.transpose(1, 2).float()).abs().max() / w.float().abs().max()) <= 2e-2


def test_gemma2_on_card_matches_cpu(card):
    """Reduced gemma2 at head dim 256 (local and global layers, window 16
    against 70 tokens, attention softcap 50, final softcap 30, sandwich
    norms, tied and scaled embed) on the card: its logits, and its loss
    and every gradient leaf through K1 forward + backward with the
    softcap, against the CPU twin's (the plain versions), at 1e-4 of the
    largest element; one K1 backward launch a layer."""
    from repro_torch.train.optimizer import tree_leaves

    cfg = dataclasses.replace(configs.get_reduced("gemma2-2b"), head_dim=256, vocab=250)
    policy = Policy("float32", "float32", "float32")
    on_card = StreamModel(cfg, policy, device=card, generator=0)
    on_cpu = StreamModel(cfg, policy, device="cpu", generator=None)
    on_cpu.load_params(on_card.param_tree())
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (2, 70)))
    logits = [on_card(tokens.to(card)).cpu(), on_cpu(tokens)]
    assert float((logits[0] - logits[1]).abs().max() / logits[1].abs().max()) <= 1e-4
    out = []
    for model, tok in ((on_card, tokens.to(card)), (on_cpu, tokens)):
        params = model.param_tree()
        model.requires_grad_(True)
        k1 = fa.BWD_LAUNCHES
        loss, _ = model.loss(params, {"tokens": tok})
        grads = torch.autograd.grad(loss, tree_leaves(params))
        model.requires_grad_(False)
        out.append((float(loss.detach()), [g.cpu() for g in grads], fa.BWD_LAUNCHES - k1))
    (lc, gc_, nc), (lp, gp, npl) = out
    assert nc == cfg.n_layers and npl == 0
    assert abs(lc - lp) <= 1e-5 * abs(lp)
    for a, b in zip(gc_, gp):
        assert a.dtype == b.dtype
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4


# K1 and its backward at queries and keys of different lengths, no mask
# (whisper-tiny's cross attention: the decoder's tokens over the encoder's
# 1500 frames), both lengths ragged for every tile: Sq below, at and past
# a query tile, Sq > Sk too
CROSS = [(4, 1500, 6, 6, 64), (65, 200, 8, 2, 64), (448, 1500, 6, 6, 64), (300, 129, 4, 2, 128),
         (2000, 1500, 6, 6, 64), (77, 333, 16, 1, 256)]


def _cross_case(seed, b, sq, sk, h, kv, d, dtype, device):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, getattr(torch, dtype))
                   for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d), (b, sq, h, d)))
    return q, k, v, do


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,h,kv,d", CROSS)
def test_flash_attention_cross_lengths_on_card(card, dtype, sq, sk, h, kv, d):
    """The forward (one launch, chip_smoke's criterion) and the backward
    (dq over Sq, dk and dv over Sk) against the plain version."""
    q, k, v, do = _cross_case(40, 2, sq, sk, h, kv, d, dtype, card)
    _hold_attention(q, k, v, causal=False)
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    out, lse = fa.flash_attention(qt, kt, vt, causal=False, return_lse=True)
    n = fa.BWD_LAUNCHES
    got = fa.flash_attention_bwd(qt, kt, vt, out, dot, lse, causal=False)
    want = _plain_grads(qt, kt, vt, dot, False, None)
    torch.cuda.synchronize()
    assert fa.BWD_LAUNCHES == n + 1
    for g, w, t in zip(got, want, (qt, kt, vt)):
        assert g.shape == t.shape and g.dtype == t.dtype
        err = float((g.float() - w.float()).abs().max() / w.float().abs().max())
        assert err <= BWD_TOL[dtype], err


@pytest.mark.parametrize("sq,sk,h,kv,d", [(448, 1500, 6, 6, 64), (65, 200, 8, 2, 64)])
def test_flash_attention_bwd_cross_lengths_is_deterministic(card, sq, sk, h, kv, d):
    """The same dq, dk and dv to the bit on every call at Sq != Sk (the
    GQA split's partials over Sk added in order)."""
    q, k, v, do = (t.transpose(1, 2) for t in _cross_case(41, 4, sq, sk, h, kv, d, "bfloat16", card))
    out, lse = fa.flash_attention(q, k, v, causal=False, return_lse=True)
    first = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=False)
    for _ in range(3):
        again = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=False)
        assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.parametrize("kw", [{"causal": True}, {"causal": False, "window": 64}])
def test_flash_attention_cross_lengths_refuse_a_mask(card, kw):
    """A causal mask or a window over more queries than keys (the queries
    not within the keys) raises before any launch, in the forward and in
    the backward."""
    q, k, v, do = (t.transpose(1, 2) for t in _cross_case(42, 1, 192, 128, 4, 4, 64, "bfloat16", card))
    n_f, n_b = fa.LAUNCHES, fa.BWD_LAUNCHES
    with pytest.raises(ValueError, match="different lengths"):
        fa.flash_attention(q, k, v, **kw)
    with pytest.raises(ValueError, match="different lengths"):
        fa.flash_attention_bwd(q, k, v, q, do, torch.zeros(q.shape[:3], device=card), **kw)
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (n_f, n_b)


def test_whisper_on_card_matches_cpu(card):
    """Reduced whisper-tiny widened to head dim 64 (d 128 over 2 heads, the
    kernels' smallest head dim): its logits over 24 frames, then its loss
    and every gradient leaf through K1 forward + backward (the encoder's
    bidirectional calls, the decoder's causal and its cross calls over the
    frames) against the CPU twin's, at 1e-4 of the largest element; three
    K1 launches a layer pair, forward and backward."""
    from repro_torch.train.optimizer import tree_leaves

    cfg = dataclasses.replace(configs.get_reduced("whisper-tiny"), d_model=128)
    policy = Policy("float32", "float32", "float32")
    on_card = StreamModel(cfg, policy, device=card, generator=0)
    on_cpu = StreamModel(cfg, policy, device="cpu", generator=None)
    on_cpu.load_params(on_card.param_tree())
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))
    frames = torch.from_numpy(rng.standard_normal((2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    n = fa.LAUNCHES
    logits = [on_card(tokens.to(card), frames=frames.to(card)).cpu(), on_cpu(tokens, frames=frames)]
    assert fa.LAUNCHES - n == cfg.enc_layers + 2 * cfg.n_layers
    assert float((logits[0] - logits[1]).abs().max() / logits[1].abs().max()) <= 1e-4
    out = []
    for model, dev in ((on_card, card), (on_cpu, "cpu")):
        params = model.param_tree()
        model.requires_grad_(True)
        k1 = fa.BWD_LAUNCHES
        loss, _ = model.loss(params, {"tokens": tokens.to(dev), "frames": frames.to(dev)})
        grads = torch.autograd.grad(loss, tree_leaves(params))
        model.requires_grad_(False)
        out.append((float(loss.detach()), [g.cpu() for g in grads], fa.BWD_LAUNCHES - k1))
    (lc, gc_, nc), (lp, gp, npl) = out
    assert nc == cfg.enc_layers + 2 * cfg.n_layers and npl == 0
    assert abs(lc - lp) <= 1e-5 * abs(lp)
    for a, b in zip(gc_, gp):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4


def test_scans_refuse_inputs_that_require_grad(card):
    """K3 has its backward kernel now: on the card an input that requires
    grad goes through RGLRUScan (one forward and one backward launch, the
    gradients of autograd through the plain version within 1e-5 of each
    one's largest element), and under no_grad the forward alone runs, with
    no graph. (K2's: test_ssd_scan_under_grad_matches_plain.)"""
    x, log_a, h0 = _rglru_inputs(31, 1, 64, 32, card)
    leaves = [t.requires_grad_(True) for t in (x, log_a, h0)]
    fwd, bwd = K3.LAUNCHES, K3.BWD_LAUNCHES
    h, hl = rglru_op(*leaves)
    assert type(h.grad_fn).__name__ == "RGLRUScanBackward"
    w = torch.randn_like(h)
    got = torch.autograd.grad((h * w).sum() + hl.sum(), leaves)
    torch.cuda.synchronize()
    assert (K3.LAUNCHES, K3.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    ll = [t.detach().double().requires_grad_(True) for t in leaves]
    hh, hhl = ref.rglru(*ll)
    want = torch.autograd.grad((hh * w.double()).sum() + hhl.sum(), ll)
    for g, wv in zip(got, want):
        assert float((g.double() - wv).abs().max() / wv.abs().max()) <= RGLRU_TOL
    with torch.no_grad():
        h, _ = rglru_op(*leaves)
    assert h.grad_fn is None and K3.BWD_LAUNCHES == bwd + 1


def test_device_feed_on_card(card):
    """Each batch comes through a pinned buffer and a copy stream; the
    caller's stream waits on the copy, so values arrive whole, in order,
    at depth 2 and serially."""
    from repro_torch.data import device_feed

    rng = np.random.default_rng(26)
    host = [{"data": rng.integers(0, 100, (4, 1024)).astype(np.int32), "label": np.arange(4, dtype=np.int32)}
            for _ in range(6)]
    for depth in (0, 2):
        feed = device_feed(iter(host), device=card, depth=depth)
        got = list(feed)
        feed.close()
        assert len(got) == len(host)
        for g, h in zip(got, host):
            assert g["data"].device.type == "cuda"
            assert all(np.array_equal(g[k].cpu().numpy(), h[k]) for k in h)


def _resume_on_card(card, tmp_path, opt):
    import importlib.util
    from pathlib import Path

    import repro_torch.core as core
    from repro_torch.data import ingest
    from repro_torch.data.formats import RawCodec
    from repro_torch.train import TrainingJob

    spec_ = importlib.util.spec_from_file_location(
        "torch_train_lm", Path(__file__).resolve().parents[1] / "examples" / "torch_train_lm.py")
    ex = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(ex)
    cfg = dataclasses.replace(configs.get_reduced("yi-6b"), head_dim=64)
    corpus = ex.synth_corpus(40, cfg.vocab, seq=65, seed=7)
    log, reg = core.StreamLog(), core.Registry()
    spec = reg.register_model("yi-6b-smoke")
    dep = reg.deploy(reg.create_configuration([spec.model_id]).config_id, "train")
    log.create_topic("corpus", core.LogConfig(num_partitions=2))
    ingest(log, "corpus", RawCodec("int32", (65,), "int32", ()),
           {"data": corpus, "label": np.zeros(40, np.int32)}, dep.deployment_id, validation_rate=0.2)
    model = StreamModel(cfg, Policy(), device=card, generator=None)

    def run(d, **kw):
        job = TrainingJob(log, reg, dep.deployment_id, spec.model_id,
                          loss_fn=lambda p, b: model.loss(p, {"tokens": b["data"]}), init_fn=model.init,
                          opt=opt(1e-3), ckpt_dir=str(d), ckpt_every=4, seed=3, device=card)
        return job.run(batch_size=4, max_steps=10, streaming=True, fetch_records=8, **kw)

    n_b = fa.BWD_LAUNCHES
    ref_run = run(tmp_path / "ref")
    assert fa.BWD_LAUNCHES - n_b == 10 * cfg.n_layers
    with pytest.raises(RuntimeError, match="injected crash"):
        run(tmp_path / "c", crash_after=5)
    res = run(tmp_path / "c", resume=True)
    assert res.steps == 10 and np.isfinite(res.metrics["loss"])
    assert res.metrics["loss"] == pytest.approx(ref_run.metrics["loss"], abs=1e-4)
    return model


def test_training_job_resume_on_card(card, tmp_path):
    """Reduced yi-6b at K1's head dim 64 in bf16, trained from a stream on
    the card through K1 forward and backward: a job killed mid-run and
    resumed from its checkpoint ends on the uninterrupted run's loss."""
    from repro_torch.train import adamw

    _resume_on_card(card, tmp_path, adamw)


def test_training_job_resume_on_card_adamw8bit(card, tmp_path):
    """The same with adamw8bit: its state (codes and scales on the card)
    goes through the checkpoint, and every update is one kernel launch a
    leaf: 21 updates (10; 5 before the crash; 6 after resuming from the
    step-4 checkpoint)."""
    from repro_torch.train import adamw8bit
    from repro_torch.train.optimizer import tree_leaves

    n8 = K8.LAUNCHES
    model = _resume_on_card(card, tmp_path, adamw8bit)
    assert K8.LAUNCHES - n8 == len(tree_leaves(model.param_tree())) * 21


# ------------------------------------------------------- the 8-bit AdamW update
def _state8(shape, zero: bool, seed: int, device):
    """(m codes, m scales, v codes, v scales): adamw8bit's zero state, or one
    quantized from random moments (m ~ N(0, 1e-3), v spread over 20
    octaves below 1e-4) by the port's quantizers."""
    from repro_torch.train import adamw8bit

    if zero:
        st = adamw8bit(1e-3).init({"p": torch.zeros(shape, device=device)})
        return (st["m"]["p"]["codes"], st["m"]["p"]["scales"], st["v"]["p"]["codes"], st["v"]["p"]["scales"])
    rng = np.random.default_rng(seed)
    m = torch.from_numpy((rng.standard_normal(shape) * 1e-3).astype(np.float32)).to(device)
    v = torch.from_numpy((1e-4 * np.exp2(-20 * rng.random(shape))).astype(np.float32)).to(device)
    return (*ref.quantize(m), *ref.quantize_log(v))


def _scalars8(step: int):
    lr = torch.tensor(3e-4, dtype=torch.float32)
    stepf = torch.tensor(step, dtype=torch.float32)
    return dict(lr=lr, bc1=1 - torch.tensor(0.9, dtype=torch.float32) ** stepf,
                bc2=1 - torch.tensor(0.95, dtype=torch.float32) ** stepf, b1=0.9, b2=0.95, eps=1e-8,
                weight_decay=0.01)


def _assert_update8_close(got, want, dtype):
    """chip_smoke.py's gate: p within the CPU tests' tolerance (1e-5
    relative in f32, one bf16 step), m codes and scales equal, v codes at
    most 1 apart on at most 0.1% of entries."""
    (p, mc, ms, vc, vs), (p0, mc0, ms0, vc0, vs0) = got, want
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -8
    torch.testing.assert_close(p.float(), p0.float(), rtol=rtol, atol=1e-7)
    assert torch.equal(mc, mc0) and torch.equal(ms, ms0)
    d = (vc.int() - vc0.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
    torch.testing.assert_close(vs, vs0, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("step", [1, 100])
@pytest.mark.parametrize("shape", [(2, 3, 128), (5, 300), (3, 4096), (2, 11008), (77,)])
def test_adamw8bit_kernel_matches_plain(card, dtype, step, shape):
    """The kernel against its plain version on the card: yi-6b's trailing
    dims (128, 4096, 11008), a partial block, a 1-d leaf; a zero state at
    step 1, a random one at step 100; the first block's gradient zero."""
    rng = np.random.default_rng(step + shape[-1])
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.02).to(card, dtype)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 1e-3).to(card, dtype)
    g.view(-1, shape[-1])[0, :256] = 0
    state = _state8(shape, step == 1, step, card)
    kw = _scalars8(step)
    want = [t.clone() for t in (p, *state)]
    ref.adamw8bit_update(want[0], g, *want[1:], **kw)
    got = [t.clone() for t in (p, *state)]
    n = K8.LAUNCHES
    K8.adamw8bit_update(got[0], g, *got[1:], **kw)
    torch.cuda.synchronize()
    assert K8.LAUNCHES == n + 1
    _assert_update8_close(got, want, dtype)


def test_adamw8bit_kernel_updates_in_place(card):
    p = torch.randn((4, 4096), device=card, dtype=torch.bfloat16)
    g = torch.randn_like(p) * 1e-3
    state = _state8(p.shape, True, 0, card)
    before = [p.clone(), *(t.clone() for t in state)]
    ptrs = [t.data_ptr() for t in (p, *state)]
    K8.adamw8bit_update(p, g, *state, **_scalars8(1))
    torch.cuda.synchronize()
    assert [t.data_ptr() for t in (p, *state)] == ptrs
    assert all(not torch.equal(a, b) for a, b in zip((p, *state), before))


def test_adamw8bit_kernel_unaligned_rows(card):
    """A contiguous leaf whose base is not 16-byte aligned takes the
    element-a-lane path: the same result as the plain version."""
    shape = (3, 4096)
    flat = torch.randn(1 + 3 * 4096, device=card) * 0.02
    p = flat[1:].view(shape)
    assert p.is_contiguous() and p.data_ptr() % 16 != 0
    g = torch.randn(shape, device=card) * 1e-3
    state = _state8(shape, False, 3, card)
    kw = _scalars8(7)
    want = [t.clone() for t in (p, *state)]
    ref.adamw8bit_update(want[0], g, *want[1:], **kw)
    got = [p, *(t.clone() for t in state)]
    K8.adamw8bit_update(got[0], g, *got[1:], **kw)
    torch.cuda.synchronize()
    _assert_update8_close(got, want, torch.float32)


def test_adamw8bit_kernel_refuses_mixed_devices(card):
    p = torch.zeros((2, 256), device=card)
    state = _state8(p.shape, True, 0, card)
    n = K8.LAUNCHES
    with pytest.raises(ValueError):
        K8.adamw8bit_update(p, torch.zeros((2, 256)), *state, **_scalars8(1))
    with pytest.raises(ValueError):
        K8.adamw8bit_update(p, torch.zeros_like(p), state[0].cpu(), *state[1:], **_scalars8(1))
    assert K8.LAUNCHES == n


def test_adamw8bit_optimizer_on_card_launches_a_kernel_a_leaf(card):
    """``adamw8bit.update`` on a tree on the card: one launch of the update
    a leaf and of the norm a leaf plus one, and the same result as the
    same update through the plain version with the norm kernel's clip
    scale (the same bits as the optimizer's: the norm is deterministic)."""
    from repro_torch.train import adamw8bit

    gen = torch.Generator(device=card).manual_seed(0)
    params = {"a": torch.randn((2, 3, 128), device=card, generator=gen).to(torch.bfloat16),
              "b": torch.randn((300,), device=card, generator=gen)}
    grads = {k: torch.randn(v.shape, device=card, generator=gen).to(v.dtype) for k, v in params.items()}
    opt = adamw8bit(1e-3)
    state = opt.init(params)
    ref_p = {k: v.clone() for k, v in params.items()}
    ref_s = {"m": {k: {f: t.clone() for f, t in q.items()} for k, q in state["m"].items()},
             "v": {k: {f: t.clone() for f, t in q.items()} for k, q in state["v"].items()}}
    n, n_norm = K8.LAUNCHES, GN.LAUNCHES
    opt.update({k: v.clone() for k, v in grads.items()}, state, params)
    torch.cuda.synchronize()
    assert K8.LAUNCHES == n + 2 and GN.LAUNCHES == n_norm + 3 and int(state["step"]) == 1
    _, scale = GN.global_norm([grads[k] for k in sorted(grads)], 1.0)
    assert float(scale) < 1
    for k in params:
        ref.adamw8bit_update(ref_p[k], grads[k], ref_s["m"][k]["codes"], ref_s["m"][k]["scales"],
                             ref_s["v"][k]["codes"], ref_s["v"][k]["scales"], **{**_scalars8(1), "lr": torch.tensor(1e-3)},
                             clip_scale=scale)
        _assert_update8_close(
            (params[k], state["m"][k]["codes"], state["m"][k]["scales"], state["v"][k]["codes"], state["v"][k]["scales"]),
            (ref_p[k], ref_s["m"][k]["codes"], ref_s["m"][k]["scales"], ref_s["v"][k]["codes"], ref_s["v"][k]["scales"]),
            params[k].dtype)


# the norm kernel against its plain version: both sum f32 squares, in
# another order (the kernel's threads, blocks and partials against
# torch.sum a layer slice at a time), so relative to the norm within 1e-5
# (a few thousand terms a running sum at these sizes: errors of order 1e-7)
NORM_RTOL = 1e-5


def _grad_leaves(seed, shapes, dtype, device, scale=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * scale).to(device, dtype) for s in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shapes", [
    [(2, 3, 128), (300,), (1,)],  # small leaves, odd sizes, one element
    [(3, 4096, 11), (4097,), (64, 1000)],  # a leaf of several partials; odd tails past the 16-byte loads
    [(600, 4096)],  # 1024 partials of one leaf (the cap)
])
def test_grad_norm_kernel_matches_plain(card, dtype, shapes):
    """The norm and clip scale against ``ref.global_norm`` on the card,
    within NORM_RTOL; two calls give the same bits; one launch a leaf and
    one to finish."""
    leaves = _grad_leaves(11, shapes, dtype, card)
    n = GN.LAUNCHES
    norm, scale = GN.global_norm(leaves, 1.0)
    torch.cuda.synchronize()
    assert GN.LAUNCHES == n + len(leaves) + 1
    want_norm, want_scale = ref.global_norm(leaves, 1.0)
    torch.testing.assert_close(norm, want_norm, rtol=NORM_RTOL, atol=0)
    torch.testing.assert_close(scale, want_scale, rtol=NORM_RTOL, atol=0)
    norm2, scale2 = GN.global_norm(leaves, 1.0)
    assert torch.equal(norm, norm2) and torch.equal(scale, scale2)
    # with a clip that does not bite, the scale is 1 exactly, as the plain version's
    assert float(GN.global_norm(leaves, 1e9)[1]) == 1.0 == float(ref.global_norm(leaves, 1e9)[1])


def test_grad_norm_kernel_takes_misaligned_views(card):
    """A contiguous leaf whose base is not 16-byte aligned is read element
    by element: the same norm as the plain version's."""
    flat = torch.randn(1 + 3 * 4096, device=card)
    leaf = flat[1:].view(3, 4096)
    assert leaf.data_ptr() % 16 != 0
    torch.testing.assert_close(GN.global_norm([leaf], 1.0)[0], ref.global_norm([leaf], 1.0)[0], rtol=NORM_RTOL, atol=0)


def test_grad_norm_kernel_refuses_what_it_does_not_take(card):
    n = GN.LAUNCHES
    with pytest.raises(ValueError):
        GN.global_norm([torch.zeros(4, device=card), torch.zeros(4)], 1.0)
    with pytest.raises(TypeError):
        GN.global_norm([torch.zeros(4, device=card, dtype=torch.float16)], 1.0)
    with pytest.raises(ValueError):
        GN.global_norm([torch.zeros((4, 4), device=card).t()], 1.0)
    assert GN.LAUNCHES == n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("step", [1, 100])
@pytest.mark.parametrize("shape", [
    (2, 3, 128), (3, 128), (5, 64), (7, 100),  # n <= 128: two rows a warp, an odd last row; 100: by element
    (4, 136), (5, 300), (3, 4096), (2, 11008), (77,),
])
def test_adamw8bit_kernel_with_clip_matches_plain(card, dtype, step, shape):
    """The update with a device clip scale (from the norm kernel, below 1)
    against the plain version fed the same scale tensor: p, the m codes
    and scales equal to the bit, the v codes within chip_smoke's gate."""
    rng = np.random.default_rng(step + shape[-1] + len(shape))
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.02).to(card, dtype)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 1e-1).to(card, dtype)
    if g.numel() > 256:  # a zero block (a zero row where n <= 256), and a nonzero norm
        g.view(-1, shape[-1])[0, :256] = 0
    _, scale = GN.global_norm([g], 0.5)
    assert float(scale) < 1
    state = _state8(shape, step == 1, step, card)
    kw = {**_scalars8(step), "clip_scale": scale}
    want = [t.clone() for t in (p, *state)]
    ref.adamw8bit_update(want[0], g, *want[1:], **kw)
    got = [t.clone() for t in (p, *state)]
    g0 = g.clone()
    K8.adamw8bit_update(got[0], g, *got[1:], **kw)
    torch.cuda.synchronize()
    assert torch.equal(g, g0)  # g is read, not clipped in place
    assert torch.equal(got[0], want[0])
    _assert_update8_close(got, want, dtype)


@pytest.mark.parametrize("clip", [False, True], ids=["as_given", "clipped"])
@pytest.mark.parametrize("shape", [(3, 2, 300), (4, 4096), (77,)])
def test_adamw8bit_kernel_takes_f32_gradients_of_a_bf16_leaf(card, clip, shape):
    """A microbatched step's f32 gradient sums on a bf16 leaf: each layer
    slice of p updated in f32 by the f32 kernel and rounded back, against
    the plain version fed the same f32 g: p to the bit, the state within
    chip_smoke's gate; one launch a layer slice."""
    rng = np.random.default_rng(shape[-1] + len(shape))
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.02).to(card, torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 1e-1).to(card)
    state = _state8(shape, False, 7, card)
    kw = _scalars8(7)
    if clip:
        kw["clip_scale"] = GN.global_norm([g], 0.5)[1]
    want = [t.clone() for t in (p, *state)]
    ref.adamw8bit_update(want[0], g, *want[1:], **kw)
    got = [t.clone() for t in (p, *state)]
    n = K8.LAUNCHES
    K8.adamw8bit_update(got[0], g, *got[1:], **kw)
    torch.cuda.synchronize()
    assert K8.LAUNCHES == n + (shape[0] if len(shape) >= 3 else 1)
    assert got[0].dtype == torch.bfloat16 and torch.equal(got[0], want[0])
    _assert_update8_close(got, want, torch.bfloat16)


def test_adamw8bit_kernel_refuses_a_bad_clip_scale(card):
    p = torch.zeros((2, 256), device=card)
    state = _state8(p.shape, True, 0, card)
    for bad in (torch.ones(2, device=card), torch.ones((), device=card, dtype=torch.float64), torch.ones(())):
        with pytest.raises(ValueError):
            K8.adamw8bit_update(p, torch.zeros_like(p), *state, **_scalars8(1), clip_scale=bad)


# ------------------------------------------------------------ MoE training
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [1.0, 8.0])
def test_moe_gradients_on_card_repeat_to_the_bit(card, dtype, factor):
    """Reduced qwen3-moe (head dim 64, so its attention runs K1 forward and
    backward) on the card: the loss and every gradient leaf, the router's
    and the stacked experts' among them, give the same bits on a repeated
    call, with routes dropped (factor 1.0) and without (8.0): the
    dispatch's adjoint adds each token's slot rows in route order and the
    combine's writes each kept row once, so no atomics order a sum."""
    from repro_torch.models import moe
    from repro_torch.train.optimizer import tree_leaves

    cfg = configs.get_reduced("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(cfg, head_dim=64, vocab=250, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))
    model = StreamModel(cfg, Policy(dtype, dtype, dtype), device=card, generator=0)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (2, 96))).to(card)
    params = model.param_tree()
    model.requires_grad_(True)
    moe.DROPS = torch.zeros((), dtype=torch.int64, device=card)
    runs = []
    try:
        for _ in range(3):
            before = fa.BWD_LAUNCHES
            loss, _ = model.loss(params, {"tokens": tokens})
            runs.append((loss.detach(), torch.autograd.grad(loss, tree_leaves(params))))
            assert fa.BWD_LAUNCHES - before == cfg.n_layers
        drops = int(moe.DROPS)
    finally:
        model.requires_grad_(False)
        moe.DROPS = None
    assert (drops > 0) == (factor == 1.0)
    (l0, g0), *rest = runs
    assert torch.isfinite(l0) and all(bool(torch.isfinite(g).all()) for g in g0)
    for loss, grads in rest:
        assert torch.equal(loss, l0)
        assert all(torch.equal(a, b) for a, b in zip(grads, g0))


def test_adamw8bit_and_norm_past_2_31_elements(card):
    """A bf16 leaf of 2,147,681,792 elements (rows of 768, an expert
    leaf's trailing dim; its last 257 rows lie past element 2^31): two
    clipped updates of the 8-bit kernel over the whole leaf, the last 256
    rows after each held to the bit against ``ref.adamw8bit_update`` run
    on those rows alone (every block of a row is its own), and the norm
    kernel's norm of the leaf held to a float64 sum taken in chunks
    (relative 1e-5)."""
    from repro_torch.train import adamw8bit

    n = 768
    rows = 2 ** 31 // n + 257
    assert (rows - 256) * n > 2 ** 31
    gen = torch.Generator(device=card).manual_seed(0)
    p = torch.randn((rows, n), generator=gen, device=card, dtype=torch.bfloat16).mul_(0.02)
    st = adamw8bit(1e-3).init({"p": p})
    state = [st["m"]["p"]["codes"], st["m"]["p"]["scales"], st["v"]["p"]["codes"], st["v"]["p"]["scales"]]
    tail = [t[-256:].clone() for t in (p, *state)]
    for step in (1, 2):
        g = torch.randn((rows, n), generator=gen, device=card, dtype=torch.bfloat16).mul_(1e-3)
        norm, scale = GN.global_norm([g], 1.0)
        want = torch.zeros((), dtype=torch.float64, device=card)
        for chunk in g.view(-1).split(1 << 28):
            want += chunk.double().square().sum()
        want = want.sqrt()
        assert float((norm.double() - want).abs() / want) <= 1e-5
        assert float(scale) < 1
        kw = {**_scalars8(step), "clip_scale": scale}
        g_tail = g[-256:].clone()
        K8.adamw8bit_update(p, g, *state, **kw)
        del g
        ref.adamw8bit_update(tail[0], g_tail, *tail[1:], **kw)
        torch.cuda.synchronize()
        for name, got, t in zip(("p", "m codes", "m scales", "v codes", "v scales"), (p, *state), tail):
            assert torch.equal(got[-256:], t), (step, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-2.7b"])
def test_remat_gradients_on_card_equal_none_to_the_bit(card, arch, dtype):
    """One attention stack (reduced yi-6b at head dim 64: K1 forward and
    backward) and one SSM stack (reduced mamba2: K2 forward and backward)
    on the card: the loss and every gradient leaf under ``Policy.remat``
    "full" and "block" equal "none"'s to the bit, and each recomputed
    group launches its kernel's forward once more."""
    from repro_torch.train.optimizer import tree_leaves

    cfg = dataclasses.replace(configs.get_reduced(arch), vocab=250)
    if arch == "yi-6b":
        cfg = dataclasses.replace(cfg, head_dim=64)
    model = StreamModel(cfg, Policy(dtype, dtype, dtype), device=card, generator=0)
    tokens = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (2, 96))).to(card)
    kernel = fa if arch == "yi-6b" else K2
    params = model.param_tree()
    model.requires_grad_(True)
    runs = {}
    try:
        for mode in ("none", "full", "block"):
            model.policy = dataclasses.replace(model.policy, remat=mode)
            before, before_bwd = kernel.LAUNCHES, kernel.BWD_LAUNCHES
            loss, _ = model.loss(params, {"tokens": tokens})
            grads = torch.autograd.grad(loss, tree_leaves(params))
            torch.cuda.synchronize()
            runs[mode] = (loss.detach(), grads, kernel.LAUNCHES - before, kernel.BWD_LAUNCHES - before_bwd)
    finally:
        model.requires_grad_(False)
    loss0, grads0, fwd0, bwd0 = runs["none"]
    assert fwd0 == bwd0 == cfg.n_layers and torch.isfinite(loss0)
    for mode in ("full", "block"):
        loss, grads, fwd, bwd = runs[mode]
        assert torch.equal(loss, loss0), mode
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0)), mode
        assert (fwd, bwd) == (2 * cfg.n_layers, cfg.n_layers), mode  # every layer is in a group


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 512), (3, 333), (2048 * 1024,)])
def test_int8_encode_on_card_matches_cpu(card, dtype, shape):
    """``compression.int8_encode`` and ``int8_decode`` on the card give the
    CPU's codes, scales and decoded values to the bit: whole and ragged
    blocks, an all-zero block, halfway values (k + 0.5 over a scale of 1)
    that round to even."""
    from repro_torch.train.compression import int8_decode, int8_encode

    x = np.random.default_rng(10).standard_normal(shape).astype(np.float32).reshape(-1)
    x[:256] = 0.0
    x[256:512] = np.arange(256) % 120 - 60 + 0.5
    x[256] = 127.0
    cpu = torch.from_numpy(x.reshape(shape)).to(getattr(torch, dtype))
    got, want = int8_encode(cpu.to(card)), int8_encode(cpu)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert float(want[1][0]) == 0.0 and float(want[1][1]) == 1.0
    dec = int8_decode(*got, shape, cpu.dtype)
    assert torch.equal(dec.cpu(), int8_decode(*want, shape, cpu.dtype))


# ------------------------------------------------------------ query offsets
# Context parallelism: S / tp queries from q_offset = r S / tp over all S
# keys, causal (and a window), each offset of a mesh in turn.
OFFSET_SWEEP = [  # (B, S, H, Kv, D, tp, window, softcap)
    (2, 448, 6, 6, 64, 4, None, None),      # whisper-tiny's decoder at model 4
    (1, 1024, 28, 4, 128, 8, None, None),   # qwen2-7b at model 8 (GQA 7)
    (1, 1024, 8, 4, 256, 8, 300, 50.0),     # gemma2-2b's heads, a window that binds, the softcap
    (1, 600, 16, 1, 256, 3, 200, None),     # recurrentgemma's heads: blocks of 200, mid-tile offsets
    (2, 390, 4, 2, 64, 3, 64, None),        # ragged blocks of 130
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,d,tp,window,cap", OFFSET_SWEEP)
def test_flash_attention_query_offset_sweep(card, dtype, b, s, h, kv, d, tp, window, cap):
    """K1 forward and backward at every rank's offset against the plain
    version with the offset (the forward at chip_smoke.py's criterion, the
    backward at BWD_TOL of each gradient's largest element); dk and dv of
    the keys past the last query are 0; one launch each, counted as an
    offset launch past rank 0."""
    rng = np.random.default_rng(s + tp)
    blk = s // tp
    k, v = (torch.from_numpy(rng.standard_normal((b, s, kv, d)).astype(np.float32)).to(card, getattr(torch, dtype))
            .transpose(1, 2) for _ in "kv")
    for r in range(tp):
        off = r * blk
        q, do = (torch.from_numpy(rng.standard_normal((b, blk, h, d)).astype(np.float32)).to(card, getattr(torch, dtype))
                 .transpose(1, 2) for _ in "qo")
        kw = dict(causal=True, window=window, softcap=cap, q_offset=off)
        n_f, n_o = fa.LAUNCHES, fa.OFFSET_LAUNCHES
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        want = ref.mha(q, k.repeat_interleave(h // kv, 1), v.repeat_interleave(h // kv, 1), **kw)
        torch.cuda.synchronize()
        assert (fa.LAUNCHES - n_f, fa.OFFSET_LAUNCHES - n_o) == (1, int(off > 0))
        tol = TOL[dtype]
        assert bool(((out.float() - want.float()).abs() <= tol + tol * want.float().abs()).all()), (r, off)
        got = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        grads = _plain_grads(q, k, v, do, True, window, cap, q_offset=off)
        for g, w in zip(got, grads):
            err = float((g.float() - w.float()).abs().max() / w.float().abs().max())
            assert err <= BWD_TOL[dtype], (r, off, err)
        if off + blk < s:
            assert not got[1][:, :, off + blk:].any() and not got[2][:, :, off + blk:].any()


@pytest.mark.parametrize("b,s,h,kv,d,tp,window,cap", OFFSET_SWEEP[:3])
def test_flash_attention_query_offset_bits_on_repeats(card, b, s, h, kv, d, tp, window, cap):
    """In bf16, at each rank's offset, the forward, its lse and the
    backward give the same bits on three calls; at offset 0 with Sq == Sk
    the call without the argument gives the same bits as with it."""
    rng = np.random.default_rng(7 * s + tp)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(card, torch.bfloat16).transpose(1, 2)

    k, v, blk = t(b, s, kv, d), t(b, s, kv, d), s // tp
    for off in (0, blk, (tp - 1) * blk):
        q, do = t(b, blk, h, d), t(b, blk, h, d)
        kw = dict(causal=True, window=window, softcap=cap, q_offset=off)
        first = fa.flash_attention(q, k, v, return_lse=True, **kw)
        g0 = fa.flash_attention_bwd(q, k, v, first[0], do, first[1], **kw)
        for _ in range(2):
            again = fa.flash_attention(q, k, v, return_lse=True, **kw)
            assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])
            assert all(torch.equal(x, y) for x, y in zip(g0, fa.flash_attention_bwd(q, k, v, *first[:1], do,
                                                                                      first[1], **kw)))
    q, do = t(b, s, h, d), t(b, s, h, d)
    kw = dict(causal=True, window=window, softcap=cap)
    o0, l0 = fa.flash_attention(q, k, v, return_lse=True, **kw)
    o1, l1 = fa.flash_attention(q, k, v, return_lse=True, q_offset=0, **kw)
    assert torch.equal(o0, o1) and torch.equal(l0, l1)
    assert all(torch.equal(x, y) for x, y in zip(fa.flash_attention_bwd(q, k, v, o0, do, l0, **kw),
                                                  fa.flash_attention_bwd(q, k, v, o0, do, l0, q_offset=0, **kw)))
