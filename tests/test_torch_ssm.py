"""The port's SSD scan, Mamba-2 mixer, model and engines against the JAX package's.

On the CPU the port's ``ssd_op`` computes the plain version of its kernel
(``ref.ssd``); the JAX ``ssd_op`` runs its Pallas kernel in interpret mode,
as tests/test_kernels.py runs it. Inputs come from numpy seeds and weights
are moved with ``convert.params_from_jax``. Tolerances:

- the scan: tests/test_kernels.py's, error relative to max(|want|.max(), 1)
  below 1e-3 in f32 and 2e-2 in bf16 (the sequential oracle against the
  chunked kernel sums in another order); 2e-4 against ``ssd_chunked`` as
  test_ssd_op_matches_model_layer holds it; 1e-5 between the two
  sequential oracles, which do the same f32 operations;
- the conv and the mixer: 1e-5 (f32, reduced mamba2);
- logits: 1e-4; greedy tokens and served records: identical.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_kernels_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.core as jcore
from repro.kernels import ref as jref
from repro.kernels.ops import ssd_op as jax_ssd_op
from repro.models import ssm as JS
from repro.models.model import StreamModel as JModel
from repro.models.policy import Policy as JPolicy
from repro.serve import lm_engine as J
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.core.log import StreamLog
from repro_torch.kernels import ops as ops_module, ref, ssd_scan as K2
from repro_torch.kernels.ops import ssd_op
from repro_torch.models import ssm as TS
from repro_torch.models.model import StreamModel
from repro_torch.models.policy import Policy
from repro_torch.serve import lm_engine as T

ARCH = "mamba2-2.7b"
SCAN_TOL = {"float32": 1e-3, "bfloat16": 2e-2}  # tests/test_kernels.py:69
ATOL = 1e-5
PLEN, GEN = 20, 6  # 20 = 16 + 4: a ragged tail at the reduced config's chunk of 16


def _rel_err(got, want) -> float:
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1.0))


def _scan_inputs(seed, b, s, h, p, n, g, state=True):
    """Model-layout SSD inputs: x (B,S,H,P), dt (B,S,H), A (H,), B/C (B,S,G,N), state."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    x, dt_raw, a_raw, bm, cm = f(b, s, h, p), f(b, s, h), f(h), f(b, s, g, n), f(b, s, g, n)
    dt = np.log1p(np.exp(dt_raw)).astype(np.float32)
    A = (-np.exp(a_raw)).astype(np.float32)
    st0 = f(b, h, n, p) if state else None
    return x, dt, A, bm, cm, st0


def _port_scan(arrays, dtype, chunk):
    x, dt, A, bm, cm, st0 = arrays
    tdt = getattr(torch, dtype)
    y, st = ssd_op(
        torch.from_numpy(x).to(tdt), torch.from_numpy(dt), torch.from_numpy(A),
        torch.from_numpy(bm).to(tdt), torch.from_numpy(cm).to(tdt),
        None if st0 is None else torch.from_numpy(st0), chunk=chunk,
    )
    assert y.dtype == tdt and st.dtype == torch.float32
    return y.float().numpy(), st.numpy()


def _jax_per_head(a, h):
    """(B, S, G, N) numpy -> (B, H, S, N) jax, groups repeated as jnp.repeat does."""
    t = jnp.moveaxis(jnp.asarray(a), 1, 2)
    return jnp.repeat(t, h // a.shape[2], axis=1)


# ------------------------------------------------------------------ the scan
def test_ref_ssd_matches_jax_ref():
    """The two sequential oracles, (B, H, S, P) layout, with an initial state."""
    b, h, s, p, n = 2, 3, 37, 8, 16
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, h, s, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, h, s)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, h, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, h, s, n)).astype(np.float32)
    st0 = rng.standard_normal((b, h, n, p)).astype(np.float32)
    yj, sj = jref.ssd(*(jnp.asarray(a) for a in (x, dt, A, bm, cm, st0)))
    yt, st = ref.ssd(*(torch.from_numpy(a) for a in (x, dt, A, bm, cm, st0)))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("b,h,s,p,n,g,chunk", [
    (1, 2, 128, 32, 64, 1, 32),
    (2, 4, 256, 64, 128, 2, 64),
    (1, 4, 64, 16, 32, 4, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_op_matches_jax_ssd_op(b, h, s, p, n, g, chunk, dtype):
    """tests/test_kernels.py:49-53's shapes, grouped B/C, an initial state."""
    arrays = _scan_inputs(h * 31 + s, b, s, h, p, n, g)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x, dt, A, bm, cm, st0 = arrays
    yj, sj = jax_ssd_op(
        jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(bm, jdt),
        jnp.asarray(cm, jdt), jnp.asarray(st0), chunk=chunk,
    )
    yt, st = _port_scan(arrays, dtype, chunk)
    assert yt.shape == (b, s, h, p) and st.shape == (b, h, n, p)
    assert _rel_err(yt, yj) < SCAN_TOL[dtype]
    assert _rel_err(st, sj) < SCAN_TOL[dtype]


def test_ssd_op_matches_ssd_chunked():
    """As tests/test_kernels.py:104 holds the JAX kernel to the model's layer."""
    arrays = _scan_inputs(3, 2, 128, 4, 16, 32, 2, state=False)
    yt, st = _port_scan(arrays, "float32", 32)
    ym, sm = JS.ssd_chunked(*(jnp.asarray(a) for a in arrays[:5]), chunk=32)
    np.testing.assert_allclose(yt, np.asarray(ym), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(st, np.asarray(sm), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("s,chunk", [(100, 32), (2000 % 256 + 17, 16), (5, 256)])
def test_ssd_op_ragged_matches_jax(s, chunk):
    """S dividing no chunk (the JAX kernel asserts it does): against the JAX
    oracle, and against ``ssd_chunked``, which pads with dt = 0; the final
    state is the state after exactly S positions."""
    h, g = 4, 2
    arrays = _scan_inputs(11 + s, 2, s, h, 16, 32, g)
    x, dt, A, bm, cm, st0 = arrays
    yt, st = _port_scan(arrays, "float32", chunk)
    yr, sr = jref.ssd(
        jnp.moveaxis(jnp.asarray(x), 1, 2), jnp.moveaxis(jnp.asarray(dt), 1, 2), jnp.asarray(A),
        _jax_per_head(bm, h), _jax_per_head(cm, h), jnp.asarray(st0),
    )
    assert _rel_err(yt, jnp.moveaxis(yr, 1, 2)) < 1e-5
    assert _rel_err(st, sr) < 1e-5
    ym, sm = JS.ssd_chunked(*(jnp.asarray(a) for a in arrays[:5]), chunk=chunk, init_state=jnp.asarray(st0))
    assert _rel_err(yt, ym) < SCAN_TOL["float32"]
    assert _rel_err(st, sm) < SCAN_TOL["float32"]


def test_ssd_op_bf16_matches_jax_oracle():
    """bf16 against the JAX oracle at the bf16 tolerance. The plain version
    forms x * dt in bf16 as ref.py:62 is written (dt rounded to bf16, the
    product rounded to bf16); XLA on the CPU keeps that product in f32
    (excess precision), and the kernel rounds the f32 product x * dt
    (ssd_scan.py:117). The three differ by bf16 roundings of x * dt only."""
    h = 2
    arrays = _scan_inputs(5, 1, 48, h, 16, 16, 1)
    x, dt, A, bm, cm, st0 = arrays
    yt, st = _port_scan(arrays, "bfloat16", 16)
    yr, sr = jref.ssd(
        jnp.moveaxis(jnp.asarray(x, jnp.bfloat16), 1, 2), jnp.moveaxis(jnp.asarray(dt), 1, 2),
        jnp.asarray(A), _jax_per_head(bm, h).astype(jnp.bfloat16),
        _jax_per_head(cm, h).astype(jnp.bfloat16), jnp.asarray(st0),
    )
    assert _rel_err(st, sr) < SCAN_TOL["bfloat16"]
    assert _rel_err(yt, jnp.moveaxis(yr, 1, 2)) < SCAN_TOL["bfloat16"]


def test_cpu_path_counts_no_launch():
    before = K2.LAUNCHES
    _port_scan(_scan_inputs(1, 1, 32, 2, 16, 16, 1), "float32", 16)
    assert K2.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "dt_dtype", "groups", "seq", "rank", "state"])
def test_ssd_scan_rejects_bad_inputs(bad):
    x, dt, A, bm, cm, st0 = (
        None if a is None else torch.from_numpy(a) for a in _scan_inputs(2, 1, 16, 4, 16, 16, 2)
    )
    x, dt, bm, cm = x.transpose(1, 2), dt.transpose(1, 2), bm.transpose(1, 2), cm.transpose(1, 2)
    if bad == "dtype":
        x, bm, cm = x.half(), bm.half(), cm.half()
    elif bad == "dt_dtype":
        dt = dt.double()
    elif bad == "groups":
        bm, cm = bm[:, :1].expand(1, 3, 16, 16), cm[:, :1].expand(1, 3, 16, 16)
    elif bad == "seq":
        bm, cm = bm[:, :, :8], cm[:, :, :8]
    elif bad == "rank":
        x = x[0]
    else:
        st0 = st0[..., :8]
    with pytest.raises((TypeError, ValueError)):
        K2.ssd_scan(x, dt, A, bm, cm, st0)


# ------------------------------------- the bf16 kernel's arithmetic, on the CPU
def _kernel_model(x, dt, A, bm, cm, st0, chunk, rounded):
    """The bf16 CUDA kernel's three phases (csrc/ssd_scan.cu) in torch ops,
    model layout: x (B,S,H,P), dt (B,S,H) f32, A (H,), B/C (B,S,G,N).

    (1) each chunk's contribution D_c = B^T (xdt o e^{ca_last - ca}) and
    decay e^{ca_last}; (2) state_{c+1} = e^{ca_last} state_c + D_c from
    st0; (3) y = e^{ca} (C . state_c) + ((C B^T) o L) xdt. xdt = x * dt
    rounded to x's dtype (ssd_scan.py:117). With ``rounded`` it rounds
    where the kernel does: the decayed xdt of D_c as bf16 hi + lo, the
    incoming state to bf16 for C . state, the decayed scores to bf16."""
    b, s, h, p = x.shape
    rep = h // bm.shape[2]
    bh = bm.float().repeat_interleave(rep, dim=2)  # (B, S, H, N)
    ch = cm.float().repeat_interleave(rep, dim=2)
    xdt = (x.float() * dt[..., None]).to(x.dtype).float()
    bf = lambda t: t.bfloat16().float() if rounded else t  # noqa: E731
    state = torch.zeros((b, h, bm.shape[3], p)) if st0 is None else st0.float()
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, min(c0 + chunk, s))
        ca = torch.cumsum(dt[:, sl] * A, dim=1)  # (B, L, H)
        last = ca[:, -1]  # (B, H)
        w = xdt[:, sl] * torch.exp(last[:, None] - ca)[..., None]
        if rounded:
            hi = w.bfloat16().float()
            w = hi + (w - hi).bfloat16().float()
        d_c = torch.einsum("blhn,blhp->bhnp", bh[:, sl], w)
        y = torch.einsum("blhn,bhnp->blhp", ch[:, sl], bf(state)) * torch.exp(ca)[..., None]
        ln = ca.shape[1]
        keep = torch.tril(torch.ones(ln, ln, dtype=torch.bool))
        diff = ca[:, :, None, :] - ca[:, None, :, :]  # (B, L_i, L_j, H)
        decay = torch.exp(torch.where(keep[None, :, :, None], diff, -torch.inf))  # masked before the exp
        scores = torch.einsum("bihn,bjhn->bijh", ch[:, sl], bh[:, sl]) * decay
        y = y + torch.einsum("bijh,bjhp->bihp", bf(scores), xdt[:, sl])
        ys.append(y)
        state = torch.exp(last)[..., None, None] * state + d_c
    return torch.cat(ys, dim=1).to(x.dtype), state


@pytest.mark.parametrize("s", [37, 301])
@pytest.mark.parametrize("chunk", [8, 64, 100, 256])
def test_kernel_model_f32_matches_ref(s, chunk):
    """The decomposition without its roundings is the function: in f32,
    ragged S, a random initial state, 1e-5 of the largest output."""
    h, g = 4, 2
    x, dt, A, bm, cm, st0 = (torch.from_numpy(a) for a in _scan_inputs(40 + s + chunk, 2, s, h, 16, 32, g))
    y, st = _kernel_model(x, dt, A, bm, cm, st0, chunk, rounded=False)
    yr, sr = ref.ssd(
        x.transpose(1, 2), dt.transpose(1, 2), A, bm.transpose(1, 2).repeat_interleave(h // g, 1),
        cm.transpose(1, 2).repeat_interleave(h // g, 1), st0,
    )
    assert _rel_err(y.numpy(), yr.transpose(1, 2).numpy()) < 1e-5
    assert _rel_err(st.numpy(), sr.numpy()) < 1e-5


@pytest.mark.parametrize("b,h,s,p,n,g,chunk", [
    (1, 2, 128, 32, 64, 1, 32),
    (2, 4, 256, 64, 128, 2, 64),
    (1, 4, 64, 16, 32, 4, 64),
])
def test_kernel_model_bf16_matches_jax_ssd_op(b, h, s, p, n, g, chunk):
    """With the kernel's roundings, on bf16 inputs, against the JAX
    ``ssd_op`` (its Pallas kernel in interpret mode, all f32 inside) at
    tests/test_kernels.py:49-53's shapes, within the bf16 gate."""
    arrays = _scan_inputs(h * 31 + s, b, s, h, p, n, g)
    x, dt, A, bm, cm, st0 = arrays
    yj, sj = jax_ssd_op(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(bm, jnp.bfloat16),
        jnp.asarray(cm, jnp.bfloat16), jnp.asarray(st0), chunk=chunk,
    )
    bf = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    y, st = _kernel_model(bf(x), torch.from_numpy(dt), torch.from_numpy(A), bf(bm), bf(cm),
                          torch.from_numpy(st0), chunk, rounded=True)
    assert y.dtype == torch.bfloat16
    assert _rel_err(y.float().numpy(), np.asarray(yj.astype(jnp.float32))) < SCAN_TOL["bfloat16"]
    assert _rel_err(st.numpy(), np.asarray(sj)) < SCAN_TOL["bfloat16"]


@pytest.mark.parametrize("chunk", [64, 256])
def test_kernel_model_hi_lo_split_keeps_the_state(chunk):
    """The state update's hi + lo split keeps the final state within 1e-5
    of the unrounded decomposition's on the same bf16 inputs (2e-6 here;
    the hi part alone gives 1e-3); the roundings of y's own products
    reach y only."""
    h, s = 4, 301
    x, dt, A, bm, cm, st0 = _scan_inputs(9 + chunk, 2, s, h, 64, 128, 1)
    bf = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    args = (bf(x), torch.from_numpy(dt), torch.from_numpy(A), bf(bm), bf(cm), torch.from_numpy(st0), chunk)
    _, st_exact = _kernel_model(*args, rounded=False)
    _, st_split = _kernel_model(*args, rounded=True)
    assert _rel_err(st_split.numpy(), st_exact.numpy()) < 1e-5


def _view(shape, stride, dtype=torch.bfloat16, offset=0):
    base = torch.zeros(offset + 1 + sum((n - 1) * st for n, st in zip(shape, stride)), dtype=dtype)
    return base.as_strided(shape, stride, offset)


@pytest.mark.parametrize("case", [
    "model_layout", "heads_major", "group_broadcast_over_batch", "batch_1_odd_batch_stride",
    "f32_any_stride", "dt_any_stride",
])
def test_check_layout_accepts(case):
    """Views the CUDA kernel takes: the last axis contiguous; in bf16 a
    16-byte aligned base and strides in multiples of 8 elements (0, a
    broadcast, too) along axes longer than 1; dt in any strides."""
    t = {
        "model_layout": lambda: torch.zeros((2, 40, 8, 64), dtype=torch.bfloat16).transpose(1, 2),
        "heads_major": lambda: torch.zeros((2, 8, 40, 32), dtype=torch.bfloat16),
        "group_broadcast_over_batch": lambda: torch.zeros((1, 40, 1, 128), dtype=torch.bfloat16)
        .expand(3, 40, 1, 128).transpose(1, 2),
        "batch_1_odd_batch_stride": lambda: _view((1, 4, 40, 16), (3, 16, 64, 1)),
        "f32_any_stride": lambda: _view((2, 3, 40, 64), (3 * 40 * 67, 67, 3 * 67, 1), dtype=torch.float32),
        "dt_any_stride": lambda: torch.zeros((2, 40, 5), dtype=torch.float32).transpose(1, 2),
    }[case]()
    K2.check_layout("t", t.shape, t.stride(), t.data_ptr(), t.dtype)


@pytest.mark.parametrize("case", [
    "last_dim_strided_bf16", "last_dim_strided_f32", "misaligned_base", "seq_stride_not_in_8s",
    "head_stride_not_in_8s", "batch_stride_not_in_8s",
])
def test_check_layout_refuses(case):
    """Views the CUDA kernel does not take raise ValueError before any
    launch: a last axis that is not contiguous in any dtype; in bf16 a base
    off 16 bytes, or a stride of an axis longer than 1 that is not a
    multiple of 8 elements (16 bytes)."""
    t = {
        "last_dim_strided_bf16": lambda: torch.zeros((1, 4, 64, 40), dtype=torch.bfloat16).transpose(2, 3),
        "last_dim_strided_f32": lambda: torch.zeros((1, 4, 64, 40), dtype=torch.float32).transpose(2, 3),
        "misaligned_base": lambda: _view((1, 4, 40, 64), (4 * 40 * 64, 64, 4 * 64, 1), offset=1),
        "seq_stride_not_in_8s": lambda: _view((1, 4, 40, 64), (40 * 260, 64, 260, 1)),
        "head_stride_not_in_8s": lambda: _view((1, 4, 40, 64), (40 * 4 * 72, 68, 4 * 72, 1)),
        "batch_stride_not_in_8s": lambda: _view((2, 4, 40, 64), (4 * 40 * 64 + 4, 64, 4 * 64, 1)),
    }[case]()
    with pytest.raises(ValueError):
        K2.check_layout("t", t.shape, t.stride(), t.data_ptr(), t.dtype)


@pytest.mark.parametrize("width", ["reduced", "full"])
def test_check_layout_accepts_the_mixers_views(width, monkeypatch):
    """The x, dt, B and C views that ``ssm_mixer`` hands the kernel (the
    heads of the conv output, dt after softplus, the B and C slices of the
    fused projection) in bf16, at mamba2's reduced and published widths:
    one layer, a short sequence."""
    cfg = TC.get_reduced(ARCH) if width == "reduced" else TC.get(ARCH)
    d, sp = cfg.d_model, cfg.ssm
    gen = torch.Generator().manual_seed(0)
    p = {
        k: torch.zeros(shape, dtype=torch.float32 if k in TS.F32_LEAVES else torch.bfloat16)
        for k, shape in TS.ssm_shapes(1, d, sp).items()
    }
    TS.ssm_init(p, d, sp, lambda t, scale: t.copy_(torch.randn(t.shape, generator=gen) * scale))
    seen = {}
    real = K2.ssd_scan

    def capture(x, dt, A, Bm, Cm, init_state=None, *, chunk):
        seen.update(x=x, dt=dt, Bm=Bm, Cm=Cm)
        return real(x, dt, A, Bm, Cm, init_state, chunk=chunk)

    monkeypatch.setattr(ops_module, "ssd_scan", capture)
    xin = torch.randn((2, 9, d), generator=gen).bfloat16()
    TS.ssm_mixer({k: v[0] for k, v in p.items()}, xin, sp)
    assert set(seen) == {"x", "dt", "Bm", "Cm"}
    assert seen["x"].shape == (2, sp.n_heads, 9, sp.head_dim) and seen["x"].dtype == torch.bfloat16
    assert seen["Bm"].shape == (2, sp.n_groups, 9, sp.state_dim) and seen["Cm"].dtype == torch.bfloat16
    for name, t in seen.items():
        K2.check_layout(name, t.shape, t.stride(), t.data_ptr(), t.dtype)


# ---------------------------------------------------------- mixer and model
@pytest.fixture(scope="module")
def pair():
    cfg = JC.get_reduced(ARCH)
    jm = JModel(cfg, JPolicy(param_dtype="float32", compute_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = StreamModel(
        TC.get_reduced(ARCH), Policy("float32", "float32", "float32"), device="cpu", generator=None
    )
    tm.load_params(convert.params_from_jax(jax.tree.map(np.asarray, jp)))
    return cfg, jm, jp, tm


def _layer0(jp):
    jblk = jax.tree.map(lambda a: a[0], jp["slots"]["s0"])
    return jblk, convert.params_from_jax(jax.tree.map(np.asarray, jblk))


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=atol)


def test_param_tree_matches_jax(pair):
    """Key for key and shape for shape: no unembed, norm2 or mlp."""
    _, _, jp, tm = pair
    flat_j = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jp))[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(convert.params_to_numpy(tm.param_tree()))[0])
    assert {p for p, _ in flat_j} == set(flat_t)
    for path, leaf in flat_j:
        assert flat_t[path].shape == leaf.shape, path
    assert "unembed" not in tm.param_tree() and set(tm.param_tree()["slots"]["s0"]) == {"norm1", "mixer"}


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches(with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state else None
    yj, sj = JS.causal_conv(jnp.asarray(x), jnp.asarray(w), None if st is None else jnp.asarray(st))
    yt, s_t = TS.causal_conv(torch.from_numpy(x), torch.from_numpy(w), None if st is None else torch.from_numpy(st))
    _close(yt, yj)
    _close(s_t, sj)  # the last W-1 raw inputs
    np.testing.assert_array_equal(s_t.numpy(), x[:, -3:])


def test_mixer_prefill_then_decode_matches(pair):
    """Prefill (S > 1, from a zero state) through ssd_op, then three decode
    steps through _ssd_step, each against the JAX mixer."""
    cfg, jm, jp, tm = pair
    jblk, tblk = _layer0(jp)
    sp = cfg.ssm
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, PLEN, cfg.d_model)).astype(np.float32)
    js0 = JS.ssm_init_state(2, sp)
    ts0 = TS.ssm_init_state(2, tm.cfg.ssm)
    yj, stj = JS.ssm_mixer(jblk["mixer"], jnp.asarray(x), sp, jm.policy, js0, cfg.norm_eps)
    yt, stt = TS.ssm_mixer(tblk["mixer"], torch.from_numpy(x), tm.cfg.ssm, ts0, cfg.norm_eps)
    _close(yt, yj)
    for k in ("conv", "ssd"):
        _close(stt[k], stj[k])
    for step in range(3):
        xs = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        yj, stj = JS.ssm_decode_step(jblk["mixer"], jnp.asarray(xs), sp, jm.policy, stj, cfg.norm_eps)
        yt, stt = TS.ssm_decode_step(tblk["mixer"], torch.from_numpy(xs), tm.cfg.ssm, stt, cfg.norm_eps)
        _close(yt, yj)
        for k in ("conv", "ssd"):
            _close(stt[k], stj[k])


def test_forward_logits_match(pair):
    cfg, jm, jp, tm = pair
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 37)).astype(np.int32)
    lj, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    lt = tm(torch.from_numpy(toks))
    assert lt.dtype == torch.float32 and lt.shape == (2, 37, cfg.vocab_padded)
    _close(lt, lj, atol=1e-4)


def test_prefill_matches_jax(pair):
    cfg, jm, jp, tm = pair
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, PLEN)).astype(np.int32)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 8, cache_dtype=jnp.float32)
    lt, ct = tm.prefill(torch.from_numpy(toks), 8, cache_dtype=torch.float32)
    _close(lt, lj, atol=1e-4)
    for key in ("conv", "ssd"):
        assert ct["slots"]["s0"][key].dtype == torch.float32
        _close(ct["slots"]["s0"][key], cj["slots"]["s0"][key], atol=1e-4)


def test_prefill_then_decode_matches_forward(pair):
    cfg, _, _, tm = pair
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab, (2, 24)).astype(np.int64))
    full = tm(toks)
    lg, cache = tm.prefill(toks[:, :18], 0, cache_dtype=torch.float32)
    _close(lg, full[:, 17], atol=1e-4)
    for i in range(18, 24):
        lg, cache = tm.decode_step(cache, toks[:, i : i + 1])
        _close(lg[:, 0], full[:, i], atol=1e-4)


def test_ssd_step_bf16_differs_from_jax_by_the_x_dt_rounding():
    """In bf16 the port's decode step rounds the f32 product x * dt once,
    as the prefill's kernel does (ssd_scan.py:117); the JAX step rounds dt
    to bf16 first and then the product (ssm.py:269). A bf16 rounding moves
    a value by at most 2^-8 of it, so the two x * dt differ by at most
    3 * 2^-8 |x dt| (one rounding against two), the new states by that
    times |B| per element, and y by that carried through C plus one
    rounding of y on each side; three steps, each from one shared state,
    at reduced mamba2's layer shapes."""
    b, h, p, n = 2, 4, 32, 16
    rng = np.random.default_rng(12)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    A = -np.linspace(1.0, 16.0, h, dtype=np.float32)
    st_t = torch.from_numpy(f(b, h, n, p))
    st_j = jnp.asarray(st_t.numpy())
    u = 2.0**-8
    for _ in range(3):
        x, bm, cm = (torch.from_numpy(a).bfloat16() for a in (f(b, 1, h, p), f(b, 1, 1, n), f(b, 1, 1, n)))
        dt = torch.from_numpy(np.log1p(np.exp(f(b, 1, h))).astype(np.float32))
        yt, new_t = TS._ssd_step(x, dt, torch.from_numpy(A), bm, cm, st_t)
        yj, new_j = JS._ssd_step(
            *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (x,)), jnp.asarray(dt.numpy()),
            jnp.asarray(A), *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (bm, cm)), st_j,
        )
        xdt = (x[:, 0].float() * dt[:, 0, :, None]).abs()  # (B, H, P)
        bound = 3 * u * bm[:, 0, 0].float().abs()[:, None, :, None] * xdt[:, :, None, :] + 1e-6
        d_state = (new_t - torch.from_numpy(np.array(new_j))).abs()
        assert bool((d_state <= bound).all()), float((d_state - bound).max())
        cb = (cm[:, 0, 0].float() * bm[:, 0, 0].float()).abs().sum(-1)  # sum_n |C_n B_n|
        y_j = torch.from_numpy(np.array(yj.astype(jnp.float32)))
        d_y = (yt.float() - y_j).abs()
        assert bool((d_y <= 3 * u * cb[:, None, None, None] * xdt[:, None] + 2 * u * y_j.abs() + 1e-5).all())
        st_t, st_j = new_t, jnp.asarray(new_t.numpy())  # both steps go on from one state


def test_bf16_prefill_and_decode_distance_from_jax():
    """Reduced mamba2 with bf16 weights and activations: the port's prefill
    and six teacher-forced decode steps against the JAX model's. The two
    round differently (op order, XLA's excess precision on the CPU, and the
    decode step's x * dt above), so their logits are held to 0.5, about an
    eighth of the largest logit; the prefill, which runs no decode step,
    is held to the same bound. A lost or stale state moves the logits by
    several units."""
    cfg = JC.get_reduced(ARCH)
    jm = JModel(cfg, JPolicy(param_dtype="bfloat16", compute_dtype="bfloat16"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = StreamModel(TC.get_reduced(ARCH), Policy(), device="cpu", generator=None)
    tm.load_params(convert.params_from_jax(jax.tree.map(np.asarray, jp)))
    toks = np.random.default_rng(10).integers(0, cfg.vocab, (4, PLEN + GEN)).astype(np.int32)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :PLEN])}, 8, cache_dtype=jnp.float32)
    lt, ct = tm.prefill(torch.from_numpy(toks[:, :PLEN]), 8, cache_dtype=torch.float32)
    assert float(np.abs(lt.numpy() - np.asarray(lj)).max()) <= 0.5
    for i in range(PLEN, PLEN + GEN):
        lj, cj = jm.decode_step(jp, cj, jnp.asarray(toks[:, i : i + 1]), i)
        lt, ct = tm.decode_step(ct, torch.from_numpy(toks[:, i : i + 1]))
        assert bool(torch.isfinite(lt).all())
        assert float(np.abs(lt.numpy() - np.asarray(lj)).max()) <= 0.5, i


def test_unsupported_ssm_configs_raise():
    base = TC.get_reduced(ARCH)
    for change in ({"ssm": None}, {"enc_dec": True}, {"moe": object()}):
        with pytest.raises(NotImplementedError):
            StreamModel(dataclasses.replace(base, **change), device="cpu")
    with pytest.raises(NotImplementedError):
        StreamModel(base, device="cpu").init_paged_cache(2, 8, 4, 4)


def test_seeded_init_scales_and_f32_leaves():
    cfg = TC.get_reduced(ARCH)
    a = StreamModel(cfg, Policy(), device="cpu", generator=3)
    b = StreamModel(cfg, Policy(), device="cpu", generator=3)
    ma, mb = a.param_tree()["slots"]["s0"]["mixer"], b.param_tree()["slots"]["s0"]["mixer"]
    assert torch.equal(ma["w_x"], mb["w_x"]) and ma["w_x"].dtype == torch.bfloat16
    for k in TS.F32_LEAVES:
        assert ma[k].dtype == torch.float32, k
    h = cfg.ssm.n_heads
    want_alog = np.log(np.linspace(1.0, 16.0, h, dtype=np.float32))
    np.testing.assert_allclose(ma["A_log"].numpy(), np.broadcast_to(want_alog, (cfg.n_layers, h)), rtol=1e-6)
    assert torch.equal(ma["D"], torch.ones(cfg.n_layers, h)) and not ma["dt_bias"].any()
    std = float(ma["w_out"].float().std())
    assert abs(std - 1 / np.sqrt(cfg.ssm.d_inner)) < 0.1 / np.sqrt(cfg.ssm.d_inner)
    assert abs(float(ma["conv_x"].float().std()) - 0.5) < 0.05


# ------------------------------------------------------------------ engines
def test_greedy_tokens_identical_to_jax_wave_engine(pair):
    """4 prompts of 20 tokens (a ragged tail at chunk 16), 6 new tokens."""
    cfg, jm, jp, tm = pair
    rng = np.random.default_rng(9)
    reqs = [(i, rng.integers(0, cfg.vocab, PLEN).astype(np.int32), GEN) for i in range(4)]
    jeng = J.LMEngine(jm, jp, n_slots=4, s_cache=PLEN + GEN)
    teng = T.LMEngine(tm, n_slots=4, s_cache=PLEN + GEN, device="cpu")
    for eng, mk in ((jeng, J.Request), (teng, T.Request)):
        for rid, prompt, max_new in reqs:
            eng.submit(mk(rid, prompt, max_new))
    want, got = dict(jeng.run_until_drained()), dict(teng.run_until_drained())
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert teng.waves == jeng.waves == 1


def test_serve_stream_fixed_prompts_byte_identical_to_jax(pair):
    """The JAX record format: int32[prompt_len] in, req_id || int32[max_new] out;
    6 prompts make a full wave and a padded one."""
    cfg, jm, jp, tm = pair
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (6, PLEN)).astype(np.int32)
    jlog, tlog = jcore.StreamLog(), StreamLog()
    for log in (jlog, tlog):
        log.create_topic("prompts")
        log.produce_batch("prompts", [p.tobytes() for p in prompts])
    jn = J.serve_stream(J.LMEngine(jm, jp, n_slots=4, s_cache=PLEN + GEN), jlog, "prompts", "out", PLEN, max_new=GEN)
    tn = T.serve_stream(T.LMEngine(tm, n_slots=4, device="cpu"), tlog, "prompts", "out", PLEN, max_new=GEN)
    assert jn == tn == 6
    jrec = [bytes(b) for b in jlog.read("out", 0, 0, 10).values]
    trec = [bytes(b) for b in tlog.read("out", 0, 0, 10).values]
    assert jrec == trec


def test_continuous_engine_refuses_ssm(pair):
    cfg, jm, jp, tm = pair
    with pytest.raises(NotImplementedError):
        J.ContinuousLMEngine(jm, jp, n_slots=2, n_blocks=8, block_size=8, max_blocks=4)
    with pytest.raises(NotImplementedError):
        T.ContinuousLMEngine(tm, n_slots=2, n_blocks=8, block_size=8, max_blocks=4, device="cpu")


def test_param_round_trip_keeps_f32_leaves_under_bf16():
    """A bf16 JAX tree moves across with A_log, D and dt_bias still f32,
    into a bf16 model and back, bit for bit."""
    cfg = JC.get_reduced(ARCH)
    jp = JModel(cfg, JPolicy(param_dtype="bfloat16", compute_dtype="bfloat16")).init(jax.random.PRNGKey(1))
    tree = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    mixer = tree["slots"]["s0"]["mixer"]
    assert mixer["w_x"].dtype == torch.bfloat16
    for k in TS.F32_LEAVES:
        assert mixer[k].dtype == torch.float32, k
    tm = StreamModel(TC.get_reduced(ARCH), Policy(), device="cpu", generator=None)
    tm.load_params(tree)
    for k in TS.F32_LEAVES:
        assert tm.param_tree()["slots"]["s0"]["mixer"][k].dtype == torch.float32
    back = convert.params_to_numpy(tm.param_tree())
    flat_t = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jp))[0]:
        np.testing.assert_array_equal(flat_t[path], np.asarray(leaf, np.float32))
