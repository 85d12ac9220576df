"""K2's backward (``csrc/ssd_scan_bwd.cu``) on the CPU: its arithmetic, in
its order.

The CUDA kernels cannot run here, so this file mirrors them in Python:
``kernel_model`` computes dx, ddt, dA, dB, dC and d(initial state) chunk by
chunk as the five kernels do: each chunk's cumsum of dA, its own state
contribution D and its backward one E; the state passing (the incoming
states recomputed left to right, the outgoing states' gradients right to
left); then per chunk a row pass over 64-position tiles at or below the
diagonal (dC and the row terms of d ca), a column pass (du, dB and the
column terms), d tot, the reverse cumsum of d ca, and the chunk's share of
dA; last the heads' f32 partials of dB and dC added in head order and the
(batch, chunk) shares of dA in order. The tile size and the longest chunk
are read from the kernel's source.

Tolerances, each relative to the gradient leaf's largest element: in f32
the model against autograd through ``ref.ssd`` and against ``jax.grad`` of
the JAX package's ``ssd_chunked`` at 1e-4 (the same function summed in
other orders, with exps of cumsum differences that lose a few bits to
cancellation); with the kernel's bf16 roundings (inputs and dy on the bf16
grid, x * dt rounded to bf16, dx, dB and dC stored in bf16) against
autograd through ``ref.ssd`` on the same bf16 inputs at 2e-2 (the card's
bf16 tolerance, ``chip_smoke.SSD_TOL``). ``ssd_op`` under grad on the CPU
(``SSDScan``'s plain sides) is held to ``jax.grad`` at 1e-4 too. The kernel
itself is held on the card by tests/test_torch_kernels_cuda.py and
chip_smoke.py.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as K
from repro_torch.kernels.ops import ssd_op

SRC = (Path(K.__file__).resolve().parent / "csrc" / "ssd_scan_bwd.cu").read_text()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These shapes are tiny: torch's thread pool only contends with the
    other test workers, so each test here runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32_TOL, BF16_TOL = 1e-4, 2e-2


def _source_int(pattern: str) -> int:
    m = re.search(pattern, SRC)
    assert m is not None, f"{pattern!r} not in the kernel's source"
    return int(m.group(1))


TR = _source_int(r"constexpr int TR = (\d+);")  # positions a tile
MAX_Q = _source_int(r"constexpr int MAX_Q = (\d+);")  # longest chunk


def _exp(t):
    """e^t of an f64 cumsum difference, rounded to the working dtype first (the kernel's expf(float(...)))."""
    return torch.exp(t.to(torch.get_default_dtype()))


def kernel_model(x, dt, A, bm, cm, st0, dy, dsf, chunk, bf16=False, cumsum_dtype=torch.float64):
    """(dx, ddt, dA, dB, dC, d st0) in the kernels' order. x, dy (B, H, S, P),
    dt (B, H, S), A (H,), bm, cm (B, G, S, N), st0 and dsf (B, H, N, P) or
    None; all f32 (with ``bf16`` the values lie on the bf16 grid).
    ``cumsum_dtype`` f32 models a kernel that kept its cumsum in f32."""
    b, h, s, p = x.shape
    g, n = bm.shape[1], bm.shape[3]
    rep = h // g
    q = min(chunk, s)
    assert q <= MAX_Q
    nc = -(-s // q)
    rnd = (lambda t: t.bfloat16().float()) if bf16 else (lambda t: t)
    bh, ch = bm.repeat_interleave(rep, 1), cm.repeat_interleave(rep, 1)
    u = rnd(x * dt[..., None])  # x * dt rounded to x's dtype
    spans = [slice(c * q, min((c + 1) * q, s)) for c in range(nc)]

    # 1. chunk terms: the cumsum, D, E, tot
    cas, tots, Ds, Es = [], [], [], []
    for sl in spans:
        ca = torch.cumsum((dt[..., sl] * A[None, :, None]).to(cumsum_dtype), -1)  # f64 sums of f32 products
        tot = ca[..., -1]
        Ds.append(torch.einsum("bhjn,bhjp->bhnp", bh[:, :, sl], u[:, :, sl] * _exp(tot[..., None] - ca)[..., None]))
        Es.append(torch.einsum("bhin,bhip->bhnp", ch[:, :, sl], dy[:, :, sl] * _exp(ca)[..., None]))
        cas.append(ca)
        tots.append(tot)
    # 2. state passing: incoming states left to right, their adjoint right to left
    state = st0.clone() if st0 is not None else torch.zeros((b, h, n, p))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = _exp(tots[c])[..., None, None] * state + Ds[c]
    ds = dsf.clone() if dsf is not None else torch.zeros((b, h, n, p))
    douts = [None] * nc
    for c in reversed(range(nc)):
        douts[c] = ds
        ds = _exp(tots[c])[..., None, None] * ds + Es[c]
    dst0 = ds

    # 3. per chunk: row pass, column pass, d tot, da, ddt, dA's share
    dx, ddt = torch.zeros_like(x), torch.zeros_like(dt)
    dbp, dcp = torch.zeros((b, h, s, n)), torch.zeros((b, h, s, n))
    dap = torch.zeros((b, h, nc))
    for c, sl in enumerate(spans):
        ln = sl.stop - sl.start
        ca, tot, sp, dso = cas[c], tots[c], prev[c], douts[c]
        Bc, Cc, uc, yc = bh[:, :, sl], ch[:, :, sl], u[:, :, sl], dy[:, :, sl]
        dca = torch.zeros((b, h, ln))
        for i0 in range(0, ln, TR):  # rows
            ri = slice(i0, min(i0 + TR, ln))
            acc = torch.zeros((b, h, ri.stop - ri.start, n))
            rowd = torch.zeros((b, h, ri.stop - ri.start))
            for j0 in range(0, i0 + 1, TR):
                rj = slice(j0, min(j0 + TR, ln))
                sc = Cc[:, :, ri] @ Bc[:, :, rj].transpose(-1, -2)
                dsc = yc[:, :, ri] @ uc[:, :, rj].transpose(-1, -2)
                keep = torch.arange(rj.start, rj.stop)[None, :] <= torch.arange(ri.start, ri.stop)[:, None]
                diff = torch.where(keep, ca[..., ri, None] - ca[..., None, rj], -torch.inf)  # masked before the exp
                gd = dsc * _exp(diff)
                strict = torch.arange(rj.start, rj.stop)[None, :] < torch.arange(ri.start, ri.stop)[:, None]
                rowd += torch.where(strict, gd * sc, 0.0).sum(-1)  # a diagonal pair's terms cancel: left out
                acc += gd @ Bc[:, :, rj]
            v = _exp(ca[..., ri])[..., None] * (yc[:, :, ri] @ sp.transpose(-1, -2))  # e^{ca_i} S_prev dy_i
            rowd += (Cc[:, :, ri] * v).sum(-1)
            dca[..., ri] += rowd
            dcp[:, :, sl][:, :, ri] = acc + v
        for j0 in range(0, ln, TR):  # columns
            rj = slice(j0, min(j0 + TR, ln))
            w = _exp(tot[..., None] - ca[..., rj])[..., None]
            du = w * (Bc[:, :, rj] @ dso)
            db = w * (uc[:, :, rj] @ dso.transpose(-1, -2))
            sd = (uc[:, :, rj] * du).sum(-1)
            cold = -sd
            for i0 in range(j0, ln, TR):
                ri = slice(i0, min(i0 + TR, ln))
                sc = Bc[:, :, rj] @ Cc[:, :, ri].transpose(-1, -2)
                dsc = uc[:, :, rj] @ yc[:, :, ri].transpose(-1, -2)
                keep = torch.arange(rj.start, rj.stop)[:, None] <= torch.arange(ri.start, ri.stop)[None, :]
                e = _exp(torch.where(keep, ca[..., None, ri] - ca[..., rj, None], -torch.inf))
                strict = torch.arange(rj.start, rj.stop)[:, None] < torch.arange(ri.start, ri.stop)[None, :]
                cold = cold - torch.where(strict, dsc * e * sc, 0.0).sum(-1)
                du = du + (sc * e) @ yc[:, :, ri]
                db = db + (dsc * e) @ Cc[:, :, ri]
            pos = slice(sl.start + rj.start, sl.start + rj.stop)
            dx[:, :, pos] = rnd(du * dt[:, :, pos, None])
            ddt[:, :, pos] = (du * x[:, :, pos]).sum(-1)  # the x route; da's is added below
            dbp[:, :, pos] = db
            dca[..., rj] += cold
            if j0 == 0:
                wst = [sd]
            else:
                wst.append(sd)
        dca[..., ln - 1] += torch.cat(wst, -1).sum(-1) + _exp(tot) * (sp * dso).sum((-1, -2))
        da = torch.flip(torch.cumsum(torch.flip(dca, [-1]), -1), [-1])
        ddt[:, :, sl] += da * A[None, :, None]
        dap[:, :, c] = (da * dt[:, :, sl]).sum(-1)

    # 4, 5: the group sums in head order, dA's shares in (batch, chunk) order
    dB, dC = dbp[:, 0::rep].clone(), dcp[:, 0::rep].clone()
    for k in range(1, rep):
        dB += dbp[:, k::rep]
        dC += dcp[:, k::rep]
    dA = torch.zeros(h)
    for bi in range(b):
        for c in range(nc):
            dA += dap[bi, :, c]
    return dx, ddt, dA, rnd(dB), rnd(dC), dst0 if st0 is not None else None


def _inputs(seed, b, s, h, p, n, g, init, final):
    """Model-layout numpy arrays: x, dt, A, B, C, dy, st0, dsf (st0 / dsf None when not asked)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)  # softplus
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    st0 = rng.standard_normal((b, h, n, p)).astype(np.float32) if init else None
    dsf = rng.standard_normal((b, h, n, p)).astype(np.float32) if final else None
    return x, dt, A, bm, cm, dy, st0, dsf


def _heads(arrays):
    """numpy model layout -> torch (B, H, S, ...) views, as the kernel sees them."""
    x, dt, A, bm, cm, dy, st0, dsf = arrays
    t = torch.from_numpy
    return (t(x).transpose(1, 2), t(dt).transpose(1, 2), t(A), t(bm).transpose(1, 2), t(cm).transpose(1, 2),
            None if st0 is None else t(st0), t(dy).transpose(1, 2), None if dsf is None else t(dsf))


def _autograd(x, dt, A, bm, cm, st0, dy, dsf):
    """Autograd through ref.ssd with B and C repeated to the heads (the plain version)."""
    return K.ssd_scan_bwd(x, dt, A, bm, cm, st0, dy, dsf)


def _jax_grads(arrays, chunk):
    """jax.vjp of ssd_chunked, in the kernel's (B, H, S, ...) layout."""
    x, dt, A, bm, cm, dy, st0, dsf = arrays
    b, s, h, p = x.shape
    n = bm.shape[3]
    primals = [jnp.asarray(a) for a in (x, dt, A, bm, cm)]
    if st0 is not None:
        primals.append(jnp.asarray(st0))
        f = lambda x_, dt_, A_, b_, c_, s_: ssd_chunked(x_, dt_, A_, b_, c_, chunk, s_)  # noqa: E731
    else:
        f = lambda x_, dt_, A_, b_, c_: ssd_chunked(x_, dt_, A_, b_, c_, chunk)  # noqa: E731
    dfin = dsf if dsf is not None else np.zeros((b, h, n, p), np.float32)
    grads = jax.jit(lambda ps, ct: jax.vjp(f, *ps)[1](ct))(primals, (jnp.asarray(dy), jnp.asarray(dfin)))
    got = [torch.from_numpy(np.array(gr)) for gr in grads]
    out = [got[0].transpose(1, 2), got[1].transpose(1, 2), got[2], got[3].transpose(1, 2), got[4].transpose(1, 2)]
    return out + [got[5] if st0 is not None else None]


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


NAMES = ("dx", "ddt", "dA", "dB", "dC", "dst0")
# (b, s, h, p, n, g, chunk): G = 1, 2 and H; ragged S; chunks of one, two
# and a ragged number of tiles; a chunk past S
SHAPES = [
    (1, 128, 2, 32, 64, 1, 32),
    (2, 100, 4, 16, 32, 2, 64),
    (1, 77, 4, 16, 16, 4, 32),
    (2, 128, 2, 16, 32, 1, 128),
    (1, 90, 2, 16, 16, 2, 256),
    (1, 70, 2, 64, 16, 1, 48),
]
STATES = [(False, False), (True, False), (False, True), (True, True)]


def test_tile_constants_read_from_the_source():
    assert TR == 64 and MAX_Q == 256
    assert f"constexpr int MAX_Q = {K._MAX_CHUNK};" in SRC and f"constexpr int MAX_N = {K._MAX_STATE};" in SRC


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("init,final", STATES, ids=["none", "init", "final", "both"])
def test_kernel_model_matches_autograd_and_jax(shape, init, final):
    b, s, h, p, n, g, chunk = shape
    arrays = _inputs(41, b, s, h, p, n, g, init, final)
    x, dt, A, bm, cm, st0, dy, dsf = _heads(arrays)
    got = kernel_model(x, dt, A, bm, cm, st0, dy, dsf, chunk)
    want = _autograd(x, dt, A, bm, cm, st0, dy, dsf)
    want_jax = _jax_grads(arrays, chunk)
    for name, gr, w, wj in zip(NAMES, got, want, want_jax):
        if name == "dst0" and not init:
            assert gr is None and w is None and wj is None
            continue
        assert gr.shape == w.shape == wj.shape, name
        assert _rel(gr, w) <= F32_TOL, (name, _rel(gr, w))
        assert _rel(gr, wj) <= F32_TOL, (name, _rel(gr, wj))


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[1], SHAPES[2]])
def test_kernel_model_bf16_rounding_within_tolerance(shape):
    """x, B, C and dy on the bf16 grid, x * dt rounded to bf16 and dx, dB
    and dC stored in bf16 as the kernel rounds them: within the card's bf16
    tolerance of autograd through ref.ssd on the same bf16 inputs."""
    b, s, h, p, n, g, chunk = shape
    x, dt, A, bm, cm, st0, dy, dsf = _heads(_inputs(42, b, s, h, p, n, g, True, True))
    x, bm, cm, dy = (t.bfloat16() for t in (x, bm, cm, dy))
    got = kernel_model(x.float(), dt, A, bm.float(), cm.float(), st0, dy.float(), dsf, chunk, bf16=True)
    want = _autograd(x, dt, A, bm, cm, st0, dy, dsf)
    errs = {name: _rel(gr, w) for name, gr, w in zip(NAMES, got, want)}
    assert max(errs.values()) <= BF16_TOL, errs


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[4]])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_op_under_grad_matches_jax(shape, init):
    """ssd_op under grad on the CPU (SSDScan, both sides the plain version):
    the loss <y, dy> + <final state, dsf> gives jax.vjp's gradients."""
    b, s, h, p, n, g, chunk = shape
    arrays = _inputs(43, b, s, h, p, n, g, init, True)
    xa, dta, Aa, bma, cma, dya, st0a, dsfa = arrays
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (xa, dta, Aa, bma, cma)]
    st0 = torch.from_numpy(st0a).requires_grad_(True) if init else None
    y, st = ssd_op(*leaves, st0, chunk=chunk)
    assert y.grad_fn is not None
    loss = (y * torch.from_numpy(dya)).sum() + (st * torch.from_numpy(dsfa)).sum()
    got = torch.autograd.grad(loss, leaves + ([st0] if init else []))
    want = _jax_grads(arrays, chunk)
    layout = [lambda t: t.transpose(1, 2), lambda t: t.transpose(1, 2), lambda t: t,
              lambda t: t.transpose(1, 2), lambda t: t.transpose(1, 2), lambda t: t]
    for name, gr, w, back in zip(NAMES, got, want, layout):
        assert _rel(gr, back(w)) <= F32_TOL, (name, _rel(gr, back(w)))


def test_ssd_op_without_final_state_gradient():
    """In training the new state feeds no loss: SSDScan's backward takes a
    final-state gradient of None, and gives what a zero one gives."""
    arrays = _inputs(44, 1, 50, 2, 16, 16, 1, False, False)
    xa, dta, Aa, bma, cma, dya, _, _ = arrays
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (xa, dta, Aa, bma, cma)]
    y, _ = ssd_op(*leaves, chunk=16)
    got = torch.autograd.grad((y * torch.from_numpy(dya)).sum(), leaves)
    want = _jax_grads(arrays, 16)
    for name, gr, w in zip(NAMES, got, want):
        assert _rel(gr, w if name == "dA" else w.transpose(1, 2)) <= F32_TOL, name


def test_cpu_backward_counts_no_launch():
    before = K.BWD_LAUNCHES
    x, dt, A, bm, cm, st0, dy, dsf = _heads(_inputs(45, 1, 20, 2, 16, 16, 1, True, True))
    K.ssd_scan_bwd(x, dt, A, bm, cm, st0, dy, dsf, chunk=8)
    assert K.BWD_LAUNCHES == before


@pytest.mark.parametrize("bad", ["dy_shape", "dy_dtype", "dfinal_dtype", "dfinal_shape", "chunk"])
def test_ssd_scan_bwd_rejects_bad_inputs(bad):
    x, dt, A, bm, cm, st0, dy, dsf = _heads(_inputs(46, 1, 20, 2, 16, 16, 1, True, True))
    kw = {"chunk": 8}
    if bad == "dy_shape":
        dy = dy[:, :, :10]
    elif bad == "dy_dtype":
        dy = dy.double()
    elif bad == "dfinal_dtype":
        dsf = dsf.bfloat16()
    elif bad == "dfinal_shape":
        dsf = dsf[:, :1]
    else:
        kw["chunk"] = 0
    with pytest.raises(ValueError):
        K.ssd_scan_bwd(x, dt, A, bm, cm, st0, dy, dsf, **kw)


def test_model_decays_and_long_chunks_stay_finite():
    """mamba2's own decays (A = -linspace(1, 16, H)) over a full 256 chunk:
    e^{tot - ca_j} and e^{ca_i} underflow toward 0 and nothing overflows
    (every pair above the diagonal is masked before its exp)."""
    b, s, h, p, n, g = 1, 128 + 5, 4, 16, 16, 1
    x, dt, _, bm, cm, st0, dy, dsf = _heads(_inputs(47, b, s, h, p, n, g, True, True))
    A = -torch.linspace(1.0, 16.0, h)
    got = kernel_model(x, dt, A, bm, cm, st0, dy, dsf, 256)
    want = _autograd(x, dt, A, bm, cm, st0, dy, dsf)
    for name, gr, w in zip(NAMES, got, want):
        assert torch.isfinite(gr).all(), name
        assert _rel(gr, w) <= F32_TOL, (name, _rel(gr, w))
    assert math.isfinite(float(got[2].sum()))


def test_f64_cumsum_keeps_the_near_pairs_decays():
    """One chunk of 128 at a decay of -14 (|ca| past 1400): every decay is
    an exp of a difference of two cumsums, where an f32 ulp (1.2e-4) is
    the whole f32 tolerance for near pairs. Against the model run in f64
    throughout, the kernel's f64 cumsum keeps ddt within 2e-6 of its
    largest element; an f32 cumsum strays past 5e-5 (measured 1.1e-4)."""
    b, s, h, p, n, g, chunk = SHAPES[3]
    args = _heads(_inputs(41, b, s, h, p, n, g, True, True))
    assert float(args[2].min()) < -14
    x, dt, A, bm, cm, st0, dy, dsf = args
    torch.set_default_dtype(torch.float64)
    try:
        truth = kernel_model(*(t.double() for t in args), chunk)
    finally:
        torch.set_default_dtype(torch.float32)
    kept = kernel_model(x, dt, A, bm, cm, st0, dy, dsf, chunk)
    lost = kernel_model(x, dt, A, bm, cm, st0, dy, dsf, chunk, cumsum_dtype=torch.float32)
    assert _rel(kept[1], truth[1]) <= 2e-6
    assert _rel(lost[1], truth[1]) > 5e-5
