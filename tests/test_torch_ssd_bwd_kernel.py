"""K2's backward (``csrc/ssd_scan_bwd.cu``) on the CPU: its arithmetic, in
its order.

The CUDA kernels cannot run here, so this file mirrors them in Python.
``kernel_model`` is the f32 path (the first kernel, f32 FMAs on the CUDA
cores): dx, ddt, dA, dB, dC and d(initial state) chunk by chunk as its
five kernels compute them: each chunk's cumsum of dA, its own state
contribution D and its backward one E; the state passing (the incoming
states recomputed left to right, the outgoing states' gradients right to
left); then per chunk a row pass over 64-position tiles at or below the
diagonal (dC and the row terms of d ca), a column pass (du, dB and the
column terms), d tot, the reverse cumsum of d ca, and the chunk's share of
dA; last the heads' f32 partials of dB and dC added in head order and the
(batch, chunk) shares of dA in order. ``kernel_model_bf16`` is the bf16
path (every product on wgmma): the same adjoint with its roundings (bf16
operands, hi + lo where they feed a carried state, the states handed on
in bf16) and dB and dC summed over each block of HEADS_PER_BLOCK heads,
its warpgroups' heads apart, then over the blocks. The tile size, the
longest chunk, the heads a block and the split are read from the kernel's
source.

Tolerances, each relative to the gradient leaf's largest element: in f32
the model against autograd through ``ref.ssd`` and against ``jax.grad`` of
the JAX package's ``ssd_chunked`` at 1e-4 (the same function summed in
other orders, with exps of cumsum differences that lose a few bits to
cancellation); the bf16 model (inputs, dt and dy on the bf16 grid) against
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


def kernel_model(x, dt, A, bm, cm, st0, dy, dsf, chunk, cumsum_dtype=torch.float64):
    """(dx, ddt, dA, dB, dC, d st0) in the f32 kernels' order. x, dy
    (B, H, S, P), dt (B, H, S), A (H,), bm, cm (B, G, S, N), st0 and dsf
    (B, H, N, P) or None; all f32. ``cumsum_dtype`` f32 models a kernel that
    kept its cumsum in f32."""
    b, h, s, p = x.shape
    g, n = bm.shape[1], bm.shape[3]
    rep = h // g
    q = min(chunk, s)
    assert q <= MAX_Q
    nc = -(-s // q)
    bh, ch = bm.repeat_interleave(rep, 1), cm.repeat_interleave(rep, 1)
    u = x * dt[..., None]
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
            dx[:, :, pos] = du * dt[:, :, pos, None]
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
    return dx, ddt, dA, dB, dC, dst0 if st0 is not None else None


HEADS_PER_BLOCK = _source_int(r"constexpr int HEADS_PER_BLOCK = (\d+);")  # the bf16 gradients kernel's
SPLIT_DE = re.search(r"constexpr bool SPLIT_DE = (true|false);", SRC).group(1) == "true"


def _bf(t):
    """t rounded to bf16, as f32."""
    return t.bfloat16().float()


def _split(v):
    """v as the bf16 pair hi + lo that wgmma adds into one f32 accumulator
    (lo: hi's rounding error, rounded); hi alone without SPLIT_DE."""
    hi = _bf(v)
    return hi + _bf(v - hi) if SPLIT_DE else hi


def _heads_in_block_order(per_head, rep):
    """(B, H, S, N) f32 of each head -> (B, G, S, N), summed as the bf16
    gradients kernel sums: blocks of HEADS_PER_BLOCK heads of a group (the
    last may hold fewer); in a block warpgroup 0 takes every other head from
    the first and warpgroup 1 the rest, each in head order, then 1's sum is
    added to 0's; the blocks' partials are added in order."""
    b, h, s, n = per_head.shape
    out = torch.zeros((b, h // rep, s, n))
    for g in range(h // rep):
        total = torch.zeros((b, s, n))
        for h0 in range(0, rep, HEADS_PER_BLOCK):
            nh = min(HEADS_PER_BLOCK, rep - h0)
            sums = []
            for wg in range(2):
                acc = torch.zeros((b, s, n))
                for k in range(wg, nh, 2):
                    acc = acc + per_head[:, g * rep + h0 + k]
                sums.append(acc)
            total = total + (sums[0] + sums[1])
        out[:, g] = total
    return out


def kernel_model_bf16(x, dt, A, bm, cm, st0, dy, dsf, chunk):
    """(dx, ddt, dA, dB, dC, d st0) as the bf16 kernels compute them; x, bm,
    cm and dy f32 on the bf16 grid, the rest as ``kernel_model`` takes.

    The roundings it adds to the f32 adjoint: u = x * dt to bf16; D's
    decayed u and E's decayed dy as bf16 hi + lo (SPLIT_DE); each chunk's
    incoming state and the gradient of its outgoing state to bf16 as
    operands (their f32 recurrences unrounded, <S_prev, dS> from them);
    the decayed scores (C B^T) o L and G = (dy u^T) o L to bf16 as the A
    operands of du, dC and dB; dx, dB and dC stored in bf16. Every product
    of bf16 operands sums in f32; the row and column terms of d ca sum G o
    scores in f32. The heads' dB and dC add in the kernel's block order."""
    b, h, s, p = x.shape
    g, n = bm.shape[1], bm.shape[3]
    rep = h // g
    q = min(chunk, s)
    assert q <= MAX_Q
    nc = -(-s // q)
    bh, ch = bm.repeat_interleave(rep, 1), cm.repeat_interleave(rep, 1)
    u = _bf(x * dt[..., None])
    spans = [slice(c * q, min((c + 1) * q, s)) for c in range(nc)]

    # 1. chunk terms on wgmma: the decayed operands split
    cas, Ds, Es = [], [], []
    for sl in spans:
        ca = torch.cumsum((dt[..., sl] * A[None, :, None]).double(), -1)
        w = torch.exp((ca[..., -1:] - ca).float())[..., None]
        Ds.append(torch.einsum("bhjn,bhjp->bhnp", bh[:, :, sl], _split(u[:, :, sl] * w)))
        Es.append(torch.einsum("bhin,bhip->bhnp", ch[:, :, sl], _split(dy[:, :, sl] * torch.exp(ca.float())[..., None])))
        cas.append(ca)
    # 2. state passing in f32; the operands handed on in bf16
    state = st0.clone() if st0 is not None else torch.zeros((b, h, n, p))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = torch.exp(cas[c][..., -1].float())[..., None, None] * state + Ds[c]
    ds = dsf.clone() if dsf is not None else torch.zeros((b, h, n, p))
    douts, sdot = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        douts[c], sdot[c] = ds, (prev[c] * ds).sum((-1, -2))
        ds = torch.exp(cas[c][..., -1].float())[..., None, None] * ds + Es[c]
    dst0 = ds

    # 3. gradients: the row and column terms, du, the heads' dB and dC
    dx, ddt, dA = torch.zeros_like(x), torch.zeros_like(dt), torch.zeros(h)
    dBh, dCh = torch.zeros((b, h, s, n)), torch.zeros((b, h, s, n))
    for c, sl in enumerate(spans):
        ln = sl.stop - sl.start
        ca, tot = cas[c], cas[c][..., -1]
        Bc, Cc, uc, yc = bh[:, :, sl], ch[:, :, sl], u[:, :, sl], dy[:, :, sl]
        sp16, ds16 = _bf(prev[c]), _bf(douts[c])
        rows = torch.arange(ln)
        keep = rows[None, :] <= rows[:, None]
        e = torch.exp(torch.where(keep, (ca[..., :, None] - ca[..., None, :]).float(), -torch.inf))
        sc, G = Cc @ Bc.transpose(-1, -2), (yc @ uc.transpose(-1, -2)) * e
        M = torch.where(rows[None, :] < rows[:, None], G * sc, 0.0)  # a diagonal pair's terms cancel
        Z = torch.exp(ca.float())[..., None] * (yc @ sp16.transpose(-1, -2))
        w = torch.exp((tot[..., None] - ca).float())[..., None]
        du_state = w * (Bc @ ds16)
        wst = (uc * du_state).sum(-1)
        du = du_state + _bf(sc * e).transpose(-1, -2) @ yc
        dCh[:, :, sl] = Z + _bf(G) @ Bc
        dBh[:, :, sl] = w * (uc @ ds16.transpose(-1, -2)) + _bf(G).transpose(-1, -2) @ Cc
        dca = M.sum(-1) + (Cc * Z).sum(-1) - M.sum(-2) - wst
        dx[:, :, sl] = _bf(du * dt[:, :, sl, None])
        # 4. finish: d tot at the chunk's last position, da by a reverse cumsum
        dca[..., -1] += wst.sum(-1) + torch.exp(tot.float()) * sdot[c]
        da = torch.flip(torch.cumsum(torch.flip(dca, [-1]), -1), [-1])
        ddt[:, :, sl] = (du * x[:, :, sl]).sum(-1) + da * A[None, :, None]
        dA += (da * dt[:, :, sl]).sum((0, -1))
    dB, dC = _bf(_heads_in_block_order(dBh, rep)), _bf(_heads_in_block_order(dCh, rep))
    return dx, ddt, dA, dB, dC, dst0 if st0 is not None else None


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
    assert HEADS_PER_BLOCK >= 1
    for name in ("SPLIT_DE", "FAST_DECAY", "HEADS_PER_BLOCK", "AHEAD", "TERMS_BLOCKS", "STAGGER"):  # --ablate's
        assert re.search(rf"constexpr (bool|int) {name} = ", SRC), name


@pytest.mark.parametrize("name,shape,stride,ptr,dtype,ok", [
    ("dy", (2, 4, 100, 64), (25600, 64, 256, 1), 0, torch.bfloat16, True),  # y's layout, (B, S, H, P)
    ("dy", (2, 4, 100, 64), (25600, 64, 256, 2), 0, torch.bfloat16, False),  # a strided last axis
    ("dy", (2, 4, 100, 16), (6400, 16, 64, 1), 16, torch.bfloat16, True),  # P 16, an aligned offset
    ("dy", (2, 4, 100, 36), (14400, 36, 144, 1), 0, torch.bfloat16, False),  # head stride 36: no 16 bytes
    ("dy", (2, 4, 100, 64), (25600, 64, 256, 1), 8, torch.bfloat16, False),  # misaligned base
    ("dy", (2, 4, 100, 36), (14400, 36, 144, 1), 8, torch.float32, True),  # f32: a unit last stride only
])
def test_layout_error_names_what_the_bf16_kernels_refuse(name, shape, stride, ptr, dtype, ok):
    """layout_error is None exactly where the kernels take the view; the
    backward copies dy (autograd's gradient, any layout) where it is not."""
    err = K.layout_error(name, shape, stride, ptr, dtype)
    assert (err is None) == ok, err


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


def _bf16_case(seed, shape, init, final):
    """bf16 inputs (x, B, C, dy and dt on the bf16 grid, where the plain
    version's x * dt and the kernel's round alike) as f32 tensors, for the
    model and for autograd through ref.ssd."""
    b, s, h, p, n, g, _ = shape
    x, dt, A, bm, cm, st0, dy, dsf = _heads(_inputs(seed, b, s, h, p, n, g, init, final))
    x, bm, cm, dy, dt = (_bf(t) for t in (x, bm, cm, dy, dt))
    return x, dt, A, bm, cm, st0, dy, dsf


def _hold_bf16_model(args, chunk):
    """The bf16 model against autograd through ref.ssd on the same bf16
    inputs: each leaf within BF16_TOL of its largest element."""
    x, dt, A, bm, cm, st0, dy, dsf = args
    got = kernel_model_bf16(*args, chunk)
    want = _autograd(x.bfloat16(), dt, A, bm.bfloat16(), cm.bfloat16(), st0, dy.bfloat16(), dsf)
    errs = {}
    for name, gr, w in zip(NAMES, got, want):
        if w is None:
            assert gr is None, name
            continue
        assert gr.shape == w.shape and bool(torch.isfinite(gr).all()), name
        errs[name] = _rel(gr, w)
    assert max(errs.values()) <= BF16_TOL, errs
    return errs


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[1], SHAPES[2]])
def test_kernel_model_bf16_rounding_within_tolerance(shape):
    """The bf16 path's roundings (kernel_model_bf16: bf16 operands of every
    product, split where they feed a carried state, the states handed on in
    bf16, dx, dB and dC stored in bf16), with a random initial state and
    d(final state): within the card's bf16 tolerance of autograd through
    ref.ssd on the same bf16 inputs."""
    _hold_bf16_model(_bf16_case(42, shape, True, True), shape[-1])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("init,final", STATES, ids=["none", "init", "final", "both"])
def test_bf16_model_matches_autograd(shape, init, final):
    """Every SHAPES case (G 1, 2 and H, ragged S and chunks) with and without
    each state."""
    _hold_bf16_model(_bf16_case(48, shape, init, final), shape[-1])


def test_bf16_model_heads_past_a_block():
    """A group of more heads than HEADS_PER_BLOCK, not a multiple of it:
    the last block of the group takes fewer heads, warpgroup 1 of a
    one-head block none; dB and dC still sum every head."""
    rep = HEADS_PER_BLOCK + 3
    shape = (1, 70, 2 * rep, 16, 16, 2, 64)
    _hold_bf16_model(_bf16_case(49, shape, True, False), shape[-1])
    per_head = torch.randn((1, 2 * rep, 5, 3), generator=torch.Generator().manual_seed(0))
    summed = _heads_in_block_order(per_head, rep)
    torch.testing.assert_close(summed, per_head.reshape(1, 2, rep, 5, 3).sum(2), rtol=1e-6, atol=1e-6)


def test_bf16_model_the_models_decays():
    """mamba2's decays (A = -linspace(1, 16, H)) over a full 256 chunk and a
    ragged one, no state, as the training path calls it: finite and within
    the bf16 tolerance."""
    shape = (1, 256 + 77, 4, 64, 128, 1, 256)
    x, dt, _, bm, cm, st0, dy, dsf = _bf16_case(50, shape, False, False)
    A = -torch.linspace(1.0, 16.0, shape[2])
    _hold_bf16_model((x, dt, A, bm, cm, st0, dy, dsf), 256)


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
