"""K3's backward (``csrc/rglru_scan_bwd.cu``) on the CPU: its arithmetic,
in its order, and its plain version ``ref.rglru_bwd``.

The CUDA kernel cannot run here, so ``kernel_model`` repeats what it
computes, in f32 and in its order: time blocks of ``warps * steps`` steps
from the last to the first; each warp's ``steps`` composed, last step
first, into one affine map of the carry c = a g that a step hands to the
one before (c_out = P c_in + Q: P the product of the warp's a, Q the chain
c = a (dh + c) from 0); the warps' maps folded into the running carry,
the last warp first; then each thread's steps again from its incoming
carry: g = dh + c, dx = w g, dlog_a = g (a h_{t-1} - a^2 x / w), c = a g.
Steps past S are identity maps (log a = 0, dh = 0), so d(h_last) reaches
step S - 1 unchanged; the carry left after step 0 is dh0. a is 2^(log a *
log2 e) with the product rounded to f32, as the kernel's FAST_EXP computes
it; w is sqrt(max(-expm1(2 log a), 0)), +0 at log a = 0. The steps a warp
and the warps a block are read from the kernel's source.

Tolerances. The model is held to ``ref.rglru_bwd`` run in float64, element
by element: |got - want| <= tol + tol * scale, with tol 1e-5 at
tests/test_kernels.py's decays and 1e-4 at the model's over S 3000 (the
tolerances chip_smoke.py holds the kernel to on the card, RGLRU_TOL and
RGLRU_F64_TOL). The scale is the size each gradient's f32 roundings are
relative to: g is a sum of dh terms that crosses 0, and dlog_a's bracket
(a h_{t-1} - a^2 x / w) a difference that does too. With G the same
chain over |dh| and |d(h_last)|, dx's scale is w G and dh0's a_0 G_0 (the
adjoint of |dh|), dlog_a's G (|a h_{t-1}| + |a^2 x / w|)
(chip_smoke.RGLRU_BWD_EDGES' comment). The model gets the float64 h
rounded to f32, so the check is of the backward's arithmetic alone.
``ref.rglru_bwd`` itself is held in float64 to autograd through
``ref.rglru`` and to ``jax.grad`` through the JAX package's
``repro.models.rglru.rglru_scan`` (its associative scan) relative to each
gradient's largest element: at 1e-12 at the tests' decays (the same
function, sums in another order) and at 1e-8 near a = 1 (log a in [-1e-6,
-1e-8]), where the reference forms' 1 - a a and 1 - exp(2 log a) keep
1e-16 / (2 |log a|) of relative error even in float64 (measured 4.8e-10),
with and without h0; at a = 1 exactly, where the derivative
of the weight's square root is infinite, it gives what JAX gives: dx 0 and
dlog_a an infinity of the sign of -g x, NaN where g x is 0. ``rglru_op``
under grad on the CPU (``RGLRUScan``'s plain sides) is held to ``jax.grad``
in f32 at 1e-5 of each gradient's largest element. The kernel itself is
held on the card by tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rglru import rglru_scan as jax_rglru_scan
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as K
from repro_torch.kernels.ops import rglru_op

SRC = (Path(K.__file__).resolve().parent / "csrc" / "rglru_scan_bwd.cu").read_text()
TOL = 1e-5  # tests/test_kernels.py:86, chip_smoke.RGLRU_TOL
F64_TOL = 1e-4  # chip_smoke.RGLRU_F64_TOL: the model's decays over thousands of steps
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These shapes are tiny: torch's thread pool only contends with the
    other test workers, so each test here runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _source_int(pattern: str) -> int:
    m = re.search(pattern, SRC)
    assert m is not None, f"{pattern!r} not in the kernel's source"
    return int(m.group(1))


WARPS = _source_int(r"constexpr int WARPS = (\d+);")
STEPS = _source_int(r"constexpr int STEPS = (\d+);")


def _weight(la):
    """w = sqrt(max(-expm1(2 log a), 0)), +0 (never -0) at log a = 0."""
    v = -torch.expm1(2 * la)
    return torch.sqrt(torch.where(v > 0, v, torch.zeros_like(v)))


def kernel_model(x, log_a, h0, h, dh, dh_last=None, warps=WARPS, steps=STEPS):
    """csrc/rglru_scan_bwd.cu in f32 torch ops; returns (dx, dlog_a, dh0)."""
    b, s, c = x.shape
    t_block = warps * steps
    carry = torch.zeros((b, c)) if dh_last is None else dh_last.clone()
    hprev = torch.cat([(torch.zeros((b, c)) if h0 is None else h0)[:, None], h[:, :-1]], 1)
    dx, dla = torch.empty((b, s, c)), torch.empty((b, s, c))
    for t0 in range((s - 1) // t_block * t_block, -1, -t_block):
        n = min(t_block, s - t0)
        blocks = []
        for src in (log_a, x, dh, hprev):
            pad = torch.zeros((b, t_block, c))
            pad[:, :n] = src[:, t0 : t0 + n]  # steps past S: log a = 0, dh = 0, the identity map
            blocks.append(pad.view(b, warps, steps, c))
        la, xx, dd, hp = blocks
        a = torch.exp2(la * LOG2E)  # FAST_EXP
        w = _weight(la)
        # 1. each warp's steps, last first: c_out = prod c_in + sum
        prod, acc = torch.ones((b, warps, c)), torch.zeros((b, warps, c))
        for u in range(steps - 1, -1, -1):
            acc = a[:, :, u] * (dd[:, :, u] + acc)
            prod = prod * a[:, :, u]
        # 2. the warps' maps folded into the running carry, the last warp first
        cin = torch.empty((b, warps, c))
        for wp in range(warps - 1, -1, -1):
            cin[:, wp] = carry
            carry = prod[:, wp] * carry + acc[:, wp]
        # 3. each warp's steps from its incoming carry, last first
        gx, gl = torch.empty((b, warps, steps, c)), torch.empty((b, warps, steps, c))
        cc = cin
        for u in range(steps - 1, -1, -1):
            g = dd[:, :, u] + cc
            cc = a[:, :, u] * g
            gx[:, :, u] = w[:, :, u] * g
            gl[:, :, u] = g * (a[:, :, u] * hp[:, :, u] - a[:, :, u] * a[:, :, u] * xx[:, :, u] / w[:, :, u])
        dx[:, t0 : t0 + n] = gx.reshape(b, t_block, c)[:, :n]
        dla[:, t0 : t0 + n] = gl.reshape(b, t_block, c)[:, :n]
    return dx, dla, (carry if h0 is not None else None)


def _inputs(seed, b, s, c, model_decays=False, h0=True, dh_last=True):
    """x, log_a (tests/test_kernels.py:81's -|N| * 0.3, or the model's
    log(u) r / 2 with u ~ U(0.81, 0.998) a channel and r a sigmoid gate),
    h0, dh and d(h_last), float64 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, c))
    if model_decays:
        u = rng.uniform(0.81, 0.998, c)
        r = 1 / (1 + np.exp(-rng.standard_normal((b, s, c))))
        log_a = np.log(u) * r / 2
    else:
        log_a = -np.abs(rng.standard_normal((b, s, c))) * 0.3
    return (x, log_a, rng.standard_normal((b, c)) if h0 else None, rng.standard_normal((b, s, c)),
            rng.standard_normal((b, c)) if dh_last else None)


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.asarray(a)).to(dtype)


def _el_err(got, want, scale, tol):
    """The largest |got - want| / (tol + tol * scale); <= 1 passes."""
    return float(((got.double() - want).abs() / (tol + tol * scale)).max())


def scales(x, la, h0, h, dh, dh_last):
    """Each gradient's scale for the element-wise check (float64): the
    adjoint of |dh| and |d(h_last)| for dx and dh0; for dlog_a G (|a
    h_{t-1}| + |a^2 x / w|), G that adjoint's chain."""
    a, w = torch.exp(la), _weight(la)
    hprev = torch.cat([(torch.zeros_like(h[:, 0]) if h0 is None else h0)[:, None], h[:, :-1]], 1)
    size = ref.rglru_bwd(x, la, h0, h, dh.abs(), None if dh_last is None else dh_last.abs())
    return size[0], size[0] / w * ((a * hprev).abs() + (a * a * x / w).abs()), size[2]


def _hold_to_float64(arrays, tol, **tiles):
    """The model on f32 inputs (h the float64 forward's, rounded to f32)
    against ref.rglru_bwd in float64 on the same inputs."""
    x, la, h0, dh, dl = (_t(a) for a in arrays)
    d64 = [None if t is None else t.double() for t in (x, la, h0, dh, dl)]
    h64, _ = ref.rglru(d64[0], d64[1], d64[2])
    got = kernel_model(x, la, h0, h64.float(), dh, dl, **tiles)
    want = ref.rglru_bwd(d64[0], d64[1], d64[2], h64, d64[3], d64[4])
    sc = scales(d64[0], d64[1], d64[2], h64, d64[3], d64[4])
    for name, gg, ww, sc in zip(("dx", "dlog_a", "dh0"), got, want, sc):
        if ww is None:
            assert gg is None
            continue
        assert gg.dtype == torch.float32 and bool(torch.isfinite(gg).all())
        assert _el_err(gg, ww, sc, tol) <= 1.0, (name, _el_err(gg, ww, sc, tol))


@pytest.mark.parametrize("b,s,c", [(1, 128, 64), (2, 256, 128), (3, 64, 256)])
@pytest.mark.parametrize("warps,steps", [(WARPS, STEPS), (16, 16), (8, 8), (4, 3)])
def test_kernel_model_matches_float64_at_test_kernels_shapes(b, s, c, warps, steps):
    """tests/test_kernels.py:77-87's shapes and decays, with h0 and
    d(h_last), under the kernel's tiles and others."""
    _hold_to_float64(_inputs(s + c, b, s, c), TOL, warps=warps, steps=steps)


@pytest.mark.parametrize("s", [1, 7, 9, 127, 128, 129, 257, 845])
@pytest.mark.parametrize("h0", [True, False])
def test_kernel_model_ragged_sequence(s, h0):
    """S at the edges of a warp's steps and of the time block, and past
    several time blocks, with h0 and d(h_last) present or absent: the
    padded steps are identity maps and the carry reaches step S - 1 and
    dh0 whole."""
    _hold_to_float64(_inputs(s, 2, s, 24, h0=h0, dh_last=h0), TOL)


def test_kernel_model_model_decays_long_sequence():
    """The model's decays (a up to about 0.9995) over S 3000 at a narrow C,
    a random h0 and d(h_last), against float64 at the path's 1e-4."""
    _hold_to_float64(_inputs(7, 1, 3000, 32, model_decays=True), F64_TOL)


def test_kernel_model_time_block_invariance():
    """The same input under two tilings (the kernel's and 4 warps of 3
    steps) within 1e-5 of each gradient's largest element: the tiles change
    only the order of roundings."""
    x, la, h0, dh, dl = (_t(a) for a in _inputs(11, 2, 700, 40, model_decays=True))
    h, _ = ref.rglru(x, la, h0)
    one = kernel_model(x, la, h0, h, dh, dl)
    two = kernel_model(x, la, h0, h, dh, dl, warps=4, steps=3)
    for p, q in zip(one, two):
        assert float((p - q).abs().max()) <= 1e-5 * float(q.abs().max())


def _jax_grads(x, la, h0, dh, dl):
    """jax.grad of <h, dh> + <h_last, dl> through JAX's associative scan."""
    def f(x, la, h0):
        h, hl = jax_rglru_scan(x, la, h0)
        return jnp.sum(h * dh) + (jnp.sum(hl * dl) if dl is not None else 0.0)

    args = (jnp.asarray(x), jnp.asarray(la), None if h0 is None else jnp.asarray(h0))
    if h0 is None:
        gx, gl = jax.grad(lambda a, b: f(a, b, None), argnums=(0, 1))(*args[:2])
        return np.asarray(gx), np.asarray(gl), None
    return tuple(np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(*args))


def _autograd64(x, la, h0, dh, dl):
    leaves = [None if a is None else torch.from_numpy(a).requires_grad_(True) for a in (x, la, h0)]
    h, hl = ref.rglru(*leaves)
    loss = (h * torch.from_numpy(dh)).sum() + ((hl * torch.from_numpy(dl)).sum() if dl is not None else 0.0)
    wrt = [t for t in leaves if t is not None]
    g = torch.autograd.grad(loss, wrt)
    return g[0], g[1], g[2] if h0 is not None else None


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("h0", [True, False])
@pytest.mark.parametrize("near_one", [False, True])
def test_ref_rglru_bwd_matches_autograd_and_jax_in_float64(h0, near_one):
    """``ref.rglru_bwd`` in float64 against autograd through ``ref.rglru``
    and against ``jax.grad`` through JAX's associative scan (float64 on
    the CPU), with and without h0 and d(h_last), at the tests' decays and
    near a = 1 (log a in [-1e-6, -1e-8]: w down to 1.4e-4, where a^2 x / w
    is largest)."""
    tol = 1e-8 if near_one else 1e-12
    x, la, hh0, dh, dl = _inputs(21, 2, 67, 9, h0=h0, dh_last=h0)
    if near_one:
        la = -np.random.default_rng(22).uniform(1e-8, 1e-6, la.shape)
    h, _ = ref.rglru(*(_t(a, torch.float64) for a in (x, la, hh0)))
    got = ref.rglru_bwd(*(_t(a, torch.float64) for a in (x, la, hh0)), h, _t(dh, torch.float64),
                        _t(dl, torch.float64))
    assert all(g is None or g.dtype == torch.float64 for g in got)
    want = _autograd64(x, la, hh0, dh, dl)
    with jax.enable_x64(True):
        want_jax = _jax_grads(x, la, hh0, dh, dl)
    for name, g, w, wj in zip(("dx", "dlog_a", "dh0"), got, want, want_jax):
        if not h0 and name == "dh0":
            assert g is None and w is None and wj is None
            continue
        assert _rel(g.numpy(), w.numpy()) <= tol, (name, _rel(g.numpy(), w.numpy()))
        assert _rel(g.numpy(), wj) <= tol, (name, _rel(g.numpy(), wj))


def test_ref_rglru_bwd_at_a_equal_one_gives_what_jax_gives():
    """At log a = 0 the weight is 0 and its derivative infinite: dx is 0 and
    dlog_a an infinity of the sign of -g x, NaN where x is 0, in JAX's
    gradient through its associative scan, in autograd through
    ``ref.rglru`` and in ``ref.rglru_bwd``; every other element is finite
    and the three agree there. The kernel model gives the same."""
    x, la, h0, dh, dl = _inputs(23, 2, 37, 5)
    la[0, 3, 1] = la[1, 10, 4] = la[0, 4, 2] = 0.0
    x[0, 4, 2] = 0.0
    with jax.enable_x64(True):
        gj = _jax_grads(x, la, h0, dh, dl)
    ga = _autograd64(x, la, h0, dh, dl)
    h64, _ = ref.rglru(*(_t(a, torch.float64) for a in (x, la, h0)))
    gr = ref.rglru_bwd(*(_t(a, torch.float64) for a in (x, la, h0)), h64, _t(dh, torch.float64),
                       _t(dl, torch.float64))
    x32, la32, h032, dh32, dl32 = (_t(a) for a in (x, la, h0, dh, dl))
    gm = kernel_model(x32, la32, h032, ref.rglru(x32, la32, h032)[0], dh32, dl32)
    edge = la == 0.0
    for gx, gl in ((gj[0], gj[1]), (ga[0].numpy(), ga[1].numpy()), (gr[0].numpy(), gr[1].numpy()),
                   (gm[0].numpy(), gm[1].numpy())):
        assert (gx[edge] == 0.0).all()
        assert np.isposinf(gl[0, 3, 1]) or np.isneginf(gl[0, 3, 1])
        assert np.isnan(gl[0, 4, 2])  # x = 0 there
        assert np.isfinite(gl[~edge]).all()
    for gl in (ga[1].numpy(), gr[1].numpy(), gm[1].numpy()):
        assert (np.sign(gl[edge & (x != 0)]) == np.sign(gj[1][edge & (x != 0)])).all()
    for g in (ga, gr):
        for p, q in zip(g[:2], gj[:2]):
            p = p.numpy()
            assert np.abs(p[~edge] - q[~edge]).max() <= 1e-12 * np.abs(q[~edge]).max()


@pytest.mark.parametrize("h0", [True, False])
def test_rglru_op_under_grad_matches_jax(h0):
    """``rglru_op`` under grad on the CPU goes through ``RGLRUScan``, whose
    sides are ``ref.rglru`` and ``ref.rglru_bwd`` (no kernel launched), and
    gives ``jax.grad``'s gradients through JAX's associative scan in f32 at
    1e-5 of each gradient's largest element."""
    x, la, hh0, dh, dl = (None if a is None else a.astype(np.float32)
                          for a in _inputs(24, 2, 300, 16, model_decays=True, h0=h0))
    leaves = [None if a is None else torch.from_numpy(a).requires_grad_(True) for a in (x, la, hh0)]
    K.LAUNCHES = K.BWD_LAUNCHES = 0
    h, hl = rglru_op(*leaves)
    assert type(h.grad_fn).__name__ == "RGLRUScanBackward"
    got = torch.autograd.grad((h * torch.from_numpy(dh)).sum() + (hl * torch.from_numpy(dl)).sum(),
                              [t for t in leaves if t is not None])
    assert K.LAUNCHES == K.BWD_LAUNCHES == 0
    want = _jax_grads(x, la, hh0, dh, dl)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= 1e-5


def test_rglru_op_without_grad_is_the_plain_forward():
    """No grad (or no input that requires it): the forward alone, no
    Function in the graph, as it serves."""
    x, la, h0, _, _ = (None if a is None else torch.from_numpy(a.astype(np.float32)) for a in _inputs(25, 1, 20, 8))
    h, _ = rglru_op(x, la, h0)
    assert h.grad_fn is None
    with torch.no_grad():
        h, _ = rglru_op(x.requires_grad_(True), la, h0)
    assert h.grad_fn is None


def test_decode_step_under_grad_reaches_no_function():
    """The mixer's decode step (S == 1 with a state) is torch ops under
    grad mode too: its graph holds no RGLRUScan and no kernel launches,
    and its gradients reach every weight; a prefill (S > 1) under grad
    goes through RGLRUScan."""
    from repro_torch import configs
    from repro_torch.models import rglru as R
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy

    cfg = configs.get_reduced("recurrentgemma-9b")
    tm = StreamModel(cfg, Policy("float32", "float32", "float32"), device="cpu", generator=0)
    mixer = {k: v[0].detach().clone().requires_grad_(True) for k, v in tm.tree["slots"]["s0"]["mixer"].items()}
    rng = np.random.default_rng(27)

    def nodes(t):
        seen, todo = set(), [t.grad_fn]
        while todo:
            f = todo.pop()
            if f is None or f in seen:
                continue
            seen.add(f)
            todo += [g for g, _ in f.next_functions]
        return {type(f).__name__ for f in seen}

    state = R.rglru_init_state(2, cfg.rglru)
    x1 = torch.from_numpy(rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32))
    K.LAUNCHES = K.BWD_LAUNCHES = 0
    y, _ = R.rglru_mixer(mixer, x1, cfg.rglru, state)
    assert "RGLRUScanBackward" not in nodes(y)
    grads = torch.autograd.grad(y.sum(), list(mixer.values()), allow_unused=True)
    assert all(g is not None for g in grads)
    x5 = torch.from_numpy(rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32))
    y, _ = R.rglru_mixer(mixer, x5, cfg.rglru)
    assert "RGLRUScanBackward" in nodes(y)
    assert K.LAUNCHES == K.BWD_LAUNCHES == 0


def test_rglru_scan_bwd_checks_its_inputs():
    """The wrapper refuses gradients of the wrong shape or dtype."""
    x, la, h0, dh, dl = (None if a is None else torch.from_numpy(a.astype(np.float32)) for a in _inputs(26, 2, 10, 4))
    h, _ = ref.rglru(x, la, h0)
    with pytest.raises(ValueError):
        K.rglru_scan_bwd(x, la, h0, h, dh[:, :5], dl)
    with pytest.raises(ValueError):
        K.rglru_scan_bwd(x, la, h0, h, dh.double(), dl)
    with pytest.raises(ValueError):
        K.rglru_scan_bwd(x, la, h0, h, dh, dl[:1])
    dx, dla, dh0 = K.rglru_scan_bwd(x, la, h0, h, dh, dl)
    assert dx.shape == dla.shape == x.shape and dh0.shape == h0.shape
