"""K3's arithmetic, in the CUDA kernel's order, on the CPU.

``csrc/rglru_scan.cu`` cannot run here, so ``_kernel_model`` repeats what
it computes, in f32 and in its order: time blocks of ``warps * steps``
steps, each warp's ``steps`` composed from the identity with every prefix
kept (P = the product of a, Q = the scan of h = a h + b from 0), the
warps' maps folded into the running state in time order, and h = Q + P
carry_in; steps past S are identity maps (log a = 0, x = 0). a is
2^(log a * log2 e) with the product rounded to f32, as the kernel's
FAST_EXP computes it (its ex2.approx and the weight's sqrt.approx round
within 2 ulp and 1 ulp of the exact f32 functions the model uses). It is held
to the float64 run of the plain version (``ref.rglru``) at
tests/test_kernels.py:86's 1e-5 with that file's decays, at 1e-4 with the
model's decays over S 3000 (the tolerances chip_smoke.py holds the
kernel to on the card), and to the JAX ``rglru_op`` (its Pallas kernel in
interpret mode) at tests/test_torch_rglru.py's 1e-5. The kernel itself is
held on the card by tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import rglru_op as jax_rglru_op
from repro_torch.kernels import ref

TOL = 1e-5  # tests/test_kernels.py:86
F64_TOL = 1e-4  # chip_smoke.RGLRU_F64_TOL: the model's decays over thousands of steps
WARPS, STEPS = 16, 16  # the kernel's constants (csrc/rglru_scan.cu)
LOG2E = 1.4426950408889634


def _kernel_model(x, log_a, h0=None, warps=WARPS, steps=STEPS):
    """csrc/rglru_scan.cu in f32 torch ops; returns (h, h_last)."""
    b, s, c = x.shape
    t_block = warps * steps
    state = torch.zeros((b, c)) if h0 is None else h0.clone()
    h = torch.empty((b, s, c))
    for t0 in range(0, s, t_block):
        n = min(t_block, s - t0)
        la = torch.zeros((b, t_block, c))
        xx = torch.zeros((b, t_block, c))
        la[:, :n], xx[:, :n] = log_a[:, t0 : t0 + n], x[:, t0 : t0 + n]
        la, xx = la.view(b, warps, steps, c), xx.view(b, warps, steps, c)
        a = torch.exp2(la * LOG2E)  # FAST_EXP
        bt = torch.sqrt(torch.clamp(-torch.expm1(2 * la), min=0.0)) * xx
        # 1. each warp's steps from the identity, every prefix kept
        p, q = torch.empty_like(a), torch.empty_like(a)
        prod, acc = torch.ones((b, warps, c)), torch.zeros((b, warps, c))
        for u in range(steps):
            acc = a[:, :, u] * acc + bt[:, :, u]
            prod = prod * a[:, :, u]
            p[:, :, u], q[:, :, u] = prod, acc
        # 2. the warps' maps folded into the running state, in time order
        carry = torch.empty((b, warps, c))
        for w in range(warps):
            carry[:, w] = state
            state = prod[:, w] * state + acc[:, w]
        # 3. h = Q + P carry_in
        out = q + p * carry[:, :, None]
        h[:, t0 : t0 + n] = out.reshape(b, t_block, c)[:, :n]
    return h, state


def _inputs(seed, b, s, c, model_decays=False, h0=True):
    """x, log_a (tests/test_kernels.py:81's -|N| * 0.3, or the model's
    log(u) r / 2 with u ~ U(0.81, 0.998) a channel and r a sigmoid gate),
    and h0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    if model_decays:
        u = rng.uniform(0.81, 0.998, c)
        r = 1 / (1 + np.exp(-rng.standard_normal((b, s, c))))
        log_a = (np.log(u) * r / 2).astype(np.float32)
    else:
        log_a = (-np.abs(rng.standard_normal((b, s, c))) * 0.3).astype(np.float32)
    h0 = rng.standard_normal((b, c)).astype(np.float32) if h0 else None
    return x, log_a, h0


def _torch(*arrays):
    return tuple(None if a is None else torch.from_numpy(a) for a in arrays)


def _hold_to_float64(x, log_a, h0, tol, **tiles):
    h, hl = _kernel_model(x, log_a, h0, **tiles)
    assert h.dtype == hl.dtype == torch.float32
    want, want_last = ref.rglru(x.double(), log_a.double(), None if h0 is None else h0.double())
    torch.testing.assert_close(h.double(), want, atol=tol, rtol=tol)
    torch.testing.assert_close(hl.double(), want_last, atol=tol, rtol=tol)


@pytest.mark.parametrize("b,s,c", [(1, 128, 64), (2, 256, 128), (3, 64, 256)])
@pytest.mark.parametrize("warps,steps", [(WARPS, STEPS), (8, 16), (16, 8), (4, 3)])
def test_kernel_model_matches_float64_at_test_kernels_shapes(b, s, c, warps, steps):
    """tests/test_kernels.py:77-87's shapes and decays, with h0, under the
    kernel's tiles and others (time blocks of 256, 128, 128 and 12)."""
    _hold_to_float64(*_torch(*_inputs(s + c, b, s, c)), TOL, warps=warps, steps=steps)


@pytest.mark.parametrize("s", [1, 15, 17, 255, 257, 845])
@pytest.mark.parametrize("h0", [True, False])
def test_kernel_model_ragged_sequence(s, h0):
    """S at the edges of a warp's steps and of the time block, and past
    three time blocks: the padded steps are identity maps and h_last is
    the state after step S - 1."""
    _hold_to_float64(*_torch(*_inputs(s, 2, s, 24, h0=h0)), TOL)


def test_kernel_model_model_decays_long_sequence():
    """The model's decays (a up to about 0.9995) over S 3000 at a narrow C,
    a random h0, against float64 at the path's 1e-4."""
    _hold_to_float64(*_torch(*_inputs(7, 1, 3000, 32, model_decays=True)), F64_TOL)


@pytest.mark.parametrize("b,s,c,t", [(1, 128, 64, 32), (2, 256, 128, 64), (3, 64, 256, 64), (1, 512, 32, 256)])
def test_kernel_model_matches_jax_rglru_op(b, s, c, t):
    """Against the JAX ``rglru_op`` (interpret mode; its time block ``t``
    divides S), with h0, at tests/test_torch_rglru.py's 1e-5, on the
    inputs that file's test_rglru_op_matches_jax_rglru_op draws. The JAX
    kernel's own error is the larger one: its f32 1 - exp(2 log a)
    cancels for small |log a|, 0.95 of the tolerance off float64 at the
    first shape (1.32 with seed 448), where this model is 0.03 off."""
    x, log_a, h0 = _inputs(s + c, b, s, c)
    hj, lj = jax_rglru_op(jnp.asarray(x), jnp.asarray(log_a), jnp.asarray(h0), t_block=t)
    h, hl = _kernel_model(*_torch(x, log_a, h0))
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(hl.numpy(), np.asarray(lj), atol=TOL, rtol=TOL)


def test_kernel_model_time_block_invariance():
    """The same input under two time blocks (256 and 12 steps) within 1e-5:
    the tiles change only the order of roundings."""
    x, log_a, h0 = _torch(*_inputs(11, 2, 700, 40, model_decays=True))
    h1, l1 = _kernel_model(x, log_a, h0)
    h2, l2 = _kernel_model(x, log_a, h0, warps=4, steps=3)
    torch.testing.assert_close(h1, h2, atol=TOL, rtol=TOL)
    torch.testing.assert_close(l1, l2, atol=TOL, rtol=TOL)
