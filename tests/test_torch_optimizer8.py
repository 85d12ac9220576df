"""The port's 8-bit AdamW (``adamw8bit``) and its quantizers against the JAX
package, on the CPU (where the update runs its plain version).

Inputs from numpy seeds, handed to both. Tolerances:
- linear (absmax) codes and scales: equal, bit for bit (the same f32
  divisions, rounded half to even in both);
- log2 grid: codes at most 1 apart and equal on at least 99.9% of entries,
  ``lo`` within 1e-4 and ``step`` within 1e-5 relative (the two
  libraries' log2 differ in their last bits; a code near a rounding
  boundary may then fall the other way); values dequantized from the same
  codes within 4e-6 relative (the two exp2s) or 1e-22 at the 1e-16 floor;
- ``adamw8bit`` over three clipped updates: parameters within 1e-5
  relative (f32; one bf16 step for a bf16 leaf), the m codes within 1
  and the v codes within 1 of JAX's (the global norm sums squares per
  layer slice here and per leaf there, so the clip scale, and with it g,
  may differ in its last bit);
- the copd-mlp mirror: the reference's own 0.15 between AdamW's and the
  8-bit loss after 25 steps, and the port's 8-bit loss within 1e-4 of
  JAX's 8-bit loss.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import copd_mlp as jcopd
from repro.train import optimizer as J
from repro_torch import convert
from repro_torch.configs import copd_mlp
from repro_torch.kernels import adamw8bit as K
from repro_torch.kernels import ref as R
from repro_torch.train import adamw, adamw8bit, cosine_schedule
from repro_torch.train import optimizer as T

LOG_CODE_EQ = 0.999  # log codes equal on at least this share of entries
LO_TOL = 1e-4  # |lo - lo_jax|, absolute (lo near log2 of the block's smallest v)
STEP_RTOL = 1e-5
DEQ_LOG_RTOL = 4e-6  # the log grid's dequantized values (two exp2s)
DEQ_LOG_ATOL = 1e-22  # ... at the 1e-16 floor
P_RTOL = 1e-5  # adamw8bit's f32 parameters against JAX's after three updates


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's thread pool only contends with the other
    test workers, so each test here runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# yi-6b's trailing dims (128: wq/wk/wv, a half-empty block a row; 4096;
# 11008 = 43 blocks), a partial block (300), 1-d leaves
SHAPES = [(6, 128), (3, 300), (2, 3, 4, 128), (2, 4096), (1, 11008), (700,), (1,), (256,)]


def _m_like(rng, shape, scale=3.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _v_like(rng, shape, lo=-30.0):
    """Non-negative, spread over many octaves, with some exact zeros."""
    v = np.exp(rng.uniform(lo, 0.0, shape)).astype(np.float32)
    return np.where(rng.random(shape) < 0.05, np.float32(0), v)


def _assert_log_codes_close(got, want):
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d == 0).mean() >= LOG_CODE_EQ, (d == 0).mean()


def _assert_log_scales_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0, atol=LO_TOL)
    np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=STEP_RTOL)


# ------------------------------------------------------------------ quantizers
@pytest.mark.parametrize("shape", SHAPES)
def test_linear_quantizer_matches_jax_bit_for_bit(shape):
    x = _m_like(np.random.default_rng(len(shape) * 100 + shape[-1]), shape)
    jc, js = J._quantize(jnp.asarray(x))
    tc, ts = R.quantize(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and tuple(tc.shape) == shape and tc.is_contiguous()
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # and the dequantized values from the same codes
    np.testing.assert_array_equal(R.dequantize(tc, ts).numpy(), np.asarray(J._dequantize(jc, js)))


@pytest.mark.parametrize("shape", SHAPES)
def test_log_quantizer_matches_jax(shape):
    v = _v_like(np.random.default_rng(len(shape) * 100 + shape[-1] + 1), shape)
    jc, js = J._quantize_log(jnp.asarray(v))
    tc, ts = R.quantize_log(torch.from_numpy(v))
    assert tc.dtype == torch.int8 and tuple(tc.shape) == shape
    _assert_log_codes_close(tc.numpy(), jc)
    _assert_log_scales_close(ts.numpy(), js)
    # the port's dequantization of JAX's codes and scales, through each
    # library's exp2 of arguments down to log2(1e-16) = -53: an exp2 that
    # goes through exp(x ln 2) carries x's rounding (53 x 6e-8) into its
    # result, so DEQ_LOG_RTOL; a value at the floor is exp2(lo) - 1e-16,
    # which cancels to a few ulp of 1e-16 (1.3e-23 each), so DEQ_LOG_ATOL
    want = np.asarray(J._dequantize_log(jc, js))
    got = R.dequantize_log(torch.from_numpy(np.asarray(jc).copy()), torch.from_numpy(np.asarray(js).copy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=DEQ_LOG_RTOL, atol=DEQ_LOG_ATOL)


def test_partial_block_sets_lo_to_the_floor():
    """Zero padding enters log2(x + 1e-16): every partial block's lo is
    log2(1e-16), in both packages (yi-6b's 128-wide rows are such blocks)."""
    v = np.full((3, 128), 0.5, np.float32)
    _, js = J._quantize_log(jnp.asarray(v))
    _, ts = R.quantize_log(torch.from_numpy(v))
    floor = float(np.log2(np.float32(1e-16)))
    np.testing.assert_allclose(ts[..., 0].numpy(), floor, atol=LO_TOL)
    np.testing.assert_allclose(np.asarray(js)[..., 0], floor, atol=LO_TOL)


def _linear_round_trip(shape, scale, seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * np.float32(scale))
    codes, scales = R.quantize(x)
    assert codes.shape == x.shape and codes.dtype == torch.int8
    xr = R.dequantize(codes, scales)
    bound = float(x.abs().max()) / 127 + 1e-9  # absmax linear: blockmax / 127 per block
    assert float((x - xr).abs().max()) <= bound * 1.01


def _log_relative_error(n, lo, seed):
    v = torch.from_numpy(np.exp(np.random.default_rng(seed).uniform(lo, 0.0, (3, n))).astype(np.float32))
    codes, scales = R.quantize_log(v)
    vr = R.dequantize_log(codes, scales)
    assert float(((v - vr).abs() / (v + 1e-20)).max()) < 0.12  # log grid: uniform relative error


@settings(max_examples=30, deadline=None)
@given(
    shape=st.lists(st.integers(1, 9), min_size=1, max_size=3).map(tuple),
    scale=st.floats(1e-4, 1e4),
    seed=st.integers(0, 2**16),
)
def test_property_linear_quant_roundtrip(shape, scale, seed):
    """Mirror of tests/test_optimizer.py:29."""
    _linear_round_trip(shape, scale, seed)


@pytest.mark.parametrize("shape,scale,seed", [
    ((1,), 1e-4, 0), ((9,), 1.0, 1), ((3, 7), 1e4, 2), ((2, 5, 9), 37.5, 3), ((4, 300), 0.01, 4),
    ((2, 3, 4, 128), 2.5, 5),
])
def test_linear_quant_roundtrip(shape, scale, seed):
    """tests/test_optimizer.py:29 at fixed examples (runs without hypothesis)."""
    _linear_round_trip(shape, scale, seed)


@settings(max_examples=30, deadline=None)
@given(n=st.integers(1, 2000), lo=st.floats(-30, -1), seed=st.integers(0, 2**16))
def test_property_log_quant_relative_error(n, lo, seed):
    """Mirror of tests/test_optimizer.py:45."""
    _log_relative_error(n, lo, seed)


@pytest.mark.parametrize("n,lo,seed", [(1, -1.0, 0), (255, -30.0, 1), (256, -12.5, 2), (300, -30.0, 3),
                                       (2000, -5.0, 4), (1337, -29.0, 5)])
def test_log_quant_relative_error(n, lo, seed):
    """tests/test_optimizer.py:45 at fixed examples (runs without hypothesis)."""
    _log_relative_error(n, lo, seed)


def test_quant_zero_block_exact():
    """Mirror of tests/test_optimizer.py:53."""
    x = torch.zeros((4, 300))
    c, s = R.quantize(x)
    assert torch.equal(R.dequantize(c, s), torch.zeros_like(x))
    c2, s2 = R.quantize_log(x)
    assert float(R.dequantize_log(c2, s2).abs().max()) < 1e-10


# ------------------------------------------------------------------- adamw8bit
def _tree(rng):
    """A stacked f32 leaf with a partial block, a bf16 leaf of trailing dim
    128, a 1-d leaf; in both packages."""
    w = rng.standard_normal((3, 4, 300)).astype(np.float32)
    b = rng.standard_normal((5, 128)).astype(ml_dtypes.bfloat16)
    c = rng.standard_normal(77).astype(np.float32)
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b), "c": jnp.asarray(c)}
    tp = {"w": torch.from_numpy(w.copy()), "b": torch.from_numpy(b.astype(np.float32)).to(torch.bfloat16),
          "c": torch.from_numpy(c.copy())}
    return jp, tp


def _grads(rng, jp):
    g = {k: rng.standard_normal(v.shape).astype(np.float32) * 3 for k, v in jp.items()}
    jg = {k: jnp.asarray(v).astype(jp[k].dtype) for k, v in g.items()}
    tg = {k: torch.from_numpy(v).to(torch.bfloat16 if k == "b" else torch.float32) for k, v in g.items()}
    return jg, tg


def _assert_state_close(ts, js):
    for k in ("m", "v"):
        for leaf in js[k]:
            tc, jc = ts[k][leaf]["codes"].numpy(), np.asarray(js[k][leaf]["codes"])
            assert tc.dtype == jc.dtype == np.int8 and tc.shape == jc.shape
            assert np.abs(tc.astype(np.int32) - jc.astype(np.int32)).max() <= 1, (k, leaf)
            s, js_ = ts[k][leaf]["scales"].numpy(), np.asarray(js[k][leaf]["scales"])
            assert s.shape == js_.shape and s.dtype == js_.dtype == np.float32
            if k == "m":
                np.testing.assert_allclose(s, js_, rtol=P_RTOL)
            else:
                _assert_log_scales_close(s, js_)


def test_init_is_jax_layout():
    """``init`` gives JAX's tree: m codes 0 and scales 0, v codes -127 and
    each block (log2(1e-16), 1e-8), of the same shapes and dtypes."""
    jp, tp = _tree(np.random.default_rng(4))
    js, ts = J.adamw8bit(1e-3).init(jp), adamw8bit(1e-3).init(tp)
    assert int(ts["step"]) == 0 and ts["step"].dtype == torch.int32
    for leaf in jp:
        np.testing.assert_array_equal(ts["m"][leaf]["codes"].numpy(), np.asarray(js["m"][leaf]["codes"]))
        np.testing.assert_array_equal(ts["m"][leaf]["scales"].numpy(), np.asarray(js["m"][leaf]["scales"]))
        np.testing.assert_array_equal(ts["v"][leaf]["codes"].numpy(), np.asarray(js["v"][leaf]["codes"]))
        _assert_log_scales_close(ts["v"][leaf]["scales"].numpy(), js["v"][leaf]["scales"])


def test_adamw8bit_matches_jax_over_three_updates():
    """Three clipped updates of a warm-up + cosine schedule, against JAX's
    adamw8bit; in place, and no kernel launched on the CPU."""
    rng = np.random.default_rng(5)
    jp, tp = _tree(rng)
    storage = {k: v.data_ptr() for k, v in tp.items()}
    jo, to = J.adamw8bit(J.cosine_schedule(1e-2, 1, 5)), adamw8bit(cosine_schedule(1e-2, 1, 5))
    js, ts = jo.init(jp), to.init(tp)
    launches = K.LAUNCHES
    for _ in range(3):
        jg, tg = _grads(rng, jp)
        jp, js = jo.update(jg, js, jp)
        out, ts = to.update(tg, ts, tp)
        assert out is tp
    assert K.LAUNCHES == launches
    assert {k: v.data_ptr() for k, v in tp.items()} == storage
    assert int(ts["step"]) == int(js["step"]) == 3
    for leaf in ("w", "c"):
        np.testing.assert_allclose(tp[leaf].numpy(), np.asarray(jp[leaf]), rtol=P_RTOL, atol=1e-7)
    np.testing.assert_allclose(tp["b"].float().numpy(), np.asarray(jp["b"]).astype(np.float32), rtol=2**-8)
    _assert_state_close(ts, js)


def test_adamw8bit_with_an_active_clip_matches_jax_over_three_updates():
    """Gradients whose global norm is far above ``max_grad_norm`` (the clip
    scale below 1 at every update), against JAX's adamw8bit with the same
    clip over three updates, with the tolerances of the test above; the
    port leaves the gradients as they were."""
    rng = np.random.default_rng(15)
    jp, tp = _tree(rng)
    jo = J.adamw8bit(J.cosine_schedule(1e-2, 1, 5), max_grad_norm=0.5)
    to = adamw8bit(cosine_schedule(1e-2, 1, 5), max_grad_norm=0.5)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(3):
        jg, tg = _grads(rng, jp)
        jg = {k: (v * 10).astype(v.dtype) for k, v in jg.items()}
        tg = {k: (v * 10).to(v.dtype) for k, v in tg.items()}
        _, scale = R.global_norm(T.tree_leaves(tg), 0.5)
        assert float(scale) < 1e-2
        before = {k: v.clone() for k, v in tg.items()}
        jp, js = jo.update(jg, js, jp)
        to.update(tg, ts, tp)
        assert all(torch.equal(tg[k], before[k]) for k in tg)
    for leaf in ("w", "c"):
        np.testing.assert_allclose(tp[leaf].numpy(), np.asarray(jp[leaf]), rtol=P_RTOL, atol=1e-7)
    np.testing.assert_allclose(tp["b"].float().numpy(), np.asarray(jp["b"]).astype(np.float32), rtol=2**-8)
    _assert_state_close(ts, js)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("max_norm", [1e9, 1.0], ids=["scale-1", "scale-below-1"])
@pytest.mark.parametrize("n", [128, 300, 4096])
def test_plain_update_with_clip_scale_matches_clip_then_update(dtype, max_norm, n):
    """``ref.adamw8bit_update`` with ``clip_scale`` (the plain norm's scale)
    against ``clip_by_global_norm`` followed by the plain update without
    it: equal to the bit, over 3 updates; g is not written back."""
    rng = np.random.default_rng(n + (max_norm == 1.0))
    shape = (3, n)
    p0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.02).to(dtype)
    st0 = adamw8bit(1e-3).init({"p": p0})
    state = [st0["m"]["p"]["codes"], st0["m"]["p"]["scales"], st0["v"]["p"]["codes"], st0["v"]["p"]["scales"]]
    a = [p0.clone(), *(t.clone() for t in state)]
    b = [p0.clone(), *(t.clone() for t in state)]
    for step in range(1, 4):
        g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
        stepf = torch.tensor(step, dtype=torch.float32)
        kw = dict(lr=torch.tensor(1e-2), bc1=1 - torch.tensor(0.9) ** stepf, bc2=1 - torch.tensor(0.95) ** stepf,
                  b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01)
        norm, scale = R.global_norm([g], max_norm)
        assert (float(scale) < 1) == (max_norm == 1.0)
        g_before = g.clone()
        R.adamw8bit_update(a[0], g, *a[1:], **kw, clip_scale=scale)
        assert torch.equal(g, g_before)
        clipped, norm_c = T.clip_by_global_norm({"g": g.clone()}, max_norm)
        assert torch.equal(norm, norm_c)
        R.adamw8bit_update(b[0], clipped["g"], *b[1:], **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("dtypes", [("f32", "f32", "f32"), ("bf16", "f32", "bf16")])
def test_plain_norm_matches_jax(dtypes):
    """``ref.global_norm`` (the norm kernel's plain version) against the
    norm and scale of JAX's clip_by_global_norm, on a stacked leaf, a
    partial block and a 1-d leaf: rtol 1e-6 (f32 sums in another order:
    a layer slice at a time here, a leaf at a time there)."""
    rng = np.random.default_rng(16)
    shapes = {"w": (3, 4, 300), "b": (5, 128), "c": (77,)}
    leaves = {k: rng.standard_normal(s).astype(np.float32) * 2 for k, s in shapes.items()}
    npdt = {"f32": np.float32, "bf16": ml_dtypes.bfloat16}
    jg = {k: jnp.asarray(v.astype(npdt[d])) for (k, v), d in zip(sorted(leaves.items()), dtypes)}
    tg = [torch.from_numpy(np.asarray(jg[k]).astype(np.float32)).to(
        torch.bfloat16 if d == "bf16" else torch.float32) for k, d in zip(sorted(leaves), dtypes)]
    for max_norm in (1.0, 1e6):
        clipped, jnorm = J.clip_by_global_norm(jg, max_norm)
        norm, scale = R.global_norm(tg, max_norm)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        jscale = float(np.minimum(1.0, np.float32(max_norm) / (np.float32(jnorm) + np.float32(1e-9))))
        np.testing.assert_allclose(float(scale), jscale, rtol=1e-6)


def test_update_plain_slices_like_whole_leaves():
    """The plain version walks a stacked leaf by layer slice: the same bits
    as one whole-leaf pass, since blocks cut only the trailing dim."""
    rng = np.random.default_rng(9)
    p = torch.from_numpy(rng.standard_normal((3, 2, 300)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((3, 2, 300)).astype(np.float32))
    mc, ms = R.quantize(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)) * 0.1)
    vc, vs = R.quantize_log(torch.from_numpy(rng.random(p.shape).astype(np.float32)) * 0.01)
    kw = dict(lr=torch.tensor(1e-2), bc1=torch.tensor(0.19), bc2=torch.tensor(0.0975), b1=0.9, b2=0.95, eps=1e-8,
              weight_decay=0.01)
    a = [t.clone() for t in (p, g, mc, ms, vc, vs)]
    R.adamw8bit_update(*a, **kw)
    flat = [t.clone().reshape((6,) + tuple(t.shape[2:])) for t in (p, g, mc, ms, vc, vs)]
    R.adamw8bit_update(*flat, **kw)  # 2-d: one pass
    for x, y in zip(a, flat):
        assert torch.equal(x.reshape(y.shape), y)


def test_check_refuses_what_the_kernel_does_not_take():
    p = torch.zeros((2, 300))
    state = adamw8bit(1e-3).init({"p": p})
    m, v = state["m"]["p"], state["v"]["p"]
    ok = (p, torch.zeros_like(p), m["codes"], m["scales"], v["codes"], v["scales"])
    K.check(*ok)
    with pytest.raises(TypeError):  # g of another dtype
        K.check(p, torch.zeros_like(p, dtype=torch.bfloat16), *ok[2:])
    with pytest.raises(ValueError):  # scales of another block count
        K.check(*ok[:3], torch.zeros((2, 1)), *ok[4:])
    with pytest.raises(TypeError):  # f32 codes
        K.check(*ok[:2], m["codes"].float(), *ok[3:])
    with pytest.raises(ValueError):  # a leaf on another device than its state
        K.check(*ok[:4], v["codes"].to("meta"), v["scales"])


def test_tree_leaves_stops_at_quantized_moments():
    tree = {"a": {"codes": torch.zeros(2), "scales": torch.zeros(1)}, "b": {"c": {"codes": 1, "scales": 2}}}
    assert len(T.tree_leaves(tree)) == 4
    leaves = T.tree_leaves(tree, T.is_quantized)
    assert len(leaves) == 2 and all(T.is_quantized(x) for x in leaves)


def test_adamw8bit_tracks_adamw():
    """Mirror of tests/test_optimizer.py:62 on the port's copd-mlp (25 full
    batch steps from the same moved weights), and the 8-bit loss against
    JAX's 8-bit loss."""
    jp0 = jcopd.init(jax.random.PRNGKey(0))
    batch = copd_mlp.synth_dataset(n=64)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = {}
    for name, topt in (("adamw", adamw(1e-2)), ("adamw8bit", adamw8bit(1e-2))):
        p = {k: v.requires_grad_(True) for k, v in convert.params_from_jax(jax.tree.map(np.asarray, jp0)).items()}
        state = topt.init(p)
        for _ in range(25):
            loss, _ = copd_mlp.loss_fn(p, tbatch)
            g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            topt.update(g, state, p)
        with torch.no_grad():
            losses[name] = float(copd_mlp.loss_fn(p, tbatch)[0])
        if name == "adamw8bit":
            assert all(x["codes"].dtype == torch.int8 for x in T.tree_leaves(state["m"], T.is_quantized))
    assert abs(losses["adamw"] - losses["adamw8bit"]) < 0.15, losses
    jo = J.adamw8bit(1e-2)
    jp, js = jp0, jo.init(jp0)
    for _ in range(25):
        g = jax.grad(lambda q: jcopd.loss_fn(q, jbatch)[0])(jp)
        jp, js = jo.update(g, js, jp)
    assert losses["adamw8bit"] == pytest.approx(float(jcopd.loss_fn(jp, jbatch)[0]), rel=1e-4)


# -------------------------------------------------------------- moving states
def test_8bit_state_moves_from_jax_and_back():
    """A JAX adamw8bit state moved through convert continues as JAX's does
    (two more updates), and comes back through opt_state_to_numpy."""
    rng = np.random.default_rng(6)
    jp, _ = _tree(rng)
    jo, to = J.adamw8bit(1e-2), adamw8bit(1e-2)
    js = jo.init(jp)
    jg, _ = _grads(rng, jp)
    jp, js = jo.update(jg, js, jp)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    ts = convert.opt_state_from_jax(jax.tree.map(np.asarray, js))
    assert ts["m"]["w"]["codes"].dtype == torch.int8 and ts["v"]["b"]["scales"].dtype == torch.float32
    for _ in range(2):
        jg, tg = _grads(rng, jp)
        jp, js = jo.update(jg, js, jp)
        tp, ts = to.update(tg, ts, tp)
    back = convert.opt_state_to_numpy(ts)
    assert back["step"] == np.asarray(js["step"]) == 3
    assert back["m"]["w"]["codes"].dtype == np.int8 and back["v"]["w"]["scales"].shape == js["v"]["w"]["scales"].shape
    _assert_state_close(convert.opt_state_from_jax(back), js)
    for leaf in ("w", "c"):
        np.testing.assert_allclose(tp[leaf].numpy(), np.asarray(jp[leaf]), rtol=P_RTOL, atol=1e-7)


@pytest.mark.parametrize("bad", ["int8 scales", "f32 codes", "mixed", "bf16 moment", "extra key"])
def test_convert_refuses_states_of_neither_kind(bad):
    jp, _ = _tree(np.random.default_rng(7))
    state = jax.tree.map(np.asarray, J.adamw8bit(1e-2).init(jp))
    if bad == "int8 scales":
        state["m"]["w"]["scales"] = state["m"]["w"]["scales"].astype(np.int8)
    elif bad == "f32 codes":
        state["v"]["c"]["codes"] = state["v"]["c"]["codes"].astype(np.float32)
    elif bad == "mixed":  # one leaf an f32 moment, the others quantized
        state["m"]["c"] = np.zeros(77, np.float32)
    elif bad == "bf16 moment":  # an AdamW state whose moments are not f32
        state = jax.tree.map(np.asarray, J.adamw(1e-2).init(jp))
        state["v"]["w"] = state["v"]["w"].astype(ml_dtypes.bfloat16)
    else:
        state["m"]["w"]["extra"] = np.zeros(1, np.float32)
    with pytest.raises((TypeError, KeyError)):
        convert.opt_state_from_jax(state)
    if bad != "bf16 moment":
        with pytest.raises((TypeError, KeyError)):
            convert.opt_state_to_numpy(convert.params_from_jax(state))
