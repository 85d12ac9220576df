"""whisper-tiny's pieces in the port against the JAX package's, on the CPU.

Reduced whisper-tiny (d 64, 2/2 heads of head dim 32, 2 encoder and 2
decoder layers, 24 frames, vocab 256) in f32 on JAX's weights, moved
through ``convert.params_from_jax``; inputs from numpy seeds, the frames
drawn standard normal as JAX's ``make_batch`` draws them. Tolerances:
the sinusoid to the bit, ``layer_norm`` at 1e-6 (its sums over d in
another order than XLA's); layers at 1e-5; logits,
prefill and decode at 1e-4 (f32, sums in another order). K1 and its
backward at queries and keys of different lengths (the cross attention's
Sq over Sk) against JAX's ``_chunked_attention`` with a ``cross``
``AttnParams``, at the f32 kernel tolerance 2e-5 of each output's largest
element. The kernels themselves are held on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import layers as JL
from repro.models import model as JMOD
from repro.models.model import StreamModel as JModel
from repro.models.policy import Policy as JPolicy
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ops import attention_op
from repro_torch.models import layers as TL
from repro_torch.models import model as TMOD
from repro_torch.models.model import StreamModel
from repro_torch.models.policy import Policy

WH = "whisper-tiny"
ATOL = 1e-5
LOGIT_TOL = 1e-4
KERNEL_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These models are tiny: torch's thread pool only contends with the
    other test workers, so each test here runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _whisper():
    """JAX's reduced whisper with its layer norms' weights and biases moved
    off 1 and 0 (so that both are pinned), and the port's on those weights."""
    cfg = JC.get_reduced(WH)
    jm = JModel(cfg, JPolicy(param_dtype="float32", compute_dtype="float32"))
    rng = np.random.default_rng(5)

    def move(path, leaf):
        names = {getattr(k, "key", None) for k in path}
        if names & {"norm1", "norm2", "norm_x", "final_norm"}:
            return leaf + 0.1 * rng.standard_normal(leaf.shape).astype(np.float32)
        return leaf

    jp = jax.tree_util.tree_map_with_path(move, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))))
    jp = jax.tree.map(jnp.asarray, jp)
    tm = StreamModel(TC.get_reduced(WH), Policy("float32", "float32", "float32"), device="cpu", generator=None)
    tm.load_params(convert.params_from_jax(jax.tree.map(np.asarray, jp)))
    return cfg, jm, jp, tm


def _batch(cfg, seed, b=2, s=16):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            rng.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(np.float32))


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=atol)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


# ------------------------------------------------------------------ layers
def test_layer_norm_matches_jax():
    """The mean and the population variance in f32: within 1e-6, a few
    ulps (both sums over d run in another order than XLA's; no order tried
    gives XLA's bits)."""
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((2, 7, 64)) + 1).astype(np.float32)
    w, b = rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    got = TL.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    want = np.asarray(JL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s,d", [(24, 64), (1500, 384)])
def test_sinusoid_matches_jax_bits(s, d):
    got = TMOD._sinusoid(s, d, torch.float32, "cpu")
    want = np.asarray(JMOD._sinusoid(s, d, jnp.float32))[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_cross_attention_matches_jax():
    """``attention`` with ``kv_source``: queries from x, keys and values
    from the encoder's states, no RoPE, no mask; its K/V too."""
    cfg, _, jp, _ = _whisper()
    p = _layer0(jp["slots"]["s0"]["cross"])
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    ap = cfg.attn_params("cross")
    yj, kj, vj = JL.attention(p, jnp.asarray(x), ap, JPolicy(param_dtype="float32", compute_dtype="float32"),
                              kv_source=jnp.asarray(enc), return_kv=True)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, p))
    yt, kt, vt = TL.attention(tp, torch.from_numpy(x), TC.get_reduced(WH).attn_params("cross"), return_kv=True,
                              kv_source=torch.from_numpy(enc))
    _close(yt, yj)
    _close(kt, kj)
    _close(vt, vj)


@pytest.mark.parametrize("per_row", [False, True])
def test_cross_decode_attention_matches_jax(per_row):
    """One token over the cached encoder projections: no write, no mask,
    the caches come back unchanged."""
    cfg, _, jp, _ = _whisper()
    p = _layer0(jp["slots"]["s0"]["cross"])
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((2, cfg.enc_seq, cfg.n_kv_heads, cfg.hd)).astype(np.float32) for _ in "kv")
    pos = np.array([3, 7], np.int32) if per_row else np.int32(5)
    yj, _, _ = JL.decode_attention(p, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos),
                                   cfg.attn_params("cross"), JPolicy(param_dtype="float32", compute_dtype="float32"))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, p))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    yt, k2, v2 = TL.decode_attention(tp, torch.from_numpy(x), tk, tv, torch.from_numpy(np.asarray(pos)),
                                     TC.get_reduced(WH).attn_params("cross"))
    _close(yt, yj)
    assert k2 is tk and torch.equal(tk, torch.from_numpy(ck)) and torch.equal(tv, torch.from_numpy(cv))


# ----------------------------------------- K1 at queries and keys of two lengths
CROSS = [(sq, sk, rep) for sq in (5, 129, 300) for sk in (200, 129) for rep in (1, 2)]


def _cross_inputs(seed, sq, sk, rep, d=64, kv=2, b=2):
    rng = np.random.default_rng(seed)
    h = kv * rep
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d), (b, sq, h, d))]


def _jax_cross(arrays):
    """JAX's cross attention of (B, S, heads, D) arrays and its vjp at the
    last one: ``_chunked_attention`` with a ``cross`` AttnParams."""
    q, k, v, do = (jnp.asarray(a) for a in arrays)
    ap = JL.AttnParams(n_heads=q.shape[2], n_kv=k.shape[2], head_dim=q.shape[3], use_rope=False, cross=True)
    fn = lambda q_, k_, v_: JL._chunked_attention(  # noqa: E731
        q_, k_, v_, jnp.arange(q.shape[1]), jnp.arange(k.shape[1]), ap, grouped=False)
    out, vjp = jax.vjp(fn, q, k, v)
    return np.asarray(out), [np.asarray(g) for g in vjp(do)]


def _rel(got, want):
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("sq,sk,rep", CROSS)
def test_attention_op_cross_lengths_match_jax(sq, sk, rep):
    """``attention_op`` on (B, Sq, H, D) queries over (B, Sk, Kv, D) keys,
    no mask: JAX's cross attention."""
    arrays = _cross_inputs(sq * 7 + sk + rep, sq, sk, rep)
    want, _ = _jax_cross(arrays)
    before = fa.LAUNCHES
    got = attention_op(*(torch.from_numpy(a) for a in arrays[:3]), causal=False)
    assert got.shape == want.shape and fa.LAUNCHES == before
    assert _rel(got.numpy(), want) <= KERNEL_TOL


@pytest.mark.parametrize("sq,sk,rep", CROSS)
def test_flash_attention_bwd_cross_lengths_match_jax(sq, sk, rep):
    """The backward's CPU side at Sq != Sk: dq (B, H, Sq, D), dk and dv (B,
    Kv, Sk, D) summed over each kv group, against jax.vjp of JAX's cross
    attention; the forward's lse runs over Sq."""
    arrays = _cross_inputs(sq * 11 + sk + rep, sq, sk, rep)
    _, want = _jax_cross(arrays)
    q, k, v, do = (torch.from_numpy(a).transpose(1, 2) for a in arrays)
    out, lse = fa.flash_attention(q, k, v, causal=False, return_lse=True)
    assert lse.shape == q.shape[:3]
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=False)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.shape == t.shape
        assert _rel(g.transpose(1, 2).numpy(), w) <= KERNEL_TOL


def test_attention_op_cross_gradient_through_the_function():
    """Under grad mode the cross call goes through ``FlashAttention``; its
    gradients equal jax.grad's."""
    arrays = _cross_inputs(3, 37, 150, 2)
    _, want = _jax_cross(arrays)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays[:3])
    got = torch.autograd.grad(attention_op(q, k, v, causal=False), (q, k, v), torch.from_numpy(arrays[3]))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= KERNEL_TOL


@pytest.mark.parametrize("kw", [{"causal": True}, {"causal": False, "window": 16}])
def test_cross_lengths_refuse_a_mask(kw):
    """Queries and keys of different lengths take a causal mask or a window
    only where the queries lie within the keys (a context-parallel rank's
    block, q_offset + Sq <= Sk): more queries than keys under a mask raise
    on either side."""
    q, k, v, do = (torch.from_numpy(a).transpose(1, 2) for a in _cross_inputs(4, 30, 20, 1))
    with pytest.raises(ValueError, match="different lengths"):
        fa.flash_attention(q, k, v, **kw)
    lse = torch.zeros(q.shape[:3])
    with pytest.raises(ValueError, match="different lengths"):
        fa.flash_attention_bwd(q, k, v, q, do, lse, **kw)


# ------------------------------------------------------------ the model
def test_param_tree_matches_jax():
    """Key for key and shape for shape, the encoder's stack, the layer
    norms' ``{"w", "b"}`` and ``pos_embed`` among them; JAX's tree loads
    through ``convert.params_from_jax`` (the fixture) and comes back out."""
    cfg, _, jp, tm = _whisper()
    flat = lambda t: {jax.tree_util.keystr(p): tuple(x.shape) for p, x in jax.tree_util.tree_leaves_with_path(t)}  # noqa: E731
    assert flat(tm.param_tree()) == flat(jp)
    assert tuple(tm.param_tree()["pos_embed"].shape) == (cfg.max_learned_pos, cfg.d_model)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tm.param_tree())):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_seeded_init_follows_jax_scales():
    """Layer norms ones and zeros, the learned positions at 0.02, the
    encoder's and the cross attention's weights at 1 / sqrt(d)."""
    m = StreamModel(TC.get_reduced(WH), Policy("float32", "float32", "float32"), device="cpu", generator=3)
    t = m.param_tree()
    enc = t["encoder"]
    for part in (t["final_norm"], enc["final_norm"], enc["slots"]["s0"]["norm1"], t["slots"]["s0"]["norm_x"]):
        assert torch.equal(part["w"], torch.ones_like(part["w"])) and torch.equal(part["b"], torch.zeros_like(part["b"]))
    assert abs(float(t["pos_embed"].std()) - 0.02) < 0.002
    for w in (enc["slots"]["s0"]["mixer"]["wq"], t["slots"]["s0"]["cross"]["wk"]):
        assert abs(float(w.std()) * 8.0 - 1.0) < 0.05  # d 64


def test_logits_match_jax():
    cfg, jm, jp, tm = _whisper()
    toks, frames = _batch(cfg, 11)
    lj, _ = jm.forward(jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    lt = tm(torch.from_numpy(toks), frames=torch.from_numpy(frames))
    assert lt.shape == (2, 16, cfg.vocab_padded)
    _close(lt, lj, atol=LOGIT_TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_prefill_and_decode_match_jax(per_row):
    """Prefill of a 10-token prompt behind the frames against JAX's (the
    logits, the self K/V and the cross K/V of the cache), then 4 decode
    steps against JAX's ``decode_step(params, caches, tokens, pos)``: with
    a scalar position, or per row (each row's own learned position; the
    lockstep cache's self attention as in JAX)."""
    cfg, jm, jp, tm = _whisper()
    toks, frames = _batch(cfg, 12, s=14)
    plen = 10
    jb = {"tokens": jnp.asarray(toks[:, :plen]), "frames": jnp.asarray(frames)}
    lj, cj = jm.prefill(jp, jb, 20, cache_dtype=jnp.float32)
    lt, ct = tm.prefill(torch.from_numpy(toks[:, :plen]), 20, cache_dtype=torch.float32,
                        frames=torch.from_numpy(frames))
    _close(lt, lj, atol=LOGIT_TOL)
    for key in ("k", "v", "xk", "xv"):
        _close(ct["slots"]["s0"][key], np.asarray(cj["slots"]["s0"][key]), atol=LOGIT_TOL)
    assert [int(p) for p in ct["slots"]["s0"]["pos"]] == [plen] * cfg.n_layers
    for i in range(plen, 14):
        pos = np.array([i, i + 3], np.int32) if per_row else np.int32(i)
        lj, cj = jm.decode_step(jp, cj, jnp.asarray(toks[:, i:i + 1]), jnp.asarray(pos))
        lt, ct = tm.decode_step(ct, torch.from_numpy(toks[:, i:i + 1]), torch.from_numpy(np.asarray(pos)))
        _close(lt, lj, atol=LOGIT_TOL)


def test_decode_takes_the_position_from_the_cache():
    """Left None, the position is the first ``encdec`` slot's cache count:
    the same bits as passing it; and the decoded logits equal the
    teacher-forced forward's."""
    cfg, _, _, tm = _whisper()
    toks, frames = _batch(cfg, 13, s=12)
    f = torch.from_numpy(frames)
    _, a = tm.prefill(torch.from_numpy(toks[:, :8]), 16, cache_dtype=torch.float32, frames=f)
    _, b = tm.prefill(torch.from_numpy(toks[:, :8]), 16, cache_dtype=torch.float32, frames=f)
    full = tm(torch.from_numpy(toks), frames=f)
    for i in range(8, 12):
        la, a = tm.decode_step(a, torch.from_numpy(toks[:, i:i + 1]))
        lb, b = tm.decode_step(b, torch.from_numpy(toks[:, i:i + 1]), i)
        assert torch.equal(la, lb)
        _close(la[:, 0], full[:, i].numpy(), atol=LOGIT_TOL)


def test_prefill_caches_the_cross_kv_of_the_attention_call():
    """The cached ``xk`` / ``xv`` are the cross attention's own K/V, which
    JAX computes a second time for the cache: the same bits as that
    second projection of the encoder's output."""
    cfg, _, _, tm = _whisper()
    toks, frames = _batch(cfg, 14, s=6)
    _, c = tm.prefill(torch.from_numpy(toks), 8, cache_dtype=torch.float32, frames=torch.from_numpy(frames))
    with torch.no_grad():
        enc = tm._encode(torch.from_numpy(frames))
        for g, (_, _, _, _, blk) in enumerate(tm._layer_params()):
            for key, w in (("xk", "wk"), ("xv", "wv")):
                assert torch.equal(c["slots"]["s0"][key][g], TL._proj(enc, blk["cross"][w]))


def test_causality_and_a_bidirectional_encoder():
    """Logits at the first 10 positions do not depend on later tokens; the
    last frame moves every position's encoder output (bidirectional) and
    so every token's logits."""
    cfg, _, _, tm = _whisper()
    toks, frames = _batch(cfg, 15, s=16)
    f = torch.from_numpy(frames)
    full = tm(torch.from_numpy(toks), frames=f)
    short = tm(torch.from_numpy(toks[:, :10]), frames=f)
    _close(full[:, :10], short.numpy(), atol=LOGIT_TOL)
    moved = f.clone()
    moved[:, -1] = torch.from_numpy(np.random.default_rng(16).standard_normal(moved[:, -1].shape).astype(np.float32))
    with torch.no_grad():
        e0, e1 = tm._encode(f), tm._encode(moved)
    assert bool(((e0 - e1).abs().amax(-1) > 1e-4).all())
    assert bool(((full - tm(torch.from_numpy(toks), frames=moved)).abs().amax(-1) > 1e-4).all())


def test_frames_are_required_exactly_with_an_encoder():
    cfg, _, _, tm = _whisper()
    toks, frames = _batch(cfg, 16)
    t = torch.from_numpy(toks)
    for call in (lambda: tm(t), lambda: tm.prefill(t, 32), lambda: tm.loss(tm.param_tree(), {"tokens": t})):
        with pytest.raises(ValueError, match="frames"):
            call()
    yi = StreamModel(TC.get_reduced("yi-6b"), Policy("float32", "float32", "float32"), device="cpu")
    with pytest.raises(ValueError, match="frames"):
        yi(t % 100, frames=torch.from_numpy(frames))


def test_one_train_step():
    """Mirror of tests/test_models.py:37 on whisper: one AdamW step on a
    batch with its frames, every leaf (the encoder's and the layer norms'
    biases among them) moved, a finite and lower loss after it."""
    from repro_torch.train import adamw, build_train_step
    from repro_torch.train.optimizer import tree_leaves

    cfg, _, jp, _ = _whisper()
    m = StreamModel(TC.get_reduced(WH), Policy("float32", "float32", "float32"), device="cpu", generator=None)
    m.load_params(convert.params_from_jax(jax.tree.map(np.asarray, jp)))
    toks, frames = _batch(cfg, 17, s=24)
    batch = {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)}
    before = [x.detach().clone() for x in tree_leaves(m.param_tree())]
    step, _ = build_train_step(m, adamw(1e-3))
    state = {"params": m.param_tree(), "opt": adamw(1e-3).init(m.param_tree())}
    m.requires_grad_(True)
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    after = tree_leaves(state["params"])
    assert all(not torch.equal(a, b) for a, b in zip(before, after))
    with torch.no_grad():
        l2, _ = m.loss(state["params"], batch)
    assert np.isfinite(float(l2)) and float(l2) < float(metrics["loss"])


def test_full_width_config_builds():
    """whisper-tiny at its published widths on the meta device: 4 + 4
    layers of d 384, 6 heads of 64, the 1500-frame cross cache."""
    cfg = TC.get(WH)
    m = StreamModel(cfg, Policy(), device="meta", generator=None)
    t = m.param_tree()
    assert tuple(t["encoder"]["slots"]["s0"]["mixer"]["wq"].shape) == (4, 384, 6, 64)
    assert tuple(t["slots"]["s0"]["cross"]["wo"].shape) == (4, 6, 64, 384)
    c = m.init_cache(2, 448)
    assert tuple(c["slots"]["s0"]["xk"].shape) == (4, 2, 1500, 6, 64)


def test_chip_smoke_bounds_take_two_lengths():
    """chip_smoke.py's bound helpers: without a mask Sq queries over Sk keys
    are Sq x Sk pairs; K/V bytes count Sk rows, q / o / lse Sq; one length
    gives the old counts."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.mask_pairs(448, False, None, 1500) == 448 * 1500
    assert cs.mask_pairs(448, True, None) == cs.mask_pairs(448, True, None, 448) == 448 * 449 // 2
    assert cs.mask_pairs(300, False, 50) == sum(299 - max(q - 49, 0) + 1 for q in range(300))
    fwd, by = cs.attention_bound(4, 6, 6, 448, 64, "bfloat16", False, None, 1500)
    assert by == "operations" and fwd == pytest.approx(4 * 64 * 6 * 4 * 448 * 1500 / 989e12 * 1e3)
    bwd, _ = cs.attention_bwd_bound(4, 6, 6, 448, 64, "bfloat16", False, None, 1500)
    assert bwd == pytest.approx(10 * 64 * 6 * 4 * 448 * 1500 / 989e12 * 1e3)
    small, by = cs.attention_bound(1, 6, 6, 4, 64, "bfloat16", False, None, 1500)
    assert by == "bytes" and small == pytest.approx(2 * 64 * (2 * 6 * 4 + 2 * 6 * 1500) / 3.35e12 * 1e3)
