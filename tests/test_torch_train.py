"""LM training in the port against the JAX package, on moved weights.

Reduced yi-6b, reduced mamba2 and reduced recurrentgemma (5 layers: a
group of rec, rec, local and a tail of two rec, window 16) in f32 on the
CPU, their vocab cut to 250
so that the padded unembed (256 columns; mamba2's tied embed) has columns
past the vocab and a batch can hold labels >= vocab, which the loss must
mask. Inputs from numpy seeds. Tolerances: the loss and every gradient
leaf at 1e-5 relative to the leaf's largest element for yi-6b (f32 with
sums in another order) and 1e-4 for mamba2 (its scan: JAX's chunked form
takes exps of cumsum differences where the port's plain version steps a
product of decays; measured 1.1e-5 on w_C); recurrentgemma at yi-6b's
1e-5 (its RG-LRU scan through RGLRUScan's plain sides, the sequential
recurrence and its adjoint, against JAX's associative scan: measured
7.5e-6 on a conv leaf); reduced qwen2-7b (QKV bias) at 1e-5 and
gemma2-2b (attention and final softcaps, sandwich norms) at 5e-5, their
biases and norm weights drawn away from JAX's zeros and ones (gemma2's
four (1 + w) norms a layer, about 2 each, carry the f32 rounding of sums
in another order further: measured 2.2e-5 on a wq leaf, median 5.9e-6,
and 1.7e-6 with ``norm_plus_one`` off); AdamW against
JAX's at 1e-6
(f32 leaf) and one bf16 step (bf16 leaf); the 5-step TrainingJob loss
trajectories at 1e-4 (the same f32 arithmetic, five AdamW or adamw8bit
steps apart). Reduced qwen3-moe-30b-a3b and arctic-480b (its dense
residual) at capacity factor 1.0, where routes drop, and 8.0, where none
do: the loss with its aux and every gradient leaf (the router's among
them) at yi-6b's 1e-5 (measured 1.9e-6 at most), and their 5-step
trajectories at their own factor of 4.0. Reduced pixtral-12b (8 patch
positions before the tokens, the loss shifted by them as in JAX) at
1e-5 (measured 2.3e-6), its trajectory with patches drawn from each
batch's tokens. Reduced whisper-tiny (its encoder over frames drawn from
each batch's tokens, layer norms moved off 1 and 0) at 1e-5, and its
trajectory the same way.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.data as jdata
from repro.models.model import StreamModel as JModel
from repro.models.policy import Policy as JPolicy
from repro.train import TrainingJob as JTrainingJob
from repro.train.optimizer import adamw as jadamw, adamw8bit as jadamw8bit, cosine_schedule as jcosine
import repro_torch.configs as TC
import repro_torch.core as core
import repro_torch.data as data
from repro_torch import convert
from repro_torch.data.formats import RawCodec
from repro_torch.models.model import StreamModel
from repro_torch.models.policy import Policy
from repro_torch.train import TrainingJob, adamw, adamw8bit, build_train_step, clip_by_global_norm, cosine_schedule
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.trainer import _to_microbatches

VOCAB = 250
SEQ = 33


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These models are tiny: torch's thread pool only contends with the
    other test workers, so each test here runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

GRAD_TOL = 1e-5
SSM_GRAD_TOL = 1e-4
G2_GRAD_TOL = 5e-5
TRAJ_TOL = 1e-4
M2 = "mamba2-2.7b"
RG = "recurrentgemma-9b"
G2 = "gemma2-2b"
Q2 = "qwen2-7b"
QM = "qwen3-moe-30b-a3b"
AR = "arctic-480b"
PX = "pixtral-12b"
WH = "whisper-tiny"


def _cfgs(arch="yi-6b", factor=None):
    """JAX's and the port's reduced config of ``arch`` at VOCAB; an MoE's
    at capacity ``factor`` where one is given."""
    out = []
    for cfg in (JC.get_reduced(arch), TC.get_reduced(arch)):
        cfg = dataclasses.replace(cfg, vocab=VOCAB)
        if factor is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))
        out.append(cfg)
    return tuple(out)


def _perturbed(jp, seed=11):
    """JAX's params with the QKV biases drawn from N(0, 0.5^2) and every
    norm weight moved by N(0, 0.1^2), so that the loss and its gradients
    pin them (JAX's init leaves them 0 and 1)."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        names = {getattr(k, "key", None) for k in path}
        if names & {"bq", "bk", "bv"}:
            return leaf + 0.5 * rng.standard_normal(leaf.shape).astype(np.float32)
        if names & {"norm1", "norm2", "post1", "post2", "final_norm", "norm_x"}:
            return leaf + 0.1 * rng.standard_normal(leaf.shape).astype(np.float32)
        return leaf

    return jax.tree.map(jnp.asarray, jax.tree_util.tree_map_with_path(move, jax.tree.map(np.asarray, jp)))


@functools.lru_cache(maxsize=None)
def _pair(arch, factor=None):
    jcfg, tcfg = _cfgs(arch, factor)
    jm = JModel(jcfg, JPolicy(param_dtype="float32", compute_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    if arch in (G2, Q2, WH):
        jp = _perturbed(jp)
    moved = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    tm = StreamModel(tcfg, Policy("float32", "float32", "float32"), device="cpu", generator=None)
    tm.load_params(moved)
    return jm, jp, tm, moved


@pytest.fixture(scope="module")
def pair():
    return _pair("yi-6b")


def _tokens(seed, b=2, s=SEQ):
    """Tokens over the whole padded table: some labels are >= VOCAB."""
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def _patches(tok, cfg):
    """pixtral's patch embeddings for a batch of ``tok``: a seeded table's
    rows picked by the batch's first tokens, so every row has its own (the
    same in JAX's jitted loss and in the port's)."""
    table = np.random.default_rng(13).standard_normal((256, cfg.d_model)).astype(np.float32)
    return table[np.asarray(tok)[:, :cfg.frontend_len]]


def _frames(tok, cfg):
    """whisper's frame embeddings for a batch of ``tok``: a seeded table of
    (enc_seq, d) blocks picked by each row's first token."""
    table = np.random.default_rng(14).standard_normal((256, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return table[np.asarray(tok)[:, 0]]


def _batch(tok, cfg):
    """``{"tokens"}``, with ``patch_embeds`` for a patch frontend and
    ``frames`` for an encoder (numpy)."""
    out = {"tokens": tok}
    if cfg.frontend == "patches":
        out["patch_embeds"] = _patches(tok, cfg)
    if cfg.enc_dec:
        out["frames"] = _frames(tok, cfg)
    return out


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("arch,loss_chunk,factor", [
    pytest.param("yi-6b", 8, None, id="8"), pytest.param("yi-6b", 1024, None, id="1024"),
    pytest.param(M2, 8, None, id="mamba2-8"), pytest.param(M2, 1024, None, id="mamba2-1024"),
    pytest.param(RG, 8, None, id="recurrentgemma-8"), pytest.param(RG, 1024, None, id="recurrentgemma-1024"),
    pytest.param(G2, 8, None, id="gemma2-8"), pytest.param(Q2, 8, None, id="qwen2-8"),
    pytest.param(QM, 8, 1.0, id="qwen3-moe-8-drops"), pytest.param(QM, 8, 8.0, id="qwen3-moe-8-no-drops"),
    pytest.param(AR, 8, 1.0, id="arctic-8-drops"), pytest.param(AR, 1024, 8.0, id="arctic-1024-no-drops"),
    pytest.param(PX, 8, None, id="pixtral-8"), pytest.param(PX, 1024, None, id="pixtral-1024"),
    pytest.param(WH, 8, None, id="whisper-8"), pytest.param(WH, 1024, None, id="whisper-1024"),
])
def test_loss_and_gradients_match_jax(arch, loss_chunk, factor):
    """The loss and every gradient leaf against jax.value_and_grad of the
    JAX loss (mamba2: its tied embed, its f32 A_log, D and dt_bias leaves
    with f32 gradients, its scan through SSDScan's CPU sides;
    recurrentgemma: its tied and scaled embed, its f32 b_a, b_i and Lambda
    leaves, its scan through RGLRUScan's CPU sides, its windowed local
    attention through FlashAttention's; gemma2: its softcapped local and
    global attention through FlashAttention's CPU sides, its final
    softcap, its sandwich norms; qwen2: its QKV biases; qwen3-moe and
    arctic: the router's f32 leaf, the stacked experts and the aux loss,
    with routes dropped at factor 1.0 and none at 8.0, the dispatch's
    adjoint through ``moe._Dispatch``; pixtral: patch embeddings before the
    tokens, the loss shifted by their count; whisper: its encoder over the
    batch's frames, cross attention, learned positions and layer norms,
    their weights and biases drawn away from 1 and 0)."""
    from repro_torch.models import moe

    jm, jp, tm, _ = _pair(arch, factor)
    tol = {M2: SSM_GRAD_TOL, G2: G2_GRAD_TOL}.get(arch, GRAD_TOL)
    tok = _tokens(0)
    assert (tok[:, 1:] >= VOCAB).any()
    batch = _batch(tok, tm.cfg)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jax.tree.map(jnp.asarray, batch), loss_chunk=loss_chunk), has_aux=True
    ))(jp)
    params = tm.param_tree()
    tm.requires_grad_(True)
    moe.DROPS = torch.zeros((), dtype=torch.int64)
    try:
        tl, tmet = tm.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()}, loss_chunk=loss_chunk)
        tg = torch.autograd.grad(tl, tree_leaves(params))
        drops = int(moe.DROPS)
    finally:
        tm.requires_grad_(False)
        moe.DROPS = None
    if factor is not None:
        assert (drops > 0) == (factor == 1.0), drops
        assert float(tmet["aux"].detach()) == pytest.approx(float(jmet["aux"]), rel=tol) and float(jmet["aux"]) > 0
    assert abs(float(tl.detach()) - float(jl)) <= tol * abs(float(jl))
    assert float(tmet["loss"].detach()) == pytest.approx(float(jmet["loss"]), rel=tol)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for a, b in zip(jleaves, tg):
        assert a.shape == tuple(b.shape) and b.dtype == torch.float32
        assert _rel(b.numpy(), a) <= tol


def test_loss_masks_labels_past_vocab(pair):
    """Labels >= vocab add nothing: changing them leaves the loss alone."""
    _, _, tm, _ = pair
    tok = _tokens(1)
    assert (tok[:, -1] >= VOCAB).any()
    other = tok.copy()
    last = other[:, -1]
    other[:, -1] = np.where(last >= VOCAB, 255 - (last - VOCAB), last)  # other labels past the vocab
    with torch.no_grad():
        hidden_only = tm.loss(tm.param_tree(), {"tokens": torch.from_numpy(tok[:, :-1])})[0]
        a = tm.loss(tm.param_tree(), {"tokens": torch.from_numpy(tok)})[0]
        b = tm.loss(tm.param_tree(), {"tokens": torch.from_numpy(other)})[0]
    assert float(a) == float(b)
    assert float(a) != float(hidden_only)


def _one_train_step(arch):
    """Forward shapes, finite logits, one AdamW step, a finite and lower
    loss after it."""
    _, _, _, moved = _pair(arch)
    _, tcfg = _cfgs(arch)
    m = StreamModel(tcfg, Policy("float32", "float32", "float32"), device="cpu", generator=None)
    m.load_params(moved)
    tok = torch.from_numpy(_tokens(2))
    logits = m.forward(tok)
    assert logits.shape == (2, SEQ, tcfg.vocab_padded)
    assert torch.isfinite(logits).all()
    step, _ = build_train_step(m, adamw(1e-3))
    state = {"params": m.param_tree(), "opt": adamw(1e-3).init(m.param_tree())}
    m.requires_grad_(True)
    state, metrics = step(state, {"tokens": tok})
    assert np.isfinite(float(metrics["loss"]))
    with torch.no_grad():
        l2, _ = m.loss(state["params"], {"tokens": tok})
    assert np.isfinite(float(l2)) and float(l2) < float(metrics["loss"])


def test_smoke_forward_one_train_step(pair):
    """Mirror of tests/test_models.py:38 on yi-6b."""
    _one_train_step("yi-6b")


def test_mamba2_one_train_step():
    """Mirror of tests/test_models.py:38 on mamba2 (the scan's gradient
    through SSDScan)."""
    _one_train_step(M2)


def test_recurrentgemma_one_train_step():
    """Mirror of tests/test_models.py:38 on recurrentgemma (the RG-LRU
    scan's gradient through RGLRUScan, the local attention's through
    FlashAttention)."""
    _one_train_step(RG)


def _causal(arch):
    """logits[:, :k] do not depend on tokens after k."""
    _, _, tm, _ = _pair(arch)
    tok = torch.from_numpy(_tokens(3, s=32))
    full = tm.forward(tok)
    short = tm.forward(tok[:, :20])
    np.testing.assert_allclose(full[:, :20].numpy(), short.numpy(), atol=2e-4, rtol=2e-4)


def test_causality(pair):
    """Mirror of tests/test_models.py:102 on yi-6b."""
    _causal("yi-6b")


def test_mamba2_causality():
    """Mirror of tests/test_models.py:102 on mamba2 (a ragged last chunk of
    the reduced config's 16: 20 = 16 + 4)."""
    _causal(M2)


def test_recurrentgemma_causality():
    """Mirror of tests/test_models.py:102 on recurrentgemma (32 tokens past
    the reduced config's window of 16)."""
    _causal(RG)


def test_chunked_loss_invariant_to_chunk_size(pair):
    """Mirror of tests/test_models.py:115 (odd length: a ragged tail)."""
    _, _, tm, _ = pair
    tok = {"tokens": torch.from_numpy(_tokens(4, s=33))}
    with torch.no_grad():
        losses = [float(tm.loss(tm.param_tree(), tok, loss_chunk=c)[0]) for c in (4, 8, 16, 64)]
    assert max(losses) - min(losses) < 1e-4, losses


def test_layer_views_follow_grad_mode(pair):
    """Serving keeps one set of per-layer views; under grad mode they are
    built anew each call and carry the gradient."""
    _, _, tm, _ = pair
    with torch.no_grad():
        assert tm._layer_params() is tm._layer_params()
    tm.requires_grad_(True)
    try:
        a, b = tm._layer_params(), tm._layer_params()
        assert a is not b
        assert a[0][4]["mixer"]["wq"].requires_grad
    finally:
        tm.requires_grad_(False)


# ------------------------------------------------------------------ optimizer
def test_cosine_schedule_shape():
    """Mirror of tests/test_optimizer.py:97."""
    lr = cosine_schedule(1e-3, warmup_steps=10, total_steps=100)
    assert float(lr(torch.tensor(0, dtype=torch.int32))) == 0.0
    assert abs(float(lr(torch.tensor(10, dtype=torch.int32))) - 1e-3) < 1e-9
    assert float(lr(torch.tensor(100, dtype=torch.int32))) < 2e-4
    assert float(lr(torch.tensor(5, dtype=torch.int32))) == pytest.approx(5e-4)
    for s in (0, 1, 3, 7, 10, 55, 100, 120):
        assert float(lr(torch.tensor(s, dtype=torch.int32))) == float(
            jcosine(1e-3, 10, 100)(jnp.int32(s))
        )


def test_clip_by_global_norm():
    """Mirror of tests/test_optimizer.py:105."""
    g = {"a": torch.ones(3) * 3.0, "b": torch.ones(4) * 4.0}
    clipped, norm = clip_by_global_norm(g, 1.0)
    total = torch.sqrt(sum(torch.sum(x**2) for x in tree_leaves(clipped)))
    assert float(total) == pytest.approx(1.0, rel=1e-5)
    assert float(norm) == pytest.approx(np.sqrt(9 * 3 + 16 * 4), rel=1e-5)
    g2, _ = clip_by_global_norm({"a": torch.ones(2) * 0.1}, 10.0)
    np.testing.assert_allclose(g2["a"].numpy(), 0.1, rtol=1e-6)  # under: untouched


@pytest.mark.parametrize("max_norm", [1.0, 1e9], ids=["clip", "no-clip"])
def test_adamw8bit_folds_the_clip_to_the_bit(max_norm):
    """``adamw8bit``'s update with its clip folded in (the norm's scale
    handed to the update, g left as it was) gives the bits of
    ``clip_by_global_norm`` followed by an unclipped update, over three
    updates of a stacked f32 leaf with a partial block and a bf16 leaf."""
    import ml_dtypes

    rng = np.random.default_rng(12)
    w = rng.standard_normal((3, 4, 300)).astype(np.float32)
    b = rng.standard_normal((5, 128)).astype(ml_dtypes.bfloat16)
    params = [{"w": torch.from_numpy(w.copy()), "b": torch.from_numpy(b.astype(np.float32)).to(torch.bfloat16)}
              for _ in range(2)]
    folded, plain = adamw8bit(cosine_schedule(1e-2, 1, 5), max_grad_norm=max_norm), adamw8bit(
        cosine_schedule(1e-2, 1, 5), max_grad_norm=None)
    states = [folded.init(params[0]), plain.init(params[1])]
    for _ in range(3):
        g = {"w": torch.from_numpy(rng.standard_normal(w.shape).astype(np.float32) * 3),
             "b": torch.from_numpy(rng.standard_normal(b.shape).astype(np.float32) * 3).to(torch.bfloat16)}
        g_before = {k: v.clone() for k, v in g.items()}
        folded.update(g, states[0], params[0])
        assert all(torch.equal(g[k], g_before[k]) for k in g)  # not clipped in place
        clipped, norm = clip_by_global_norm({k: v.clone() for k, v in g.items()}, max_norm)
        assert (float(norm) > max_norm) == (max_norm == 1.0)
        plain.update(clipped, states[1], params[1])
    for k in ("w", "b"):
        assert torch.equal(params[0][k], params[1][k])
        for mom in ("m", "v"):
            for f in ("codes", "scales"):
                assert torch.equal(states[0][mom][k][f], states[1][mom][k][f])


def test_microbatch_equals_full_batch():
    """Mirror of tests/test_optimizer.py:115 (dp 2 and the port's dp 1)."""
    y = _to_microbatches(torch.arange(32), k=4, dp=2)
    assert y.shape == (4, 8)
    assert sorted(y.ravel().tolist()) == list(range(32))
    assert torch.equal(_to_microbatches(torch.arange(32), k=4), torch.arange(32).reshape(4, 8))


def test_adamw_matches_jax_over_three_updates():
    """An f32 stacked leaf and a bf16 leaf through three clipped updates of
    a warm-up + cosine schedule, against JAX's adamw."""
    import ml_dtypes

    rng = np.random.default_rng(5)
    w = rng.standard_normal((3, 4, 5)).astype(np.float32)
    b = rng.standard_normal(6).astype(ml_dtypes.bfloat16)
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    tp = {"w": torch.from_numpy(w.copy()), "b": torch.from_numpy(b.astype(np.float32)).to(torch.bfloat16)}
    jo, to = jadamw(jcosine(1e-2, 1, 5)), adamw(cosine_schedule(1e-2, 1, 5))
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(3):
        gw = rng.standard_normal((3, 4, 5)).astype(np.float32) * 3
        gb = rng.standard_normal(6).astype(np.float32)
        jp, js = jo.update({"w": jnp.asarray(gw), "b": jnp.asarray(gb).astype(jnp.bfloat16)}, js, jp)
        tp, ts = to.update({"w": torch.from_numpy(gw), "b": torch.from_numpy(gb).to(torch.bfloat16)}, ts, tp)
    assert int(ts["step"]) == int(js["step"]) == 3
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tp["b"].float().numpy(), np.asarray(jp["b"]).astype(np.float32), rtol=2**-8)
    for k in ("m", "v"):
        # the global norm sums squares per layer slice here, per leaf in
        # JAX: the clip scale may differ in its last bit
        np.testing.assert_allclose(ts[k]["w"].numpy(), np.asarray(js[k]["w"]), rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(ts[k]["b"].numpy(), np.asarray(js[k]["b"]), rtol=1e-5, atol=1e-8)


def test_optimizer_state_moves_from_jax():
    """A JAX AdamW state moved through convert continues as JAX's does."""
    rng = np.random.default_rng(6)
    w = rng.standard_normal((2, 3, 4)).astype(np.float32)
    jo, to = jadamw(1e-2), adamw(1e-2)
    jp = {"w": jnp.asarray(w)}
    js = jo.init(jp)
    g = [rng.standard_normal(w.shape).astype(np.float32) for _ in range(3)]
    jp, js = jo.update({"w": jnp.asarray(g[0])}, js, jp)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    ts = convert.opt_state_from_jax(jax.tree.map(np.asarray, js))
    for gi in g[1:]:
        jp, js = jo.update({"w": jnp.asarray(gi)}, js, jp)
        tp, ts = to.update({"w": torch.from_numpy(gi)}, ts, tp)
    back = convert.opt_state_to_numpy(ts)
    assert back["step"] == np.asarray(js["step"]) == 3
    np.testing.assert_allclose(back["v"]["w"], np.asarray(js["v"]["w"]), rtol=1e-6)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=1e-6, atol=1e-7)


def test_microbatches_sum_in_f32_and_match_one_batch(pair):
    """Two microbatches give the one-batch step's gradients (summed in f32
    buffers, each halved; the loss is a mean over equal halves, every
    label counted), at 1e-5 of each leaf's largest element."""
    from repro_torch.train import Optimizer

    _, _, _, moved = pair
    _, tcfg = _cfgs()
    tok = torch.from_numpy(_tokens(7, b=4) % VOCAB)
    out = []
    for k in (1, 2):
        m = StreamModel(tcfg, Policy("float32", "float32", "float32"), device="cpu", generator=None)
        m.load_params(moved)
        m.requires_grad_(True)
        seen = []
        opt = Optimizer(init=lambda p: {}, update=lambda g, s, p: (seen.append(g), (p, s))[1])
        step, _ = build_train_step(m, opt, microbatches=k)
        _, metrics = step({"params": m.param_tree(), "opt": {}}, {"tokens": tok})
        out.append((float(metrics["loss"]), tree_leaves(seen[0])))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        assert b.dtype == torch.float32
        assert _rel(b.numpy(), a.numpy()) <= GRAD_TOL


# ------------------------------------------------------------ the TrainingJob
def _example():
    """examples/torch_train_lm.py as a module (examples/ is no package)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "torch_train_lm.py"
    spec = importlib.util.spec_from_file_location("torch_train_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stream(n=48, seed=8, arch="yi-6b"):
    """A Markov corpus (examples/train_lm.py's generator at SEQ) ingested
    by the port as RAW records into a 2-partition topic of the port's log."""
    corpus = _example().synth_corpus(n, 256, seq=SEQ, seed=seed)
    log, reg = core.StreamLog(), core.Registry()
    spec = reg.register_model(f"{arch}-smoke")
    dep = reg.deploy(reg.create_configuration([spec.model_id]).config_id, "train")
    log.create_topic("corpus", core.LogConfig(num_partitions=2))
    data.ingest(log, "corpus", RawCodec("int32", (SEQ,), "int32", ()),
                {"data": corpus, "label": np.zeros(n, np.int32)}, dep.deployment_id, validation_rate=0.125)
    return log, reg, spec, dep


_OPTS = {"adamw": (jadamw, adamw), "adamw8bit": (jadamw8bit, adamw8bit)}  # (JAX's, the port's)


@pytest.mark.parametrize("arch,streaming,opt", [
    pytest.param("yi-6b", False, "adamw", id="False"), pytest.param("yi-6b", True, "adamw", id="True"),
    pytest.param("yi-6b", False, "adamw8bit", id="False-adamw8bit"),
    pytest.param("yi-6b", True, "adamw8bit", id="True-adamw8bit"),
    pytest.param(M2, True, "adamw", id="mamba2-True"), pytest.param(M2, True, "adamw8bit", id="mamba2-True-adamw8bit"),
    pytest.param(RG, True, "adamw", id="recurrentgemma-True"),
    pytest.param(RG, True, "adamw8bit", id="recurrentgemma-True-adamw8bit"),
    pytest.param(G2, True, "adamw8bit", id="gemma2-True-adamw8bit"),
    pytest.param(Q2, True, "adamw", id="qwen2-True"),
    pytest.param(Q2, True, "adamw8bit", id="qwen2-True-adamw8bit"),
    pytest.param(QM, True, "adamw", id="qwen3-moe-True"),
    pytest.param(QM, True, "adamw8bit", id="qwen3-moe-True-adamw8bit"),
    pytest.param(AR, True, "adamw", id="arctic-True"), pytest.param(AR, True, "adamw8bit", id="arctic-True-adamw8bit"),
    pytest.param(PX, True, "adamw", id="pixtral-True"), pytest.param(PX, True, "adamw8bit", id="pixtral-True-adamw8bit"),
    pytest.param(WH, True, "adamw", id="whisper-True"), pytest.param(WH, True, "adamw8bit", id="whisper-True-adamw8bit"),
])
def test_training_job_trajectory_matches_jax(arch, streaming, opt):
    """The roadmap's gate: 5 steps of TrainingJob in each package on the
    same moved params and the same ingested stream give the same losses
    (1e-4), and the same streaming or held-out eval, with AdamW and with
    adamw8bit; on reduced yi-6b, on reduced mamba2 (whose tree mixes
    bf16-able leaves with f32 (L, H) ones narrower than a quantization
    block) and on reduced recurrentgemma (a tail of layers beside the
    stacked group, tied embeddings); on reduced gemma2 (softcaps and
    sandwich norms: their leaves narrower than a quantization block) and
    qwen2 (the bias leaves (n, heads, hd)); on reduced qwen3-moe and arctic
    (the f32 router (L, d, E), narrower than a block, and the stacked
    (L, E, d, f) / (L, E, f, d) experts), reduced pixtral (patch
    embeddings from each batch's tokens, ``_patches``) and reduced whisper
    (frames from each batch's tokens, ``_frames``)."""
    jopt, topt = _OPTS[opt]
    jm, jp, _, moved = _pair(arch)
    _, tcfg = _cfgs(arch)
    log, reg, spec, dep = _stream(arch=arch)
    jl = []

    front = tcfg.frontend == "patches"
    table = jnp.asarray(np.random.default_rng(13).standard_normal((256, tcfg.d_model)).astype(np.float32))
    ftable = (jnp.asarray(np.random.default_rng(14).standard_normal((256, tcfg.enc_seq, tcfg.d_model))
                          .astype(np.float32)) if tcfg.enc_dec else None)

    def jloss(p, b):
        batch = {"tokens": b["data"]}
        if front:  # _patches, in jnp
            batch["patch_embeds"] = table[b["data"][:, :tcfg.frontend_len]]
        if tcfg.enc_dec:  # _frames, in jnp
            batch["frames"] = ftable[b["data"][:, 0]]
        loss, met = jm.loss(p, batch, loss_chunk=16)
        jax.debug.callback(lambda v: jl.append(float(v)), met["loss"])
        return loss, met

    jres = JTrainingJob(log, reg, dep.deployment_id, spec.model_id, loss_fn=jloss, init_fn=lambda _: jp,
                        opt=jopt(jcosine(3e-3, 2, 5)), seed=0).run(
        batch_size=4, max_steps=5, streaming=streaming, fetch_records=16)
    tm = StreamModel(tcfg, Policy("float32", "float32", "float32"), device="cpu", generator=None)
    tl = []

    def init_fn(gen):
        assert isinstance(gen, torch.Generator)
        tm.load_params(moved)
        return tm.param_tree()

    def tloss(p, b):
        batch = {"tokens": b["data"]}
        if front:
            batch["patch_embeds"] = torch.from_numpy(_patches(b["data"].numpy(), tcfg))
        if tcfg.enc_dec:
            batch["frames"] = torch.from_numpy(_frames(b["data"].numpy(), tcfg))
        loss, met = tm.loss(p, batch, loss_chunk=16)
        tl.append(float(met["loss"].detach()))
        return loss, met

    job = TrainingJob(log, reg, dep.deployment_id, spec.model_id, loss_fn=tloss, init_fn=init_fn,
                      opt=topt(cosine_schedule(3e-3, 2, 5)), seed=0, device="cpu")
    tres = job.run(batch_size=4, max_steps=5, streaming=streaming, fetch_records=16)
    assert tres.steps == jres.steps == 5
    np.testing.assert_allclose(tl[:5], jl[:5], rtol=TRAJ_TOL)
    assert tres.eval_metrics["loss"] == pytest.approx(jres.eval_metrics["loss"], rel=TRAJ_TOL)
    results = reg.results_for(dep.deployment_id)
    assert len(results) == 2 and results[-1].metrics["loss"] == pytest.approx(tl[4])


def test_lm_stream_training_and_generation():
    """Mirror of tests/test_integration.py:134 on reduced yi-6b: tokens
    streamed as RAW records, trained by the TrainingJob, then served by
    prefill + greedy decode from the trained parameters."""
    _, tcfg = _cfgs()
    log, reg, spec, dep = _stream(n=32, seed=9)
    model = StreamModel(tcfg, Policy("float32", "float32", "float32"), device="cpu", generator=None)
    job = TrainingJob(log, reg, dep.deployment_id, spec.model_id,
                      loss_fn=lambda p, b: model.loss(p, {"tokens": b["data"]}),
                      init_fn=model.init,
                      opt=adamw(3e-3), seed=1, device="cpu")
    res = job.run(batch_size=4, max_steps=10, streaming=True)
    assert np.isfinite(res.metrics["loss"]) and np.isfinite(res.eval_metrics["loss"])
    model.requires_grad_(False)
    prompt = torch.from_numpy(_tokens(10, s=16) % VOCAB)
    logits, cache = model.prefill(prompt, SEQ + 8, cache_dtype=torch.float32)
    tok = logits.argmax(-1)[:, None]
    outs = [tok]
    for _ in range(4):
        lg, cache = model.decode_step(cache, tok)
        tok = lg[:, 0].argmax(-1)[:, None]
        outs.append(tok)
    assert torch.cat(outs, dim=1).shape == (2, 5) and torch.isfinite(lg).all()


def test_example_trains_on_the_cpu(tmp_path):
    """examples/torch_train_lm.py end to end on the CPU at its tiny size,
    through a crash and a resume, under its watchdog."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(repo / "src"), "TRAIN_TIMEOUT_S": "240", "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, str(repo / "examples" / "torch_train_lm.py"), "--device", "cpu", "--steps", "12",
         "--batch", "8", "--kill-at", "5", "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "injected crash after step 5" in out.stdout
    assert "done at step 12" in out.stdout
    assert "step_12" in os.listdir(tmp_path)
