"""LM training in the port against the JAX package, on moved weights.

Reduced yi-6b in f32 on the CPU, its vocab cut to 250 so that the padded
unembed (256 columns) has columns past the vocab and a batch can hold
labels >= vocab, which the loss must mask. Inputs from numpy seeds.
Tolerances: the loss and every gradient leaf at 1e-5 relative to the
leaf's largest element (f32 with sums in another order); AdamW against
JAX's at 1e-6 (f32 leaf) and one bf16 step (bf16 leaf); the 5-step
TrainingJob loss trajectories at 1e-4 (the same f32 arithmetic, five
AdamW steps apart).
"""

import dataclasses

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
from repro.train.optimizer import adamw as jadamw, cosine_schedule as jcosine
import repro_torch.configs as TC
import repro_torch.core as core
import repro_torch.data as data
from repro_torch import convert
from repro_torch.data.formats import RawCodec
from repro_torch.models.model import StreamModel
from repro_torch.models.policy import Policy
from repro_torch.train import TrainingJob, adamw, build_train_step, clip_by_global_norm, cosine_schedule
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
TRAJ_TOL = 1e-4


def _cfgs():
    return (dataclasses.replace(JC.get_reduced("yi-6b"), vocab=VOCAB),
            dataclasses.replace(TC.get_reduced("yi-6b"), vocab=VOCAB))


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs()
    jm = JModel(jcfg, JPolicy(param_dtype="float32", compute_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    moved = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    tm = StreamModel(tcfg, Policy("float32", "float32", "float32"), device="cpu", generator=None)
    tm.load_params(moved)
    return jm, jp, tm, moved


def _tokens(seed, b=2, s=SEQ):
    """Tokens over the whole padded table: some labels are >= VOCAB."""
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("loss_chunk", [8, 1024])
def test_loss_and_gradients_match_jax(pair, loss_chunk):
    jm, jp, tm, _ = pair
    tok = _tokens(0)
    assert (tok[:, 1:] >= VOCAB).any()
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {"tokens": jnp.asarray(tok)}, loss_chunk=loss_chunk), has_aux=True
    ))(jp)
    params = tm.param_tree()
    tm.requires_grad_(True)
    try:
        tl, tmet = tm.loss(params, {"tokens": torch.from_numpy(tok)}, loss_chunk=loss_chunk)
        tg = torch.autograd.grad(tl, tree_leaves(params))
    finally:
        tm.requires_grad_(False)
    assert abs(float(tl.detach()) - float(jl)) <= GRAD_TOL * abs(float(jl))
    assert float(tmet["loss"].detach()) == pytest.approx(float(jmet["loss"]), rel=GRAD_TOL)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for a, b in zip(jleaves, tg):
        assert a.shape == tuple(b.shape)
        assert _rel(b.numpy(), a) <= GRAD_TOL


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


def test_smoke_forward_one_train_step(pair):
    """Mirror of tests/test_models.py:38 on yi-6b: forward shapes, finite
    logits, one AdamW step, a finite loss after it."""
    _, _, _, moved = pair
    _, tcfg = _cfgs()
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


def test_causality(pair):
    """Mirror of tests/test_models.py:102: logits[:, :k] do not depend on
    tokens after k."""
    _, _, tm, _ = pair
    tok = torch.from_numpy(_tokens(3, s=32))
    full = tm.forward(tok)
    short = tm.forward(tok[:, :20])
    np.testing.assert_allclose(full[:, :20].numpy(), short.numpy(), atol=2e-4, rtol=2e-4)


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


def _stream(n=48, seed=8):
    """A Markov corpus (examples/train_lm.py's generator at SEQ) ingested
    by the port as RAW records into a 2-partition topic of the port's log."""
    corpus = _example().synth_corpus(n, 256, seq=SEQ, seed=seed)
    log, reg = core.StreamLog(), core.Registry()
    spec = reg.register_model("yi-6b-smoke")
    dep = reg.deploy(reg.create_configuration([spec.model_id]).config_id, "train")
    log.create_topic("corpus", core.LogConfig(num_partitions=2))
    data.ingest(log, "corpus", RawCodec("int32", (SEQ,), "int32", ()),
                {"data": corpus, "label": np.zeros(n, np.int32)}, dep.deployment_id, validation_rate=0.125)
    return log, reg, spec, dep


@pytest.mark.parametrize("streaming", [False, True])
def test_training_job_trajectory_matches_jax(pair, streaming):
    """The roadmap's gate: 5 steps of TrainingJob in each package on the
    same moved params and the same ingested stream give the same losses
    (1e-4), and the same streaming or held-out eval."""
    jm, jp, _, moved = pair
    _, tcfg = _cfgs()
    log, reg, spec, dep = _stream()
    jl = []

    def jloss(p, b):
        loss, met = jm.loss(p, {"tokens": b["data"]}, loss_chunk=16)
        jax.debug.callback(lambda v: jl.append(float(v)), met["loss"])
        return loss, met

    jres = JTrainingJob(log, reg, dep.deployment_id, spec.model_id, loss_fn=jloss, init_fn=lambda _: jp,
                        opt=jadamw(jcosine(3e-3, 2, 5)), seed=0).run(
        batch_size=4, max_steps=5, streaming=streaming, fetch_records=16)
    tm = StreamModel(tcfg, Policy("float32", "float32", "float32"), device="cpu", generator=None)
    tl = []

    def init_fn(gen):
        assert isinstance(gen, torch.Generator)
        tm.load_params(moved)
        return tm.param_tree()

    def tloss(p, b):
        loss, met = tm.loss(p, {"tokens": b["data"]}, loss_chunk=16)
        tl.append(float(met["loss"].detach()))
        return loss, met

    job = TrainingJob(log, reg, dep.deployment_id, spec.model_id, loss_fn=tloss, init_fn=init_fn,
                      opt=adamw(cosine_schedule(3e-3, 2, 5)), seed=0, device="cpu")
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
