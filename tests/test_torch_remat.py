"""Activation recomputation (``Policy.remat``) in the port, on the CPU.

The port's ``StreamModel._run_stack`` runs each layer group (one pass
over the pattern) under ``torch.utils.checkpoint`` when it trains with
``remat`` "full" or "block", the tail layers as they are, and whisper's
encoder a layer a group, as JAX's ``_run_stack`` wraps its scan body in
``jax.checkpoint``. Reduced yi-6b, mamba2, recurrentgemma (a group of
rec, rec, local and a tail of two rec), qwen3-moe (capacity factor 1.0:
routes drop) and whisper in f32, from test_torch_train.py's moved
weights and inputs.

Tolerances: none between remat modes. A recomputed forward runs the same
ops on the same inputs, so the loss and every gradient leaf under "full"
and "block" equal "none"'s to the bit, and so do prefill and decode,
which never recompute. Against JAX with its own ``Policy(remat=...)``,
test_torch_train.py's: the loss and gradients at 1e-5 of each leaf's
largest element (1e-4 for mamba2's scan), the 5-step ``TrainingJob``
trajectories at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import StreamModel as JModel
from repro.models.policy import Policy as JPolicy
from repro.train import TrainingJob as JTrainingJob
from repro.train.optimizer import adamw as jadamw, cosine_schedule as jcosine
from repro_torch.models import model as TMOD
from repro_torch.models import moe
from repro_torch.models.model import StreamModel
from repro_torch.models.policy import Policy
from repro_torch.train import TrainingJob, adamw, cosine_schedule
from repro_torch.train.optimizer import tree_leaves

import test_torch_train as TT

YI, M2, RG, QM, WH = "yi-6b", TT.M2, TT.RG, TT.QM, TT.WH
ARCHS = (YI, M2, RG, QM, WH)
FACTOR = {QM: 1.0}  # qwen3-moe at a capacity that drops routes
FP32 = ("float32", "float32", "float32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These models are tiny: torch's thread pool only contends with the
    other test workers, so each test here runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch, remat):
    """The port's reduced ``arch`` under ``Policy(remat=remat)`` on
    test_torch_train.py's moved weights."""
    _, _, _, moved = TT._pair(arch, FACTOR.get(arch))
    _, tcfg = TT._cfgs(arch, FACTOR.get(arch))
    m = StreamModel(tcfg, Policy(*FP32, remat=remat), device="cpu", generator=None)
    m.load_params(moved)
    return m


def _count_layers(m):
    """Count ``m._layer``'s calls in ``calls[0]`` (an instance attribute
    shadows the method)."""
    calls = [0]
    layer = m._layer

    def counted(*args, **kwargs):
        calls[0] += 1
        return layer(*args, **kwargs)

    m._layer = counted
    return calls


def _loss_and_grads(m, batch, loss_chunk=8):
    """The loss, every gradient leaf in JAX's order, the routes dropped
    (``moe.DROPS``) and the number of layer calls, forward and recompute."""
    calls = _count_layers(m)
    params = m.param_tree()
    m.requires_grad_(True)
    moe.DROPS = torch.zeros((), dtype=torch.int64)
    try:
        loss, _ = m.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()}, loss_chunk=loss_chunk)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        drops = int(moe.DROPS)
    finally:
        m.requires_grad_(False)
        moe.DROPS = None
    return loss.detach(), grads, drops, calls[0]


def _layer_calls(m, remat: bool) -> int:
    """Layer calls of one forward and backward: every layer once, and each
    group's layers (the encoder's too) once more when it recomputes."""
    cfg = m.cfg
    grouped = m.n_groups * len(cfg.pattern) + (cfg.enc_layers if cfg.enc_dec else 0)
    return cfg.n_layers + (cfg.enc_layers if cfg.enc_dec else 0) + (grouped if remat else 0)


@pytest.mark.parametrize("mode", ["full", "block"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_equal_none_to_the_bit(arch, mode):
    """The loss and every gradient leaf under ``mode`` equal "none"'s to
    the bit; each group's layers run twice and the tail's once; an MoE's
    dropped routes are counted once (not again in the recompute)."""
    batch = TT._batch(TT._tokens(0), _model(arch, "none").cfg)
    want = _loss_and_grads(_model(arch, "none"), batch)
    got = _loss_and_grads(m := _model(arch, mode), batch)
    assert torch.equal(got[0], want[0])
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
    assert got[2] == want[2] and (got[2] > 0) == (arch == QM)
    assert want[3] == _layer_calls(m, False) and got[3] == _layer_calls(m, True)
    if arch == RG:
        assert m.tail == 2 and m.n_groups == 1  # the tail is in the model and not recomputed


@pytest.mark.parametrize("mode", ["full", "block"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_loss_and_gradients_match_jax(arch, mode):
    """The loss and every gradient leaf under ``mode`` against
    ``jax.value_and_grad`` of the JAX loss under ``Policy(remat=mode)`` on
    the same weights, at test_loss_and_gradients_match_jax's tolerances."""
    jm0, jp, _, _ = TT._pair(arch, FACTOR.get(arch))
    jm = JModel(jm0.cfg, JPolicy(param_dtype="float32", compute_dtype="float32", remat=mode))
    m = _model(arch, mode)
    tol = TT.SSM_GRAD_TOL if arch == M2 else TT.GRAD_TOL
    batch = TT._batch(TT._tokens(0), m.cfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jax.tree.map(jnp.asarray, batch), loss_chunk=8), has_aux=True))(jp)
    tl, tg, _, _ = _loss_and_grads(m, batch)
    assert abs(float(tl) - float(jl)) <= tol * abs(float(jl))
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for a, b in zip(jleaves, tg):
        assert a.shape == tuple(b.shape)
        assert TT._rel(b.numpy(), a) <= tol


@pytest.mark.parametrize("arch,mode", [(YI, "full"), (YI, "block"), (M2, "full"), (QM, "full"), (WH, "full")])
def test_remat_training_job_trajectory_matches_jax(arch, mode):
    """5 steps of ``TrainingJob`` in each package under ``Policy(remat=mode)``
    on the same moved weights and the same stream give the same losses and
    eval (1e-4), as test_training_job_trajectory_matches_jax holds them
    under "none"."""
    jm0, jp, _, moved = TT._pair(arch)
    _, tcfg = TT._cfgs(arch)
    jm = JModel(jm0.cfg, JPolicy(param_dtype="float32", compute_dtype="float32", remat=mode))
    log, reg, spec, dep = TT._stream(arch=arch)
    ftable = (jnp.asarray(np.random.default_rng(14).standard_normal((256, tcfg.enc_seq, tcfg.d_model))
                          .astype(np.float32)) if tcfg.enc_dec else None)
    jl, tl = [], []

    def jloss(p, b):
        batch = {"tokens": b["data"]}
        if tcfg.enc_dec:  # test_torch_train._frames, in jnp
            batch["frames"] = ftable[b["data"][:, 0]]
        loss, met = jm.loss(p, batch, loss_chunk=16)
        jax.debug.callback(lambda v: jl.append(float(v)), met["loss"])
        return loss, met

    jres = JTrainingJob(log, reg, dep.deployment_id, spec.model_id, loss_fn=jloss, init_fn=lambda _: jp,
                        opt=jadamw(jcosine(3e-3, 2, 5)), seed=0).run(
        batch_size=4, max_steps=5, streaming=True, fetch_records=16)
    tm = StreamModel(tcfg, Policy(*FP32, remat=mode), device="cpu", generator=None)

    def init_fn(gen):
        tm.load_params(moved)
        return tm.param_tree()

    def tloss(p, b):
        batch = {"tokens": b["data"]}
        if tcfg.enc_dec:
            batch["frames"] = torch.from_numpy(TT._frames(b["data"].numpy(), tcfg))
        loss, met = tm.loss(p, batch, loss_chunk=16)
        tl.append(float(met["loss"].detach()))
        return loss, met

    tres = TrainingJob(log, reg, dep.deployment_id, spec.model_id, loss_fn=tloss, init_fn=init_fn,
                       opt=adamw(cosine_schedule(3e-3, 2, 5)), seed=0, device="cpu").run(
        batch_size=4, max_steps=5, streaming=True, fetch_records=16)
    assert tres.steps == jres.steps == 5
    np.testing.assert_allclose(tl[:5], jl[:5], rtol=TT.TRAJ_TOL)
    assert tres.eval_metrics["loss"] == pytest.approx(jres.eval_metrics["loss"], rel=TT.TRAJ_TOL)


# What "block" saves, JAX's dots_with_no_batch_dims_saveable: the outputs of
# the batch-free einsums (their weight leaves, in the order a block runs
# them). Attention's (src/repro/models/layers.py:227-229 "bsd,dhk->bshk",
# :307 "bshd,hdm->bsm"; a cross attention's :282-284), the MLP's (:151,
# :154, :158 "bsd,df->bsf" / "bsf,fd->bsd"), the SSM's (ssm.py:219-224,
# :253; B and C from one product over their joined weights), the RG-LRU's
# (rglru.py:129-130, :150) and the router's (moe.py:138 "bsd,de->bse").
# Not saved: the attention and SSD einsums, the RG-LRU's block-diagonal
# gates "bsnd,nde->bsne" (rglru.py:89) and the experts' "ecd,edf->ecf":
# each has a batch dimension.
_ATTN = ["mixer/wq", "mixer/wk", "mixer/wv", "mixer/wo"]
_GATED = ["mlp/w_in", "mlp/w_gate", "mlp/w_out"]
SAVED = {
    "attn": (YI, "slots/s0", 0, _ATTN + _GATED),
    "local": (RG, "slots/s2", 0, _ATTN + _GATED),
    "rec": (RG, "slots/s0", 0, ["mixer/w_x_branch", "mixer/w_gate_branch", "mixer/w_out"] + _GATED),
    "ssm": (M2, "slots/s0", 0, ["mixer/w_z", "mixer/w_x", "mixer/w_B|w_C", "mixer/w_dt", "mixer/w_out"]),
    "moe": (QM, "slots/s0", 0, _ATTN + ["moe/router"]),
    "encdec": (WH, "slots/s0", 0, _ATTN + ["cross/wq", "cross/wk", "cross/wv", "cross/wo", "mlp/w_in", "mlp/w_out"]),
    "bidir": (WH, "encoder/slots/s0", 0, _ATTN + ["mlp/w_in", "mlp/w_out"]),
}


def _weight(tree, path: str, i: int):
    """Layer ``i``'s leaf at ``path`` ("a/b/c"; "w_B|w_C" joins the two on
    their last axis, as the SSM's product does) as its product takes it:
    (in, out)."""
    *parts, name = path.split("/")
    for p in parts:
        tree = tree[p]
    w = torch.cat([tree[n][i] for n in name.split("|")], dim=-1) if "|" in name else tree[name][i]
    return w.reshape(-1, w.shape[-1]) if name == "wo" else w.reshape(w.shape[0], -1)  # wo: (H, D, d)


def _saved_names(m, kind: str) -> list[str]:
    """The weights whose products "block" saves in one layer of ``kind``
    of model ``m`` (an MoE's attention layers by the ``moe`` row)."""
    return SAVED["moe" if kind == "attn" and m.cfg.moe is not None else kind][3]


@pytest.mark.parametrize("kind", list(SAVED))
def test_block_policy_saves_batch_free_products(kind, monkeypatch):
    """Under "block" the selective policy saves, for one layer of block
    ``kind``, exactly the outputs of ``aten.mm`` against the weights of
    JAX's batch-free einsums, in order, each (tokens, out); over the whole
    model, those of every recomputed layer and nothing else (no ``bmm``,
    no tail layer): recorded by wrapping the policy that the dispatch mode
    consults."""
    arch, prefix, i, names = SAVED[kind]
    m = _model(arch, "block")
    saved, block_policy = [], TMOD.block_policy

    def recording(ctx, op, *args, **kwargs):
        policy = block_policy(ctx, op, *args, **kwargs)
        if policy == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            saved.append((op, args[-1] if op == torch.ops.aten.mm.default else args[2], ctx.op_output))
        return policy

    monkeypatch.setattr(TMOD, "block_policy", recording)
    batch = TT._batch(TT._tokens(0), m.cfg)
    _loss_and_grads(m, batch)
    assert all(op == torch.ops.aten.mm.default for op, _, _ in saved)
    cfg = m.cfg
    recomputed = [cfg.pattern[j % len(cfg.pattern)] for j in range(m.n_groups * len(cfg.pattern))]
    recomputed += ["bidir"] * (cfg.enc_layers if cfg.enc_dec else 0)
    assert len(saved) == sum(len(_saved_names(m, k)) for k in recomputed)
    tree = m.param_tree()
    for p in prefix.split("/"):
        tree = tree[p]
    want = [_weight(tree, n, i) for n in names]
    group = [(w, out) for _, w, out in saved if any(w.shape == v.shape and torch.equal(w, v) for v in want)]
    assert len(group) == len(names), [tuple(w.shape) for _, w, _ in saved]
    tokens = int(np.prod(batch["tokens"].shape))
    for (w, out), v, n in zip(group, want, names):
        assert torch.equal(w, v), n
        on_frames = kind == "bidir" or n in ("cross/wk", "cross/wv")  # the encoder's rows
        rows = batch["frames"].shape[0] * batch["frames"].shape[1] if on_frames else tokens
        assert tuple(out.shape) == (rows, v.shape[1]), n


def test_unknown_remat_runs_as_none():
    """A ``remat`` that is neither "block" nor "full" runs as "none", as in
    JAX: no layer runs twice, and the gradients are "none"'s."""
    batch = TT._batch(TT._tokens(0), _model(RG, "none").cfg)
    want = _loss_and_grads(_model(RG, "none"), batch)
    got = _loss_and_grads(m := _model(RG, "selective"), batch)
    assert got[3] == _layer_calls(m, False)
    assert torch.equal(got[0], want[0]) and all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


@pytest.mark.parametrize("mode", ["full", "block", "other"])
@pytest.mark.parametrize("arch", [RG, WH])
def test_prefill_and_decode_ignore_remat(arch, mode):
    """Serving never recomputes: prefill and three decode steps under any
    ``remat`` give "none"'s logits to the bit, with grad mode on or off."""
    tok = torch.from_numpy(TT._tokens(5, s=12) % TT.VOCAB)
    frames = torch.from_numpy(TT._frames(tok.numpy(), _model(arch, "none").cfg)) if arch == WH else None
    out = []
    for m in (_model(arch, "none"), _model(arch, mode)):
        calls = _count_layers(m)
        with torch.enable_grad():
            logits, cache = m.prefill(tok, 16, cache_dtype=torch.float32, frames=frames)
        steps = [logits]
        for _ in range(3):
            lg, cache = m.decode_step(cache, logits.argmax(-1)[:, None])
            logits = lg[:, 0]
            steps.append(logits)
        n = m.cfg.n_layers + (m.cfg.enc_layers if m.cfg.enc_dec else 0)
        assert calls[0] == n + 3 * m.cfg.n_layers
        out.append(steps)
    for a, b in zip(*out):
        assert torch.equal(a, b)
