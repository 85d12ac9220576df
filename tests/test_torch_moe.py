"""The port's MoE FFN and MoE models against the JAX package's, on moved weights.

``moe_ffn`` alone with drops (capacity factor 1.0) and with ties in the
router probabilities; reduced qwen3-moe-30b-a3b and arctic-480b (its
dense residual) in f32 on the CPU, with drops (factor 1.0) and without
(8.0): logits, prefill and decode, and the loss with its aux, each at
1e-5; the mirror of tests/test_models.py:168; greedy tokens through the
continuous engine; the params through both packages' checkpoints. Then
training: the dispatch's and the combine's hand-written adjoints against
autograd through the plain gathers (to the bit on dyadic inputs, within
1e-6 of the largest element otherwise) and their bits on a repeated call; serving's output
against a frozen copy of the forward as it stood before the adjoint, to
the bit; ``routes`` and ``moe_routes`` (a float64 run routed alike within
1e-5). The models' gradients against JAX's are in test_torch_train.py.
"""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import moe as JM
from repro.models.model import StreamModel as JModel
from repro.models.policy import Policy as JPolicy
from repro.serve import lm_engine as J
from repro.train import checkpoint as jck
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.models import moe as TM
from repro_torch.models.model import StreamModel
from repro_torch.models.policy import Policy
from repro_torch.serve import lm_engine as T
from repro_torch.train import checkpoint as ck

TOL = 1e-5
MOE = ("qwen3-moe-30b-a3b", "arctic-480b")
FP32_J = dict(param_dtype="float32", compute_dtype="float32")
FP32_T = Policy("float32", "float32", "float32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models are tiny: torch's thread pool only contends with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def drops():
    """``moe.DROPS`` counting for the test, then off again."""
    TM.DROPS = torch.zeros((), dtype=torch.int64)
    yield TM.DROPS
    TM.DROPS = None


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


def _with_factor(cfg, factor):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


@pytest.mark.parametrize("case", ["drops", "ties", "dense"])
def test_moe_ffn_matches_jax(case, drops):
    """One MoE FFN on JAX's layer weights at factor 1.0, where the
    capacity drops routes (the later tokens of an expert). ``ties``: a
    router column repeated and four all-zero token rows, whose 8
    probabilities are all equal, so top-k and the ranks meet ties;
    ``dense``: arctic's dense residual beside it."""
    d, e, k, f = 32, 8, 2, 24
    jmp = JM.MoEParams(n_experts=e, top_k=k, d_ff=f, capacity_factor=1.0, dense_residual=case == "dense")
    tmp = TM.MoEParams(**dataclasses.asdict(jmp))
    jp = jax.tree.map(lambda a: np.array(a[0]), JM.moe_init(jax.random.PRNGKey(1), 1, d, jmp, jnp.float32))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, d)).astype(np.float32)
    if case == "ties":
        jp["router"][:, 5] = jp["router"][:, 2]
        x[0, 3:7] = 0.0
    w = {n: rng.standard_normal(s).astype(np.float32) / np.sqrt(s[0])
         for n, s in (("w_in", (d, 40)), ("w_gate", (d, 40)), ("w_out", (40, d)))}
    jdense = tdense = None
    if case == "dense":
        from repro.models import layers as JL
        from repro_torch.models import layers as TL

        jdense = lambda t: JL.mlp(jax.tree.map(jnp.asarray, w), t, "gated")  # noqa: E731
        tdense = lambda t: TL.mlp({n: torch.from_numpy(a) for n, a in w.items()}, t, "gated")  # noqa: E731
    ffn = jax.jit(lambda p, t: JM.moe_ffn(p, t, jmp, JPolicy(**FP32_J), dense_mlp=jdense))
    yj, auxj = ffn(jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tp = convert.params_from_jax(jp)
    yt, auxt = TM.moe_ffn(tp, torch.from_numpy(x), tmp, dense_mlp=tdense)
    _close(yt, yj)
    _close(auxt, auxj)
    assert int(drops) > 0  # capacity 8 for 48 tokens x 2 routes over 8 experts
    if case == "ties":
        probs = torch.softmax(torch.from_numpy(x) @ tp["router"], -1)
        assert torch.equal(probs[..., 5], probs[..., 2])
        assert (probs[0, 3:7] == probs[0, 3:7, :1]).all()
    y2, aux2 = TM.moe_ffn(tp, torch.from_numpy(x), tmp, dense_mlp=tdense)
    assert torch.equal(y2, yt) and torch.equal(aux2, auxt)


def test_capacity_is_jax_s():
    mp = TM.MoEParams(n_experts=128, top_k=8, d_ff=768)
    jmp = JM.MoEParams(n_experts=128, top_k=8, d_ff=768)
    for n in (1, 4, 5, 512, 1000, 2000, 8192):
        assert TM._capacity(mp, n) == JM._capacity(jmp, n)


def jitted(jm):
    """JAX's entry points, each compiled once (faster here than eager)."""
    return SimpleNamespace(
        forward=jax.jit(jm.forward), loss=jax.jit(jm.loss), decode_step=jax.jit(jm.decode_step),
        prefill=jax.jit(jm.prefill, static_argnums=2, static_argnames="cache_dtype"),
    )


@functools.lru_cache(maxsize=None)
def _pair(arch, factor):
    cfg = _with_factor(JC.get_reduced(arch), factor)
    jm = JModel(cfg, JPolicy(**FP32_J))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = StreamModel(_with_factor(TC.get_reduced(arch), factor), FP32_T, device="cpu", generator=None)
    tm.load_params(convert.params_from_jax(jax.tree.map(np.asarray, jp)))
    return cfg, jitted(jm), jp, tm


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, tree))[0])


@pytest.mark.parametrize("arch", MOE)
def test_moe_param_tree_matches_jax(arch):
    """Key for key, shape and dtype: norm2 and moe (an f32 router) in
    each block, and the gated ``mlp`` only for arctic's dense residual."""
    _, _, jp, tm = _pair(arch, 8.0)
    want, got = _flat(jp), _flat(convert.params_to_numpy(tm.param_tree()))
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert got[path].shape == leaf.shape, path
    blk = tm.param_tree()["slots"]["s0"]
    assert set(blk) == ({"norm1", "mixer", "norm2", "moe", "mlp"} if arch == "arctic-480b"
                        else {"norm1", "mixer", "norm2", "moe"})
    assert blk["moe"]["router"].dtype == torch.float32 and blk["moe"]["w_in"].dtype == torch.float32
    seeded = StreamModel(TC.get_reduced(arch), Policy(), device="cpu", generator=3).param_tree()["slots"]["s0"]
    assert seeded["moe"]["router"].dtype == torch.float32 and seeded["moe"]["w_in"].dtype == torch.bfloat16
    mp = TC.get_reduced(arch).moe
    std = float(seeded["moe"]["w_out"].float().std())
    assert abs(std - 1 / np.sqrt(mp.d_ff)) < 0.1 / np.sqrt(mp.d_ff)


@pytest.mark.parametrize("factor", [1.0, 8.0])
@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_and_loss_match_jax(arch, factor, drops):
    """Logits, the aux loss and the loss with it, against JAX's at 1e-5;
    at factor 1.0 routes drop, at 8.0 none do."""
    cfg, jm, jp, tm = _pair(arch, factor)
    toks = np.random.default_rng(31).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    lj, auxj = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    lt = tm(torch.from_numpy(toks))
    _close(lt, lj)
    assert (int(drops) > 0) == (factor == 1.0)
    (totj, mj) = jm.loss(jp, {"tokens": jnp.asarray(toks)})
    tott, mt = tm.loss(tm.param_tree(), {"tokens": torch.from_numpy(toks)})
    _close(mt["aux"], mj["aux"])
    _close(mt["aux"], auxj)
    _close(mt["loss"], mj["loss"])
    _close(tott, totj)
    assert float(mt["aux"]) > 0


@pytest.mark.parametrize("factor", [1.0, 8.0])
@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_and_decode_match_jax(arch, factor):
    """Prefill (capacity from its b*s tokens) and teacher-forced decode
    steps (from the batch's 2), logits and caches against JAX's at 1e-5."""
    cfg, jm, jp, tm = _pair(arch, factor)
    plen, gen = 14, 4
    toks = np.random.default_rng(32).integers(0, cfg.vocab, (2, plen + gen)).astype(np.int32)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :plen])}, 24, cache_dtype=jnp.float32)
    lt, ct = tm.prefill(torch.from_numpy(toks[:, :plen]), 24, cache_dtype=torch.float32)
    _close(lt, lj)
    for i in range(plen, plen + gen):
        lj, cj = jm.decode_step(jp, cj, jnp.asarray(toks[:, i : i + 1]), jnp.int32(i))
        lt, ct = tm.decode_step(ct, torch.from_numpy(toks[:, i : i + 1]))
        _close(lt, lj)
    for key in ("k", "v"):
        _close(ct["slots"]["s0"][key], cj["slots"]["s0"][key])


def test_moe_capacity_drops_are_bounded(drops):
    """Mirror of tests/test_models.py:168: reduced qwen3-moe at capacity
    factor 1.0, bf16 as there: routes drop, the loss stays finite and the
    router's aux loss is active."""
    cfg = _with_factor(TC.get_reduced("qwen3-moe-30b-a3b"), 1.0)
    m = StreamModel(cfg, Policy(), device="cpu", generator=0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 32)))
    loss, metrics = m.loss(m.param_tree(), {"tokens": toks})
    assert np.isfinite(float(loss))
    assert float(metrics["aux"]) > 0
    assert int(drops) > 0


def test_moe_greedy_tokens_identical_to_jax_engine():
    """Reduced qwen3-moe (its own factor 4.0) through both packages'
    ContinuousLMEngine: the same greedy tokens for every request (each
    decode step routes the engine's 4 slots, idle ones included)."""
    cfg, _, jp, tm = _pair("qwen3-moe-30b-a3b", JC.get_reduced("qwen3-moe-30b-a3b").moe.capacity_factor)
    jm = JModel(cfg, JPolicy(**FP32_J))
    rng = np.random.default_rng(7)
    reqs = [(i, rng.integers(0, cfg.vocab, n).astype(np.int32), int(rng.integers(3, 8)))
            for i, n in enumerate((8, 12, 8, 16, 12, 8))]
    jeng = J.ContinuousLMEngine(jm, jp, n_slots=4, n_blocks=32, block_size=8, max_blocks=8)
    teng = T.ContinuousLMEngine(tm, n_slots=4, n_blocks=32, block_size=8, max_blocks=8, device="cpu")
    for eng, req in ((jeng, J.Request), (teng, T.Request)):
        for rid, prompt, max_new in reqs:
            eng.submit(req(rid, prompt, max_new))
    want, got = dict(jeng.run_until_drained()), dict(teng.run_until_drained())
    assert sorted(got) == sorted(want) == list(range(len(reqs)))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


@pytest.mark.parametrize("arch", MOE)
def test_moe_params_round_trip_between_packages(tmp_path, arch):
    """bf16 MoE params (the router f32): JAX's checkpoint restores into the
    port's tree and loads into its model, and the port's restores in JAX,
    leaf for leaf to the bit and dtype for dtype."""
    jm = JModel(JC.get_reduced(arch), JPolicy())
    jp = jax.jit(jm.init)(jax.random.PRNGKey(2))
    jck.save(str(tmp_path / "jax"), 1, {"params": jp})
    tm = StreamModel(TC.get_reduced(arch), Policy(), device="cpu", generator=None)
    state, _, _ = ck.restore(str(tmp_path / "jax"), {"params": tm.param_tree()})
    tm.load_params(state["params"])
    flat_j = _flat(jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
    flat_t = _flat(convert.params_to_numpy(tm.param_tree()))
    assert set(flat_j) == set(flat_t)
    for path, leaf in flat_j.items():
        np.testing.assert_array_equal(flat_t[path], leaf, err_msg=str(path))
    mgr = ck.CheckpointManager(str(tmp_path / "port"))
    mgr.save_async(1, {"params": tm.param_tree()})
    mgr.wait()
    back, _, _ = jck.restore(str(tmp_path / "port"), {"params": jax.eval_shape(lambda: jp)})
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back["params"])[0],
                                 jax.tree_util.tree_flatten_with_path(jp)[0]):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32), err_msg=str(path))


# ------------------------------------------------------------------ training
def _frozen_local_moe(x2, probs, w_in, w_gate, w_out, *, mp, capacity):
    """``_local_moe`` as it stood before the training adjoint existed (the
    plain gather and combine, kept here as the serving path's yardstick)."""
    t, d = x2.shape
    e, k = w_in.shape[0], mp.top_k
    topw, tope = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, tope = topw[:, :k], tope[:, :k]
    topw = topw / topw.sum(dim=-1, keepdim=True)
    flat_e, flat_w = tope.reshape(-1), topw.reshape(-1)
    flat_tok = torch.arange(t).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    first = torch.searchsorted(e_sorted, e_sorted, side="left")
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * k) - first
    keep = rank < capacity
    slot = torch.where(keep, flat_e * capacity + rank, e * capacity)
    slot_tok = torch.full((e * capacity + 1,), t, dtype=torch.long)
    slot_tok[slot] = torch.where(keep, flat_tok, t)
    x2p = torch.cat([x2, x2.new_zeros((1, d))])
    xe = x2p[slot_tok[:-1]].reshape(e, capacity, d)
    h = torch.bmm(xe, w_in.to(xe.dtype))
    g = torch.bmm(xe, w_gate.to(xe.dtype))
    ye = torch.bmm(torch.nn.functional.silu(g) * h, w_out.to(xe.dtype))
    ye_flat = torch.cat([ye.reshape(e * capacity, d), ye.new_zeros((1, d))])
    contrib = (ye_flat[slot] * (flat_w * keep).to(ye.dtype)[:, None]).reshape(t, k, d)
    out = torch.zeros((t, d), dtype=ye.dtype)
    for j in range(k):
        out = out + contrib[:, j]
    return out


def _ffn_inputs(dtype, seed=4, d=32, e=8, f=24, tokens=(2, 24), dyadic=False):
    """A layer's MoE leaves and tokens; with ``dyadic`` every value a
    multiple of 1/64 in [-2, 2], so that sums of a few are exact in f32."""
    rng = np.random.default_rng(seed)

    def draw(*shape, scale=1.0):
        a = rng.standard_normal(shape) * scale
        return torch.from_numpy(np.round(a * 64) / 64 if dyadic else a).to(dtype)

    p = {"router": draw(d, e, scale=d ** -0.5).float(), "w_in": draw(e, d, f, scale=d ** -0.5),
         "w_gate": draw(e, d, f, scale=d ** -0.5), "w_out": draw(e, f, d, scale=f ** -0.5)}
    return p, draw(*tokens, d)


@pytest.mark.parametrize("factor", [1.0, 8.0])
def test_gather_adjoints_match_autograd_and_repeat(factor, drops, monkeypatch):
    """The dispatch's and the combine's hand-written adjoints
    (``_PadGather``: each token's k slot rows added in route order; each
    slot's one route row) against autograd through the plain gathers
    (scatter-adds): with every value dyadic the sums are exact, so the
    two agree to the bit; on random inputs, within f32 rounding (1e-6 of
    the largest element). Repeated calls give the same bits. At factor
    1.0 routes drop and read the pad row."""
    mp = TM.MoEParams(n_experts=8, top_k=2, d_ff=24, capacity_factor=factor)

    def grads(p, x, plain: bool):
        if plain:
            monkeypatch.setattr(TM, "_gather", lambda src, idx, adj, k: TM._pad(src)[idx])
        leaves = {"x": x, **p}
        t = {n: v.clone().requires_grad_(True) for n, v in leaves.items()}
        out, aux = TM.moe_ffn({n: t[n] for n in p}, t["x"], mp)
        dot = torch.from_numpy(np.random.default_rng(9).standard_normal(out.shape)).to(out.dtype)
        g = torch.autograd.grad((out * dot).sum() + aux, list(t.values()))
        monkeypatch.undo()
        return dict(zip(t, g))

    for dyadic in (True, False):
        p, x = _ffn_inputs(torch.float32, dyadic=dyadic)
        got, again, want = grads(p, x, False), grads(p, x, False), grads(p, x, True)
        for n in got:
            assert torch.equal(got[n], again[n]), n
            if dyadic and n in ("x", "w_out"):  # the dispatch's and the combine's adjoints alone
                assert torch.equal(got[n], want[n])
            else:
                _close(got[n], want[n].numpy(), tol=1e-6 * float(want[n].abs().max()))
    assert (int(drops) > 0) == (factor == 1.0)


def test_gather_adjoints_route_through_the_function():
    """Under grad mode the dispatch and the combine are ``_PadGather``s;
    without it the plain gathers (serving's code)."""
    p, x = _ffn_inputs(torch.float32)
    mp = TM.MoEParams(n_experts=8, top_k=2, d_ff=24)
    out, _ = TM.moe_ffn(p, x.clone().requires_grad_(True), mp)
    seen, stack = {}, [out.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is not None and id(fn) not in seen:
            seen[id(fn)] = fn
            stack.extend(nxt for nxt, _ in fn.next_functions)
    names = [type(fn).__name__ for fn in seen.values()]
    assert names.count("_PadGatherBackward") == 2
    with torch.no_grad():
        assert TM.moe_ffn(p, x.clone().requires_grad_(True), mp)[0].grad_fn is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("factor", [1.0, 8.0])
def test_serving_moe_bits_unchanged(factor, dtype):
    """Serving's MoE output (grad mode off) equals, bit for bit, the
    forward as it stood before the training adjoint (``_frozen_local_moe``),
    in f32 and bf16, with drops and without; the forward under grad mode
    gives those bits too."""
    mp = TM.MoEParams(n_experts=8, top_k=2, d_ff=24, capacity_factor=factor)
    p, x = _ffn_inputs(dtype, seed=5)
    with torch.no_grad():
        probs = torch.softmax((x @ p["router"].to(dtype)).float(), -1).reshape(-1, 8)
        want = _frozen_local_moe(x.reshape(-1, 32), probs, p["w_in"], p["w_gate"], p["w_out"], mp=mp,
                                 capacity=TM._capacity(mp, 48)).reshape(x.shape)
        got, _ = TM.moe_ffn(p, x, mp)
    assert torch.equal(got, want)
    trained, _ = TM.moe_ffn(p, x.clone().requires_grad_(True), mp)
    assert torch.equal(trained.detach(), want)


def test_routes_given_reproduce_the_call():
    """``moe_routes`` gives the ids a call routes by; handed back through
    ``routes`` they give the call's output and gradients to the bit, and a
    float64 run routed alike stays within f32 rounding of the f32 one."""
    mp = TM.MoEParams(n_experts=8, top_k=2, d_ff=24, capacity_factor=1.0)
    p, x = _ffn_inputs(torch.float32, seed=6)
    routes = TM.moe_routes(p, x, mp)
    assert routes.shape == (48, 2) and routes.dtype == torch.long

    def run(p, x, routes=None):
        t = {n: v.clone().requires_grad_(True) for n, v in {"x": x, **p}.items()}
        out, aux = TM.moe_ffn({n: t[n] for n in p}, t["x"], mp, routes=routes)
        return out.detach(), torch.autograd.grad(out.sum() * 0.5 + aux, list(t.values()))

    out, g = run(p, x)
    out_r, g_r = run(p, x, routes)
    assert torch.equal(out, out_r) and all(torch.equal(a, b) for a, b in zip(g, g_r))
    out64, g64 = run({n: v.double() for n, v in p.items()}, x.double(), routes)
    assert out64.dtype == torch.float64
    _close(out, out64.float().numpy(), tol=1e-5)
    for a, b in zip(g, g64):
        assert float((a.double() - b).abs().max() / b.abs().max()) < 1e-5
