"""Quantized serving in the port against the JAX package: int8 weights and
the fp8 KV cache (port of tests/test_quantized_serving.py, and more).

int8: ``quantize_params`` bit for bit against JAX's on leaves below, at
and above the 64Ki threshold (an (L, d) norm and an f32 router among
them); the set of quantized leaves at full width for every config the
port registers; the mirrors of the JAX file's tests; a mid-size MoE
config whose expert and attention leaves do quantize, its int8 forward
against JAX's at 1e-5, its greedy tokens through both packages' engines
and its int8 tree through both packages' checkpoints. fp8: the cast over
every bf16 value against JAX's, bit for bit; the mirror of the JAX
file's decode consistency; decode on an fp8 cache against JAX's at 1e-5
in the lockstep, per-row, ring and paged layouts; the engines keep their
f32 cache.
"""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import layers as JL
from repro.models import model as JMOD
from repro.models.model import StreamModel as JModel
from repro.models.policy import Policy as JPolicy
from repro.serve import lm_engine as J
from repro.train import checkpoint as jck
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.models import layers as TL
from repro_torch.models.model import ArchConfig, StreamModel, quantize_params
from repro_torch.models.moe import MoEParams
from repro_torch.models.policy import Policy
from repro_torch.serve import lm_engine as T
from repro_torch.train import checkpoint as ck

TOL = 1e-5
FP8 = torch.float8_e4m3fn
FP32_J = dict(param_dtype="float32", compute_dtype="float32")
FP32_T = Policy("float32", "float32", "float32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models are small: torch's thread pool only contends with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


def jitted(jm):
    """JAX's entry points, each compiled once (faster here than eager)."""
    return SimpleNamespace(
        forward=jax.jit(jm.forward), decode_step=jax.jit(jm.decode_step),
        prefill=jax.jit(jm.prefill, static_argnums=2, static_argnames="cache_dtype"),
    )


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def _jax_bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint8)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy()


# --------------------------------------------------------------------- fp8 cast
def test_fp8_cast_matches_jax_on_every_bf16_value():
    """All 65,536 bf16 bit patterns (NaNs and infinities among them) cast
    into a float8_e4m3fn cache: JAX's bits, NaN of the value's sign past
    464 where a plain torch cast saturates to 448."""
    bits = np.arange(1 << 16, dtype=np.uint16)
    want = _jax_bits(jnp.asarray(bits.view(ml_dtypes.bfloat16)).astype(jnp.float8_e4m3fn))
    x = torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)
    got = _bits(TL.to_cache(x, FP8))
    np.testing.assert_array_equal(got, want)
    over = x.float().abs() > 464
    assert int(over.sum()) == 30512  # 30,510 finite values and the two infinities
    assert not np.array_equal(_bits(x.to(FP8)), want)  # the plain cast is not JAX's
    assert torch.isnan(TL.to_cache(x, FP8)[over].float()).all()


def test_fp8_cast_matches_jax_on_f32():
    """f32 values (what an f32 model's K/V are) around every boundary."""
    edge = np.array([448, 463.99997, 464, 464.00003, 480, 1e30, np.inf, -np.inf, np.nan, 0.0, -0.0,
                     2.0**-9, 2.0**-10, 2.0**-7 * 1.0625, 1e-30], np.float32)
    rng = np.random.default_rng(1)
    x = np.concatenate([edge, -edge, rng.standard_normal(200_000).astype(np.float32)
                        * np.exp(rng.uniform(-12, 7, 200_000)).astype(np.float32)])
    want = _jax_bits(jnp.asarray(x).astype(jnp.float8_e4m3fn))
    np.testing.assert_array_equal(_bits(TL.to_cache(torch.from_numpy(x), FP8)), want)


# ----------------------------------------------------------------------- int8
def _mixed_tree():
    """Leaves below, at and above 64Ki elements in each quantized subtree,
    an (L, d) bf16 norm and an f32 router, a row of zeros, values at half
    a code (round half to even), and the embeddings outside."""
    rng = np.random.default_rng(2)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    halves = f32(2, 128, 256)
    halves[0, 0, :] = np.arange(256) % 16 - 7.5  # max 8.5 -> scale 8.5/127
    halves[0, 1, :] = 0.0
    halves[1, 0, :4] = [127.0, 2.5, -3.5, 0.5]
    tree = {
        "embed": f32(512, 256).astype(ml_dtypes.bfloat16),
        "final_norm": {"w": np.ones((1, 256), ml_dtypes.bfloat16)},
        "slots": {"s0": {
            "norm1": {"w": (1 + 0.1 * f32(256, 256)).astype(ml_dtypes.bfloat16)},  # (L, d) at 64Ki
            "below": {"w": f32(255, 257)},  # 65535
            "at": {"w": halves},  # 65536 twice
            "above": {"w": f32(1, 65537).astype(ml_dtypes.bfloat16)},
            "moe": {"router": f32(4, 128, 128), "w_in": f32(4, 8, 64, 32).astype(ml_dtypes.bfloat16)},
            "bias": {"b": f32(1 << 17)},  # 1-d: never
        }},
        "tail": {"s0": {"norm2": {"w": f32(1, 70000)}, "small": {"w": f32(1, 64, 64)}}},
        "unembed": f32(256, 512),
    }
    return tree


def test_quantize_params_bit_equal_to_jax():
    tree = _mixed_tree()
    want = _flat(JMOD.quantize_params(jax.tree.map(jnp.asarray, tree)))
    got = _flat(quantize_params(convert.params_from_jax(tree)))
    assert set(got) == set(want)
    q8 = {tuple(getattr(k, "key", k) for k in p[:-1]) for p in want if getattr(p[-1], "key", None) == "q8"}
    assert q8 == {("slots", "s0", "norm1", "w"), ("slots", "s0", "at", "w"), ("slots", "s0", "above", "w"),
                  ("slots", "s0", "moe", "router"), ("slots", "s0", "moe", "w_in"), ("tail", "s0", "norm2", "w")}
    for path, leaf in want.items():
        leaf = np.asarray(leaf)
        t = got[path]
        assert str(t.dtype).removeprefix("torch.") == leaf.dtype.name, path
        if t.dtype == torch.bfloat16:
            t = t.float()
            leaf = leaf.astype(np.float32)
        np.testing.assert_array_equal(t.numpy().view(np.uint8), leaf.view(np.uint8), err_msg=str(path))


@pytest.mark.parametrize("arch", TC.names())
def test_quantized_leaves_at_full_width_match_jax(arch):
    """Full-width configs, shapes only (``jax.eval_shape`` against the
    port's model on the meta device): an int8 model holds ``{q8, scale}``
    exactly where JAX's ``quantize_params`` puts them, with JAX's shapes
    and dtypes (qwen3-moe's (48, 2048) norms and f32 router among them)."""
    jm = JModel(JC.get(arch), JPolicy())
    want = _flat(jax.eval_shape(JMOD.quantize_params, jax.eval_shape(lambda: jax.jit(jm.init)(jax.random.PRNGKey(0)))))
    tm = StreamModel(TC.get(arch), Policy(weights_int8=True), device="meta", generator=None)
    got = _flat(tm.param_tree())
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == tuple(leaf.shape), path
        assert str(got[path].dtype).removeprefix("torch.") == leaf.dtype.name, path
    assert all(b.dtype in (torch.int8, torch.float32) for b in tm.buffers())
    if arch == "qwen3-moe-30b-a3b":
        codes = sum(b.numel() for n, b in tm.named_buffers() if n.endswith(".q8"))
        experts, attn = 48 * 128 * 3 * 2048 * 768, 48 * 2048 * (32 + 4 + 4 + 32) * 128
        assert codes == experts + attn + 2 * 48 * 2048 + 48 * 2048 * 128  # every slot leaf: norms and router too
        assert ("slots", "s0", "norm1", "w", "q8") in {tuple(k.key for k in p) for p in got}


@pytest.mark.parametrize("aid", ["qwen2-7b", "arctic-480b", "mistral-large-123b"])
def test_int8_ptq_preserves_predictions(aid):
    """Mirror of tests/test_quantized_serving.py:23 (bf16, MoE at factor
    8.0). At these reduced sizes no leaf reaches the threshold, as there."""
    cfg = TC.get_reduced(aid)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    m = StreamModel(cfg, Policy(), device="cpu", generator=0)
    mq = StreamModel(cfg, Policy(weights_int8=True), device="cpu", generator=None)
    mq.load_params(quantize_params(m.param_tree()))
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 32)))
    pf, pq = torch.softmax(m(toks), -1), torch.softmax(mq(toks), -1)
    tv = float(0.5 * (pf - pq).abs().sum(-1).mean())
    assert tv < 0.05, tv
    assert float((pf.argmax(-1) == pq.argmax(-1)).float().mean()) > 0.9


def test_int8_codes_are_int8_and_smaller():
    """Mirror of tests/test_quantized_serving.py:55 on the same mid-size config."""
    cfg = ArchConfig(name="q8t", d_model=512, n_layers=2, n_heads=8, n_kv_heads=4, d_ff=1024, vocab=512)
    m = StreamModel(cfg, Policy(), device="cpu", generator=0)
    q = quantize_params(m.param_tree())
    leaves = lambda t: [x for x in jax.tree.leaves(t)]  # noqa: E731
    raw_bytes = sum(x.numel() * x.element_size() for x in leaves(m.param_tree()))
    q_bytes = sum(x.numel() * x.element_size() for x in leaves(q))
    assert q_bytes < raw_bytes * 0.7
    assert torch.int8 in {x.dtype for x in leaves(q["slots"]) if x.dim() >= 3}
    mq = StreamModel(cfg, Policy(weights_int8=True), device="cpu", generator=None)
    mq.load_params(q)
    own = sum(x.numel() * x.element_size() for x in list(mq.parameters()) + list(mq.buffers()))
    assert own == q_bytes


# a mid-size MoE config whose expert, attention (and arctic-style dense
# MLP) leaves reach the threshold; its norms and router stay float
MID = dict(name="moe-mid", d_model=256, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=256, vocab=256)


def _mid(jax_side: bool, dense: bool, factor: float = 1.25):
    mp = dict(n_experts=8, top_k=2, d_ff=64, capacity_factor=factor, dense_residual=dense)
    if jax_side:
        from repro.models.model import ArchConfig as JArch
        from repro.models.moe import MoEParams as JMoE

        return JArch(**MID, moe=JMoE(**mp))
    return ArchConfig(**MID, moe=MoEParams(**mp))


@functools.lru_cache(maxsize=None)
def _mid_pair(dense: bool):
    jcfg = _mid(True, dense)
    jp = jax.jit(JModel(jcfg, JPolicy(**FP32_J)).init)(jax.random.PRNGKey(4))
    jq = JMOD.quantize_params(jp)
    jmq = JModel(jcfg, JPolicy(**FP32_J, weights_int8=True))
    tmq = StreamModel(_mid(False, dense), dataclasses.replace(FP32_T, weights_int8=True), device="cpu",
                      generator=None)
    tmq.load_params(convert.params_from_jax(jax.tree.map(np.asarray, jq)))
    return jcfg, jmq, jq, tmq, jitted(jmq)


@pytest.mark.parametrize("dense", [False, True])
def test_int8_forward_of_mid_size_moe_matches_jax(dense):
    jcfg, jmq, jq, tmq, jj = _mid_pair(dense)
    blk = tmq.param_tree()["slots"]["s0"]
    assert {k for k, v in blk["mixer"].items() if isinstance(v, dict)} == {"wq", "wk", "wv", "wo"}
    assert {k for k, v in blk["moe"].items() if isinstance(v, dict)} == {"w_in", "w_gate", "w_out"}
    assert isinstance(blk["moe"]["router"], torch.Tensor) and isinstance(blk["norm2"]["w"], torch.Tensor)
    if dense:
        assert all(isinstance(v, dict) for v in blk["mlp"].values())
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 40)).astype(np.int32)
    lj, auxj = jj.forward(jq, {"tokens": jnp.asarray(toks)})
    lt = tmq(torch.from_numpy(toks))
    _close(lt, lj)
    _, mt = tmq.loss(tmq.param_tree(), {"tokens": torch.from_numpy(toks)})
    _close(mt["aux"], auxj)


def test_int8_seeded_init_draws_layer_by_layer():
    """An int8 model's own init: codes and scales at every quantized leaf,
    dequantized at the JAX init's scales (1/sqrt(fan_in)); ones quantize
    to 127 codes of scale 1/127."""
    cfg = dataclasses.replace(_mid(False, True), n_layers=4, d_model=256)
    m = StreamModel(cfg, Policy(weights_int8=True), device="cpu", generator=1)
    blk = m.param_tree()["slots"]["s0"]
    w_out = blk["moe"]["w_out"]
    deq = w_out["q8"].float() * w_out["scale"]
    assert abs(float(deq.std()) - 1 / np.sqrt(64)) < 0.1 / np.sqrt(64)
    assert not torch.equal(w_out["q8"][0], w_out["q8"][1])  # each layer its own draw
    assert float(w_out["q8"].abs().amax(-1).min()) == 127
    big = dataclasses.replace(cfg, n_layers=256)  # (256, 256) norms reach 64Ki
    nb = StreamModel(big, Policy(weights_int8=True), device="meta", generator=None).param_tree()
    assert set(nb["slots"]["s0"]["norm1"]["w"]) == {"q8", "scale"}


@pytest.mark.parametrize("kind", ["continuous", "wave"])
def test_int8_moe_greedy_tokens_identical_to_jax(kind):
    """The int8 mid-size MoE behind each engine of both packages: the same
    greedy tokens (the engines need no change for int8 or MoE)."""
    jcfg, jmq, jq, tmq, jj = _mid_pair(False)
    rng = np.random.default_rng(8)
    reqs = [(i, rng.integers(0, jcfg.vocab, n).astype(np.int32), 5) for i, n in enumerate((8, 8, 12, 12, 12))]
    if kind == "continuous":
        jeng = J.ContinuousLMEngine(jmq, jq, n_slots=2, n_blocks=16, block_size=8, max_blocks=4)
        teng = T.ContinuousLMEngine(tmq, n_slots=2, n_blocks=16, block_size=8, max_blocks=4, device="cpu")
    else:
        jeng = J.LMEngine(jmq, jq, n_slots=2, s_cache=24)
        teng = T.LMEngine(tmq, n_slots=2, s_cache=24, device="cpu")
    for eng, req in ((jeng, J.Request), (teng, T.Request)):
        for rid, prompt, max_new in reqs:
            eng.submit(req(rid, prompt, max_new))
    want, got = dict(jeng.run_until_drained()), dict(teng.run_until_drained())
    assert sorted(got) == sorted(want) == list(range(len(reqs)))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_int8_params_round_trip_between_packages(tmp_path):
    """JAX's ``quantize_params`` tree through JAX's checkpoint restores into
    the int8 model's tree (int8 codes, f32 scales) and back, to the bit."""
    _, _, jq, tmq, _ = _mid_pair(True)
    jck.save(str(tmp_path / "jax"), 1, {"params": jq})
    tm = StreamModel(_mid(False, True), dataclasses.replace(FP32_T, weights_int8=True), device="cpu",
                     generator=None)
    state, _, _ = ck.restore(str(tmp_path / "jax"), {"params": tm.param_tree()})
    tm.load_params(state["params"])
    want = _flat(jax.tree.map(np.asarray, jq))
    got = _flat(convert.params_to_numpy(tm.param_tree()))
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))
    mgr = ck.CheckpointManager(str(tmp_path / "port"))
    mgr.save_async(1, {"params": tm.param_tree()})
    mgr.wait()
    back, _, _ = jck.restore(str(tmp_path / "port"), {"params": jax.eval_shape(lambda: jq)})
    for path, leaf in _flat(back["params"]).items():
        assert np.asarray(leaf).dtype == want[path].dtype
        np.testing.assert_array_equal(np.asarray(leaf), want[path], err_msg=str(path))


# ------------------------------------------------------------------ fp8 cache
def test_fp8_kv_cache_decode_consistency():
    """Mirror of tests/test_quantized_serving.py:72: reduced yi-6b, bf16,
    an fp8 cache's first decode step against the full forward."""
    cfg = TC.get_reduced("yi-6b")
    m = StreamModel(cfg, Policy(), device="cpu", generator=0)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (2, 32)))
    lf = m(toks)
    _, cache = m.prefill(toks[:, :-1], 40, cache_dtype=FP8)
    assert cache["slots"]["s0"]["k"].dtype == FP8
    step, _ = m.decode_step(cache, toks[:, -1:])
    assert float((step[:, 0].argmax(-1) == lf[:, -1].argmax(-1)).float().mean()) >= 0.5
    assert torch.isfinite(step).all()


# reduced yi-6b with its layers local and global in turn (window 16): the
# ring layout at yi-6b's f32 agreement with JAX
LOCAL = {"pattern": ("local", "attn"), "window": 16}


@functools.lru_cache(maxsize=None)
def _f32_pair(arch):
    change = LOCAL if arch == "yi-6b-local" else {}
    arch = arch.removesuffix("-local")
    cfg = dataclasses.replace(JC.get_reduced(arch), **change)
    jm = JModel(cfg, JPolicy(**FP32_J))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = StreamModel(dataclasses.replace(TC.get_reduced(arch), **change), FP32_T, device="cpu", generator=None)
    tm.load_params(convert.params_from_jax(jax.tree.map(np.asarray, jp)))
    return cfg, jm, jp, tm, jitted(jm)


def _check_cache(ct, cj, codes_off: bool = False):
    """Every cache leaf: an fp8 K/V to the bit (with ``codes_off``, a value
    may be one code from JAX's, of the same sign, in at most 1 of 500),
    the rest at 1e-5."""
    fj = _flat(cj)
    ft = _flat({sec: {n: dict(st) for n, st in slots.items()} for sec, slots in ct.items()})
    assert set(fj) == set(ft)
    for path, leaf in fj.items():
        t = ft[path]
        if t.dtype != FP8:
            _close(t, leaf)
        elif not codes_off:
            np.testing.assert_array_equal(_bits(t), _jax_bits(leaf), err_msg=str(path))
        else:
            a, b = _bits(t).astype(np.int16), _jax_bits(leaf).astype(np.int16)
            assert (np.abs(a - b) <= 1).all() and ((a ^ b) & 0x80 == 0).all(), path
            assert (a != b).mean() <= 1 / 500, path


def _cache_from_jax(cj) -> dict:
    """A JAX cache as the port's: fp8 K/V by their bits, the rest as is."""
    def one(a):
        a = np.asarray(a)
        if a.dtype == np.dtype(ml_dtypes.float8_e4m3fn):
            return torch.from_numpy(a.view(np.uint8).copy()).view(FP8)
        return torch.from_numpy(a.copy())

    return {sec: {n: {k: one(v) for k, v in st.items()} for n, st in slots.items()} for sec, slots in cj.items()}


@pytest.mark.parametrize("arch", ["yi-6b", "yi-6b-local", "gemma2-2b"])
def test_fp8_decode_matches_jax_lockstep_and_ring(arch):
    """Prefill into an fp8 cache and teacher-forced decode steps, in the
    lockstep layout (yi-6b) and the ring of local layers (a prompt past
    the window of 16, decode past the ring's wrap): the fp8 K/V bit for
    bit and the logits at 1e-5 against JAX's same calls.

    gemma2-2b's logits sit up to 1.7e-5 from JAX's with an f32 cache too,
    and a K value that close to a rounding midpoint takes the next fp8
    code, after which the two runs differ by that code. So gemma2 is held
    at its prefill tolerance of tests/test_torch_models.py (3e-4), its
    fp8 codes within one of JAX's, and each decode step starts from JAX's
    cache, bit for bit."""
    gemma2 = arch == "gemma2-2b"
    tol = 3e-4 if gemma2 else TOL
    cfg, _, jp, tm, jm = _f32_pair(arch)
    plen, gen = 20, 5
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, plen + gen)).astype(np.int32)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :plen])}, 32, cache_dtype=jnp.float8_e4m3fn)
    lt, ct = tm.prefill(torch.from_numpy(toks[:, :plen]), 32, cache_dtype=FP8)
    if arch != "yi-6b":
        assert ct["slots"]["s0"]["k"].shape[2] == cfg.window < plen
    _close(lt, lj, tol)
    _check_cache(ct, cj, codes_off=gemma2)
    for i in range(plen, plen + gen):
        if gemma2:
            ct = _cache_from_jax(cj)
        lj, cj = jm.decode_step(jp, cj, jnp.asarray(toks[:, i : i + 1]), jnp.int32(i))
        lt, ct = tm.decode_step(ct, torch.from_numpy(toks[:, i : i + 1]))
        _close(lt, lj, tol)
    _check_cache(ct, cj, codes_off=gemma2)


def test_fp8_decode_attention_per_row_matches_jax():
    """The per-row layout (a position a row) on fp8 caches, one layer."""
    cfg, jm, jp, tm, _ = _f32_pair("yi-6b")
    jblk = jax.tree.map(lambda a: a[0], jp["slots"]["s0"])
    tblk = convert.params_from_jax(jax.tree.map(np.asarray, jblk))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    ck8 = (rng.standard_normal((3, 20, 2, 16)) * 3).astype(ml_dtypes.float8_e4m3fn)
    cv8 = (rng.standard_normal((3, 20, 2, 16)) * 3).astype(ml_dtypes.float8_e4m3fn)
    pos = np.array([4, 11, 19], np.int32)
    yj, kj, vj = JL.decode_attention(jblk["mixer"], jnp.asarray(x), jnp.asarray(ck8), jnp.asarray(cv8),
                                     jnp.asarray(pos), cfg.attn_params("attn"), jm.policy)
    tk = torch.from_numpy(ck8.view(np.uint8).copy()).view(FP8)
    tv = torch.from_numpy(cv8.view(np.uint8).copy()).view(FP8)
    yt, kt, vt = TL.decode_attention(tblk["mixer"], torch.from_numpy(x), tk, tv, torch.from_numpy(pos),
                                     tm.cfg.attn_params("attn"))
    assert kt is tk and vt is tv
    _close(yt, yj)
    np.testing.assert_array_equal(_bits(kt), _jax_bits(kj))
    np.testing.assert_array_equal(_bits(vt), _jax_bits(vj))


def test_fp8_paged_decode_matches_jax():
    """The paged layout as the continuous engine drives it, on an fp8 pool
    built from ``Policy(kv_cache_dtype="float8_e4m3fn")``: each row
    prefilled alone into an fp8 cache, admitted by ``paged_insert``, then
    decoded at per-row positions; logits at 1e-5 and the pool bit for bit
    against JAX's same calls."""
    cfg, _, jp, _, _ = _f32_pair("yi-6b")
    jm8 = JModel(cfg, JPolicy(**FP32_J, kv_cache_dtype="float8_e4m3fn"))
    j8 = jitted(jm8)
    tm = StreamModel(TC.get_reduced("yi-6b"), dataclasses.replace(FP32_T, kv_cache_dtype="float8_e4m3fn"),
                     device="cpu", generator=None)
    tm.load_params(convert.params_from_jax(jax.tree.map(np.asarray, jp)))
    blk, max_blocks, n_blocks, gen = 4, 5, 12, 4
    lens = (5, 9)
    rng = np.random.default_rng(8)
    seqs = [rng.integers(0, cfg.vocab, n + gen).astype(np.int32) for n in lens]
    cj = jm8.init_paged_cache(2, n_blocks, blk, max_blocks)
    ct = tm.init_paged_cache(2, n_blocks, blk, max_blocks)
    assert ct["slots"]["s0"]["k"].dtype == FP8 and cj["slots"]["s0"]["k"].dtype == jnp.float8_e4m3fn
    tables = ([1, 2, 3, 0, 0], [4, 5, 6, 7, 0])
    for row, (n, seq, table) in enumerate(zip(lens, seqs, tables)):
        ids = [b for b in table if b][: -(-(n + gen) // blk)]
        lj, small_j = j8.prefill(jp, {"tokens": jnp.asarray(seq[None, :n])}, len(ids) * blk,
                                  cache_dtype=jnp.float8_e4m3fn)
        lt, small_t = tm.prefill(torch.from_numpy(seq[None, :n]), len(ids) * blk, cache_dtype=FP8)
        _close(lt, lj)
        cj = jm8.paged_insert(cj, small_j, row, jnp.asarray(ids), jnp.asarray(table, jnp.int32), n)
        ct = tm.paged_insert(ct, small_t, row, ids, table, n)
    for i in range(gen):
        tok = np.array([[s[n + i]] for n, s in zip(lens, seqs)], np.int32)
        lj, cj = j8.decode_step(jp, cj, jnp.asarray(tok), jnp.asarray([n + i for n in lens], jnp.int32))
        lt, ct = tm.decode_step(ct, torch.from_numpy(tok))
        _close(lt, lj)
    for key in ("k", "v"):  # block 0 is the scratch of idle rows: none here
        np.testing.assert_array_equal(_bits(ct["slots"]["s0"][key]), _jax_bits(cj["slots"]["s0"][key]))


def test_fp8_policy_caches_and_f32_engines():
    """``Policy.kv_cache_dtype`` gives fp8 K/V for attention and local
    layers (recurrentgemma's RG-LRU and mamba2's SSM states stay f32, as in
    JAX); both engines still build f32 caches under it."""
    pol = Policy(kv_cache_dtype="float8_e4m3fn")
    rg = StreamModel(TC.get_reduced("recurrentgemma-9b"), pol, device="cpu", generator=None).init_cache(2, 8)
    dtypes = {(name, k): v.dtype for name, st in rg["slots"].items() for k, v in st.items()}
    assert {dt for (_, k), dt in dtypes.items() if k in ("k", "v")} == {FP8}
    assert {dt for (_, k), dt in dtypes.items() if k in ("conv", "h")} == {torch.float32}
    m2 = StreamModel(TC.get_reduced("mamba2-2.7b"), pol, device="cpu", generator=None).init_cache(2, 8)
    assert {v.dtype for v in m2["slots"]["s0"].values() if v.is_floating_point()} == {torch.float32}

    cfg = TC.get_reduced("yi-6b")
    m = StreamModel(cfg, dataclasses.replace(pol, param_dtype="float32", compute_dtype="float32"), device="cpu",
                    generator=0)
    assert m.init_cache(1, 8)["slots"]["s0"]["k"].dtype == FP8
    seen = []
    prefill = m.prefill

    def spy(tokens, s_cache, cache_dtype=torch.bfloat16):
        seen.append(cache_dtype)
        return prefill(tokens, s_cache, cache_dtype=cache_dtype)

    m.prefill = spy
    cont = T.ContinuousLMEngine(m, n_slots=2, n_blocks=8, block_size=8, max_blocks=3, device="cpu")
    wave = T.LMEngine(m, n_slots=2, s_cache=24, device="cpu")
    assert cont.caches["slots"]["s0"]["k"].dtype == torch.float32
    for eng in (cont, wave):
        eng.submit(T.Request(0, np.random.default_rng(9).integers(0, cfg.vocab, 8).astype(np.int32), 3))
        eng.run_until_drained()
    assert seen == [torch.float32, torch.float32]
