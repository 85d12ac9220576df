"""The port's RG-LRU scan, mixer, ring cache, recurrentgemma model and engines
against the JAX package's.

On the CPU the port's ``rglru_op`` computes the plain version of its kernel
(``ref.rglru``); the JAX ``rglru_op`` runs its Pallas kernel in interpret
mode, as tests/test_kernels.py runs it. Inputs come from numpy seeds and
weights are moved with ``convert.params_from_jax``. The model is reduced
recurrentgemma (pattern ("rec", "rec", "local"), 5 layers: one group and a
tail of two, window 16) in f32. Tolerances:

- the scan: 1e-5 (atol and rtol), tests/test_kernels.py:86's, against the
  JAX kernel, ``ref.rglru`` and the model's associative scan;
- the mixer and decode attention: 1e-5; logits and caches: 1e-4, as the
  dense and Mamba-2 parity tests hold them;
- greedy tokens and served records: identical.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_kernels_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.core as jcore
from repro.kernels import ref as jref
from repro.kernels.ops import rglru_op as jax_rglru_op
from repro.models import layers as JL
from repro.models import rglru as JR
from repro.models.model import StreamModel as JModel
from repro.models.policy import Policy as JPolicy
from repro.serve import lm_engine as J
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.core.log import StreamLog
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as K3
from repro_torch.kernels.ops import rglru_op
from repro_torch.models import layers as TL
from repro_torch.models import rglru as TR
from repro_torch.models.model import StreamModel
from repro_torch.models.policy import Policy
from repro_torch.serve import lm_engine as T

ARCH = "recurrentgemma-9b"
ATOL = 1e-5
PLEN, GEN, S_CACHE = 24, 8, 40  # 24 > the reduced window of 16: the ring rolls and wraps


def _scan_inputs(seed, b, s, c, h0=True, scale=0.3):
    """x, log_a = -|N| * scale (tests/test_kernels.py:81's decays) and h0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    log_a = (-np.abs(rng.standard_normal((b, s, c))) * scale).astype(np.float32)
    return x, log_a, rng.standard_normal((b, c)).astype(np.float32) if h0 else None


def _port_scan(x, log_a, h0=None):
    h, hl = rglru_op(torch.from_numpy(x), torch.from_numpy(log_a), None if h0 is None else torch.from_numpy(h0))
    assert h.dtype == hl.dtype == torch.float32
    return h.numpy(), hl.numpy()


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=atol)


# ------------------------------------------------------------------ the scan
def test_ref_rglru_matches_jax_ref():
    """The two sequential oracles (both the a * a form), with h0."""
    x, log_a, h0 = _scan_inputs(0, 2, 37, 24)
    hj, lj = jref.rglru(jnp.asarray(x), jnp.asarray(log_a), jnp.asarray(h0))
    ht, lt = ref.rglru(*(torch.from_numpy(a) for a in (x, log_a, h0)))
    _close(ht, hj)
    _close(lt, lj)


@pytest.mark.parametrize("b,s,c,t", [(1, 128, 64, 32), (2, 256, 128, 64), (3, 64, 256, 64)])
def test_rglru_op_matches_jax_rglru_op(b, s, c, t):
    """tests/test_kernels.py:77's shapes and decays, with h0, against the
    JAX kernel in interpret mode (whose time block ``t`` divides S)."""
    x, log_a, h0 = _scan_inputs(s + c, b, s, c)
    hj, lj = jax_rglru_op(jnp.asarray(x), jnp.asarray(log_a), jnp.asarray(h0), t_block=t)
    ht, lt = _port_scan(x, log_a, h0)
    _close(ht, hj)
    _close(lt, lj)


def test_rglru_op_matches_model_scan_ragged():
    """S = 50 divides no time block (the JAX kernel asserts one does):
    against the JAX model's associative scan, as tests/test_models.py:138
    holds that scan, and against the JAX oracle with an h0."""
    x, log_a, h0 = _scan_inputs(2, 2, 50, 16)
    hm, lm = JR.rglru_scan(jnp.asarray(x), jnp.asarray(log_a))
    ht, lt = _port_scan(x, log_a)
    _close(ht, hm)
    _close(lt, lm)
    hj, lj = jref.rglru(jnp.asarray(x), jnp.asarray(log_a), jnp.asarray(h0))
    ht, lt = _port_scan(x, log_a, h0)
    _close(ht, hj)
    _close(lt, lj)


def test_rglru_op_casts_to_f32():
    """As the JAX wrapper, bf16 inputs enter in f32 and h comes back f32."""
    x, log_a, _ = _scan_inputs(3, 1, 20, 8, h0=False)
    xb = torch.from_numpy(x).bfloat16()
    h, hl = rglru_op(xb, torch.from_numpy(log_a))
    hr, _ = ref.rglru(xb.float(), torch.from_numpy(log_a))
    assert h.dtype == hl.dtype == torch.float32
    assert torch.equal(h, hr) and torch.equal(hl, h[:, -1])


def test_cpu_path_counts_no_launch():
    before = K3.LAUNCHES
    _port_scan(*_scan_inputs(1, 1, 16, 8))
    assert K3.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "h0", "rank", "empty"])
def test_rglru_scan_rejects_bad_inputs(bad):
    x, log_a, h0 = (torch.from_numpy(a) for a in _scan_inputs(2, 2, 16, 8))
    if bad == "dtype":
        x = x.double()
    elif bad == "shape":
        log_a = log_a[:, :8]
    elif bad == "h0":
        h0 = h0[:1]
    elif bad == "rank":
        x, log_a = x[0], log_a[0]
    else:
        x, log_a = x[:, :0], log_a[:, :0]
    with pytest.raises((TypeError, ValueError)):
        K3.rglru_scan(x, log_a, h0)


# ------------------------------------------------------- mixer, ring decode
@pytest.fixture(scope="module")
def pair():
    cfg = JC.get_reduced(ARCH)
    jm = JModel(cfg, JPolicy(param_dtype="float32", compute_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = StreamModel(
        TC.get_reduced(ARCH), Policy("float32", "float32", "float32"), device="cpu", generator=None
    )
    tm.load_params(convert.params_from_jax(jax.tree.map(np.asarray, jp)))
    return cfg, jm, jp, tm


def _slot0(jp, name):
    """Group 0 of ``slots/<name>``: the JAX block and its moved twin."""
    jblk = jax.tree.map(lambda a: a[0], jp["slots"][name])
    return jblk, convert.params_from_jax(jax.tree.map(np.asarray, jblk))


def test_mixer_prefill_then_decode_matches(pair):
    """Prefill (S > 1, from the zero state) through rglru_op, then three
    one-token updates in the a * a form, each against the JAX mixer."""
    cfg, jm, jp, tm = pair
    jblk, tblk = _slot0(jp, "s0")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, PLEN, cfg.d_model)).astype(np.float32)
    yj, stj = JR.rglru_mixer(jblk["mixer"], jnp.asarray(x), cfg.rglru, jm.policy, JR.rglru_init_state(2, cfg.rglru))
    yt, stt = TR.rglru_mixer(tblk["mixer"], torch.from_numpy(x), tm.cfg.rglru, TR.rglru_init_state(2, tm.cfg.rglru))
    _close(yt, yj)
    for k in ("conv", "h"):
        _close(stt[k], stj[k])
    for _ in range(3):
        xs = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        yj, stj = JR.rglru_mixer(jblk["mixer"], jnp.asarray(xs), cfg.rglru, jm.policy, stj)
        yt, stt = TR.rglru_mixer(tblk["mixer"], torch.from_numpy(xs), tm.cfg.rglru, stt)
        _close(yt, yj)
        for k in ("conv", "h"):
            _close(stt[k], stj[k])


@pytest.mark.parametrize("per_row", [False, True])
def test_ring_decode_attention_past_a_wrap_matches(pair, per_row):
    """A ring of 16 slots (the reduced window) at positions past 16: the
    new K/V lands in slot pos % 16, every written slot is valid and no
    window mask applies to slot indices; one row still before its wrap."""
    cfg, jm, jp, tm = pair
    jblk, tblk = _slot0(jp, "s2")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((3, cfg.window, 1, cfg.hd)).astype(np.float32)
    cv = rng.standard_normal((3, cfg.window, 1, cfg.hd)).astype(np.float32)
    pos = np.array([9, 21, 40], np.int32) if per_row else np.int32(37)
    yj, kj, vj = JL.decode_attention(
        jblk["mixer"], jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos),
        cfg.attn_params("local"), jm.policy, ring=True,
    )
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    yt, kt, vt = TL.decode_attention(
        tblk["mixer"], torch.from_numpy(x), tk, tv, torch.as_tensor(pos), tm.cfg.attn_params("local"), ring=True,
    )
    assert kt is tk and vt is tv  # written in place
    for got, want in ((yt, yj), (kt, kj), (vt, vj)):
        _close(got, want)
    # in a ring a slot is no position: at pos 37 every slot is valid,
    # where the window rule of a non-ring cache would mask them all
    p37 = torch.tensor(37)
    assert bool(TL._decode_valid(p37, cfg.window, ring=True, window=cfg.window).all())
    assert not TL._decode_valid(p37, cfg.window, ring=False, window=cfg.window).any()


# ------------------------------------------------------------------ model
def test_param_tree_matches_jax_with_tail_and_f32_leaves():
    """bf16 JAX tree: key for key (slots s0-s2, tail s0-s1, no unembed),
    shape for shape, b_a / b_i / Lambda f32; into a bf16 model and back
    bit for bit."""
    cfg = JC.get_reduced(ARCH)
    jp = JModel(cfg, JPolicy(param_dtype="bfloat16", compute_dtype="bfloat16")).init(jax.random.PRNGKey(1))
    tm = StreamModel(TC.get_reduced(ARCH), Policy(), device="cpu", generator=None)
    tree = tm.param_tree()
    assert set(tree) == set(jp) == {"embed", "final_norm", "slots", "tail"}
    assert set(tree["slots"]) == {"s0", "s1", "s2"} and set(tree["tail"]) == {"s0", "s1"}
    flat_j = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jp))[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(convert.params_to_numpy(tree))[0])
    assert {p for p, _ in flat_j} == set(flat_t)
    for path, leaf in flat_j:
        assert flat_t[path].shape == leaf.shape, path
    assert tree["tail"]["s0"]["mixer"]["w_x_branch"].shape == (1, 64, 64)
    moved = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    tm.load_params(moved)
    for sec, name in (("slots", "s0"), ("slots", "s1"), ("tail", "s0"), ("tail", "s1")):
        mixer = tm.param_tree()[sec][name]["mixer"]
        assert mixer["w_a"].dtype == torch.bfloat16
        for k in TR.F32_LEAVES:
            assert moved[sec][name]["mixer"][k].dtype == torch.float32
            assert mixer[k].dtype == torch.float32, (sec, name, k)
    back = dict(jax.tree_util.tree_flatten_with_path(convert.params_to_numpy(tm.param_tree()))[0])
    for path, leaf in flat_j:
        np.testing.assert_array_equal(back[path], np.asarray(leaf, np.float32))


def test_forward_logits_match(pair):
    cfg, jm, jp, tm = pair
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 37)).astype(np.int32)
    lj, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    lt = tm(torch.from_numpy(toks))
    assert lt.dtype == torch.float32 and lt.shape == (2, 37, cfg.vocab_padded)
    _close(lt, lj, atol=1e-4)


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, tree))[0])


@pytest.mark.parametrize("plen", [PLEN, 12])
def test_prefill_and_decode_past_the_window_match_jax(pair, plen):
    """Prefill logits and every cache leaf (the ring's k/v rolled when the
    prompt passes the window, its pos, each RG-LRU layer's h and conv, in
    slots and tail), then teacher-forced decode steps that take the ring
    past its wrap, each step's logits and caches against JAX's."""
    cfg, jm, jp, tm = pair
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, plen + GEN)).astype(np.int32)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :plen])}, S_CACHE, cache_dtype=jnp.float32)
    lt, ct = tm.prefill(torch.from_numpy(toks[:, :plen]), S_CACHE, cache_dtype=torch.float32)
    assert ct["slots"]["s2"]["k"].shape == (1, 2, cfg.window, 1, cfg.hd)
    assert set(ct["tail"]) == {"s0", "s1"} and ct["tail"]["s0"]["h"].shape == (2, cfg.rglru.d_rnn)

    def check(lt, ct, lj, cj):
        _close(lt, lj, atol=1e-4)
        fj, ft = _flat(cj), _flat({k: {n: {a: t.numpy() for a, t in s.items()} for n, s in v.items()} for k, v in ct.items()})
        assert set(fj) == set(ft)
        for path, leaf in fj.items():
            _close(ft[path], leaf, atol=1e-4)

    check(lt, ct, lj, cj)
    for i in range(plen, plen + GEN):
        lj, cj = jm.decode_step(jp, cj, jnp.asarray(toks[:, i : i + 1]), i)
        lt, ct = tm.decode_step(ct, torch.from_numpy(toks[:, i : i + 1]))
        check(lt, ct, lj, cj)


def test_prefill_then_decode_matches_forward(pair):
    """The port's served logits equal its own teacher-forced forward past
    the window's wrap."""
    cfg, _, _, tm = pair
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab, (2, 40)).astype(np.int64))
    full = tm(toks)
    lg, cache = tm.prefill(toks[:, :PLEN], S_CACHE, cache_dtype=torch.float32)
    _close(lg, full[:, PLEN - 1], atol=1e-4)
    for i in range(PLEN, 40):
        lg, cache = tm.decode_step(cache, toks[:, i : i + 1])
        _close(lg[:, 0], full[:, i], atol=1e-4)


def test_embed_scale_matches_jax_in_bf16():
    """sqrt(d_model) rounded to the compute dtype, then the product in it."""
    cfg = JC.get_reduced(ARCH)
    jm = JModel(cfg, JPolicy(param_dtype="bfloat16", compute_dtype="bfloat16"))
    jp = jm.init(jax.random.PRNGKey(2))
    tm = StreamModel(TC.get_reduced(ARCH), Policy(), device="cpu", generator=None)
    tm.load_params(convert.params_from_jax(jax.tree.map(np.asarray, jp)))
    toks = np.arange(cfg.vocab, dtype=np.int32)[None]
    xj = np.asarray(jm._embed_tokens(jp, jnp.asarray(toks)).astype(jnp.float32))
    xt = tm._embed_tokens(torch.from_numpy(toks))
    assert xt.dtype == torch.bfloat16
    np.testing.assert_array_equal(xt.float().numpy(), xj)


def test_local_attention_respects_window():
    """Twin of tests/test_models.py:150 on a ("local",) variant of reduced
    recurrentgemma: a token past the window does not reach the last
    position, and does reach one inside it."""
    cfg = dataclasses.replace(TC.get_reduced(ARCH), pattern=("local",), n_layers=2, window=8)
    m = StreamModel(cfg, Policy("float32", "float32", "float32"), device="cpu", generator=0)
    t1 = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (1, 32)))
    t2 = t1.clone()
    t2[:, 0] = (t2[:, 0] + 1) % cfg.vocab
    l1, l2 = m(t1), m(t2)
    torch.testing.assert_close(l1[:, -1], l2[:, -1], atol=2e-4, rtol=2e-4)
    assert not torch.allclose(l1[:, 4], l2[:, 4], atol=1e-4)


def test_seeded_init_scales_and_decays():
    """Lambda gives a^8 = exp(-8 softplus(Lambda)) in (0.9, 0.999)
    (rglru.py:51-53), b_a and b_i are 0 and f32, gate blocks 1/sqrt(bd)."""
    cfg = TC.get_reduced(ARCH)
    a = StreamModel(cfg, Policy(), device="cpu", generator=3)
    b = StreamModel(cfg, Policy(), device="cpu", generator=3)
    for sec, name in (("slots", "s0"), ("tail", "s1")):
        ma, mb = a.param_tree()[sec][name]["mixer"], b.param_tree()[sec][name]["mixer"]
        assert torch.equal(ma["w_a"], mb["w_a"]) and torch.equal(ma["Lambda"], mb["Lambda"])
        a8 = torch.exp(-8 * torch.nn.functional.softplus(ma["Lambda"]))
        assert ma["Lambda"].dtype == torch.float32 and bool(((a8 > 0.9 - 1e-6) & (a8 < 0.999 + 1e-6)).all())
        assert not ma["b_a"].any() and not ma["b_i"].any() and ma["b_i"].dtype == torch.float32
    std = float(a.param_tree()["slots"]["s0"]["mixer"]["w_a"].float().std())
    assert abs(std - 1 / np.sqrt(cfg.rglru.block_dim)) < 0.1 / np.sqrt(cfg.rglru.block_dim)


def test_bf16_prefill_and_decode_distance_from_jax():
    """Reduced recurrentgemma with bf16 weights and activations: the port's
    prefill and eight teacher-forced decode steps (past the ring's wrap)
    against the JAX model's. The two round differently (op order, XLA's
    excess precision on the CPU), so their logits are held to 0.5, as the
    Mamba-2 twin holds them; a lost or misplaced state moves them by more."""
    cfg = JC.get_reduced(ARCH)
    jm = JModel(cfg, JPolicy(param_dtype="bfloat16", compute_dtype="bfloat16"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = StreamModel(TC.get_reduced(ARCH), Policy(), device="cpu", generator=None)
    tm.load_params(convert.params_from_jax(jax.tree.map(np.asarray, jp)))
    toks = np.random.default_rng(10).integers(0, cfg.vocab, (4, PLEN + GEN)).astype(np.int32)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :PLEN])}, S_CACHE, cache_dtype=jnp.float32)
    lt, ct = tm.prefill(torch.from_numpy(toks[:, :PLEN]), S_CACHE, cache_dtype=torch.float32)
    assert float(np.abs(lt.numpy() - np.asarray(lj)).max()) <= 0.5
    for i in range(PLEN, PLEN + GEN):
        lj, cj = jm.decode_step(jp, cj, jnp.asarray(toks[:, i : i + 1]), i)
        lt, ct = tm.decode_step(ct, torch.from_numpy(toks[:, i : i + 1]))
        assert bool(torch.isfinite(lt).all())
        assert float(np.abs(lt.numpy() - np.asarray(lj)).max()) <= 0.5, i


# ------------------------------------------------------------------ engines
def test_greedy_tokens_identical_to_jax_wave_engine(pair):
    """4 prompts of 24 tokens (past the window of 16), s_cache 40, 8 new tokens."""
    cfg, jm, jp, tm = pair
    rng = np.random.default_rng(9)
    reqs = [(i, rng.integers(0, cfg.vocab, PLEN).astype(np.int32), GEN) for i in range(4)]
    jeng = J.LMEngine(jm, jp, n_slots=4, s_cache=S_CACHE)
    teng = T.LMEngine(tm, n_slots=4, s_cache=S_CACHE, device="cpu")
    for eng, mk in ((jeng, J.Request), (teng, T.Request)):
        for rid, prompt, max_new in reqs:
            eng.submit(mk(rid, prompt, max_new))
    want, got = dict(jeng.run_until_drained()), dict(teng.run_until_drained())
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert teng.waves == jeng.waves == 1


def test_serve_stream_fixed_prompts_byte_identical_to_jax(pair):
    """The JAX record format: int32[prompt_len] in, req_id || int32[max_new]
    out; 6 prompts make a full wave and a padded one."""
    cfg, jm, jp, tm = pair
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (6, PLEN)).astype(np.int32)
    jlog, tlog = jcore.StreamLog(), StreamLog()
    for log in (jlog, tlog):
        log.create_topic("prompts")
        log.produce_batch("prompts", [p.tobytes() for p in prompts])
    jn = J.serve_stream(J.LMEngine(jm, jp, n_slots=4, s_cache=S_CACHE), jlog, "prompts", "out", PLEN, max_new=GEN)
    tn = T.serve_stream(T.LMEngine(tm, n_slots=4, s_cache=S_CACHE, device="cpu"), tlog, "prompts", "out", PLEN,
                        max_new=GEN)
    assert jn == tn == 6
    jrec = [bytes(b) for b in jlog.read("out", 0, 0, 10).values]
    trec = [bytes(b) for b in tlog.read("out", 0, 0, 10).values]
    assert jrec == trec


def test_continuous_engine_refuses_the_pattern(pair):
    cfg, jm, jp, tm = pair
    with pytest.raises(NotImplementedError):
        J.ContinuousLMEngine(jm, jp, n_slots=2, n_blocks=8, block_size=8, max_blocks=4)
    with pytest.raises(NotImplementedError):
        T.ContinuousLMEngine(tm, n_slots=2, n_blocks=8, block_size=8, max_blocks=4, device="cpu")
