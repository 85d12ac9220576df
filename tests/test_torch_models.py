"""The port's layers and model against the JAX package's, on moved weights.

Reduced yi-6b in f32 on the CPU (``Policy`` as in tests/test_lm_engine.py);
inputs from numpy seeds. Layers are held at 1e-5, logits at 1e-4. Then
the rest of the attention-only family: reduced gemma2-2b, qwen2-7b and
mistral-large-123b; then reduced pixtral-12b's patch frontend.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import layers as JL
from repro.models.model import StreamModel as JModel
from repro.models.policy import Policy as JPolicy
import repro_torch.configs as TC
from repro_torch import convert, resolve_device
from repro_torch.models import layers as TL
from repro_torch.models.model import StreamModel
from repro_torch.models.policy import Policy

ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    cfg = JC.get_reduced("yi-6b")
    jm = JModel(cfg, JPolicy(param_dtype="float32", compute_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = StreamModel(
        TC.get_reduced("yi-6b"), Policy("float32", "float32", "float32"), device="cpu", generator=None
    )
    tm.load_params(convert.params_from_jax(jax.tree.map(np.asarray, jp)))
    return cfg, jm, jp, tm


def _layer0(jp):
    blk = jp["slots"]["s0"]
    jblk = jax.tree.map(lambda a: a[0], blk)
    tblk = convert.params_from_jax(jax.tree.map(np.asarray, jblk))
    return jblk, tblk


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=atol)


def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x, w = rng.standard_normal((2, 5, 64)).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    for plus_one in (False, True):
        _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5, plus_one=plus_one),
               JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, plus_one=plus_one))


@pytest.mark.parametrize("per_row", [False, True])
def test_rope_interleaved_matches(per_row):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)) if per_row else np.arange(7) + 100
    _close(TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 5e6),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), 5e6))


def test_mlp_matches(pair):
    _, _, jp, _ = pair
    jblk, tblk = _layer0(jp)
    x = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(np.float32)
    _close(TL.mlp(tblk["mlp"], torch.from_numpy(x), "gated"), JL.mlp(jblk["mlp"], jnp.asarray(x), "gated"))


def test_prefill_attention_matches(pair):
    cfg, jm, jp, tm = pair
    jblk, tblk = _layer0(jp)
    ap_j = cfg.attn_params("attn")
    x = np.random.default_rng(3).standard_normal((2, 24, 64)).astype(np.float32)
    yj, kj, vj = JL.attention(jblk["mixer"], jnp.asarray(x), ap_j, jm.policy, return_kv=True)
    yt, kt, vt = TL.attention(tblk["mixer"], torch.from_numpy(x), tm.cfg.attn_params("attn"), return_kv=True)
    for got, want in ((yt, yj), (kt, kj), (vt, vj)):
        _close(got, want)


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_matches(pair, per_row):
    cfg, jm, jp, tm = pair
    jblk, tblk = _layer0(jp)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    ck = rng.standard_normal((3, 20, 2, 16)).astype(np.float32)
    cv = rng.standard_normal((3, 20, 2, 16)).astype(np.float32)
    pos = np.array([4, 11, 19], np.int32) if per_row else np.int32(9)
    yj, kj, vj = JL.decode_attention(
        jblk["mixer"], jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos),
        cfg.attn_params("attn"), jm.policy,
    )
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    yt, kt, vt = TL.decode_attention(
        tblk["mixer"], torch.from_numpy(x), tk, tv, torch.as_tensor(pos), tm.cfg.attn_params("attn")
    )
    assert kt is tk and vt is tv  # written in place
    for got, want in ((yt, yj), (kt, kj), (vt, vj)):
        _close(got, want)


def test_paged_decode_attention_matches(pair):
    cfg, jm, jp, tm = pair
    jblk, tblk = _layer0(jp)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    ck = rng.standard_normal((10, 4, 2, 16)).astype(np.float32)
    cv = rng.standard_normal((10, 4, 2, 16)).astype(np.float32)
    pos = np.array([5, 0, 13], np.int32)  # row 1 idle (all-zero table)
    bt = np.array([[3, 7, 0, 0], [0, 0, 0, 0], [1, 2, 4, 9]], np.int32)
    yj, kj, vj = JL.paged_decode_attention(
        jblk["mixer"], jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos),
        jnp.asarray(bt), cfg.attn_params("attn"), jm.policy,
    )
    yt, kt, vt = TL.paged_decode_attention(
        tblk["mixer"], torch.from_numpy(x), torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()),
        torch.from_numpy(pos), torch.from_numpy(bt), tm.cfg.attn_params("attn"),
    )
    live = [0, 2]  # the idle row's output and its scratch-block write are discarded
    _close(yt[live], np.asarray(yj)[live])
    keep = np.ones(10, bool)
    keep[0] = False
    for got, want in ((kt, kj), (vt, vj)):
        _close(got[keep], np.asarray(want)[keep])


def test_forward_logits_match(pair):
    cfg, jm, jp, tm = pair
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 33)).astype(np.int32)
    lj, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    lt = tm(torch.from_numpy(toks))
    assert lt.dtype == torch.float32 and lt.shape == (2, 33, cfg.vocab_padded)
    _close(lt, lj, atol=1e-4)


def test_prefill_matches_jax(pair):
    cfg, jm, jp, tm = pair
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 16, cache_dtype=jnp.float32)
    lt, ct = tm.prefill(torch.from_numpy(toks), 16, cache_dtype=torch.float32)
    _close(lt, lj, atol=1e-4)
    for key in ("k", "v", "pos"):
        _close(ct["slots"]["s0"][key], cj["slots"]["s0"][key], atol=1e-4)


def test_prefill_then_decode_matches_forward(pair):
    cfg, _, _, tm = pair
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab, (2, 14)).astype(np.int64))
    full = tm(toks)
    lg, cache = tm.prefill(toks[:, :10], 16, cache_dtype=torch.float32)
    _close(lg, full[:, 9], atol=1e-4)
    for i in range(10, 14):
        lg, cache = tm.decode_step(cache, toks[:, i : i + 1])
        _close(lg[:, 0], full[:, i], atol=1e-4)


def test_tied_dense_logits_match():
    """tie_embeddings on the dense pattern: no unembed, logits x @ embed^T."""
    cfg = dataclasses.replace(JC.get_reduced("yi-6b"), tie_embeddings=True)
    jm = JModel(cfg, JPolicy(param_dtype="float32", compute_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(1))
    tm = StreamModel(
        dataclasses.replace(TC.get_reduced("yi-6b"), tie_embeddings=True),
        Policy("float32", "float32", "float32"), device="cpu", generator=None,
    )
    assert "unembed" not in jp and "unembed" not in tm.param_tree()
    tm.load_params(convert.params_from_jax(jax.tree.map(np.asarray, jp)))
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    lj, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    _close(tm(torch.from_numpy(toks)), lj, atol=1e-4)


def test_unported_configs_raise():
    """What the port still refuses (layer norm and learned positions are
    taken since whisper): an encoder with no ``encdec`` slot to read it,
    and an ``encdec`` slot with no encoder."""
    base = TC.get_reduced("yi-6b")
    for change in ({"enc_dec": True}, {"pattern": ("encdec",)}):
        with pytest.raises(NotImplementedError):
            StreamModel(dataclasses.replace(base, **change), device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            StreamModel(TC.get_reduced("yi-6b"))
    assert resolve_device("cpu").type == "cpu"


def test_seeded_init_scales_and_determinism():
    cfg = TC.get_reduced("yi-6b")
    a = StreamModel(cfg, Policy("float32", "float32", "float32"), device="cpu", generator=3)
    b = StreamModel(cfg, Policy("float32", "float32", "float32"), device="cpu", generator=3)
    ta, tb = a.param_tree(), b.param_tree()
    assert torch.equal(ta["embed"], tb["embed"])
    assert ta["slots"]["s0"]["mixer"]["wq"].shape == (3, 64, 4, 16)
    std = float(ta["slots"]["s0"]["mlp"]["w_out"].std())
    assert abs(std - 1 / np.sqrt(cfg.d_ff)) < 0.1 / np.sqrt(cfg.d_ff)
    assert torch.equal(ta["final_norm"]["w"], torch.ones(1, 64))


# ------------------------------------------- the rest of the attention family
# Reduced gemma2-2b (local / global layers, window 16, attention and final
# softcaps, sandwich norms, tied and scaled embed, gelu), qwen2-7b (QKV
# bias) and mistral-large-123b (head dim 8 beside d 64) on JAX's weights,
# moved, with the biases and every norm weight drawn away from JAX's zeros
# and ones so that each is pinned. Tolerances: logits 1e-4; prefill and
# decode at tests/test_models.py:77-98's (3e-4, 5e-3).
FAMILY = ("gemma2-2b", "qwen2-7b", "mistral-large-123b")
PREFILL_TOL, DECODE_TOL = 3e-4, 5e-3


def _perturbed(jp, seed):
    """JAX's params with the QKV biases drawn from N(0, 0.5^2) and every
    norm weight moved by N(0, 0.1^2): JAX's init leaves them 0 and 1."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        names = {getattr(k, "key", None) for k in path}
        if names & {"bq", "bk", "bv"}:
            return leaf + 0.5 * rng.standard_normal(leaf.shape).astype(np.float32)
        if names & {"norm1", "norm2", "post1", "post2", "final_norm"}:
            return leaf + 0.1 * rng.standard_normal(leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(move, jax.tree.map(np.asarray, jp))


@functools.lru_cache(maxsize=None)
def _family(arch):
    cfg = JC.get_reduced(arch)
    jm = JModel(cfg, JPolicy(param_dtype="float32", compute_dtype="float32"))
    jp = _perturbed(jm.init(jax.random.PRNGKey(0)), 11)
    tm = StreamModel(TC.get_reduced(arch), Policy("float32", "float32", "float32"), device="cpu", generator=None)
    tm.load_params(convert.params_from_jax(jp))
    return cfg, jm, jax.tree.map(jnp.asarray, jp), tm


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, tree))[0])


@pytest.mark.parametrize("arch", FAMILY)
def test_family_param_tree_matches_jax(arch):
    """Key for key and shape for shape: gemma2's post1 / post2 beside
    each block's norms (post2 with the MLP), qwen2's bq (n, H, hd) and
    bk / bv (n, Kv, hd); the seeded init leaves the biases 0 and the
    sandwich norms 1, as JAX's."""
    cfg, _, jp, tm = _family(arch)
    want = _flat(jp)
    got = _flat(convert.params_to_numpy(tm.param_tree()))
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert got[path].shape == leaf.shape, path
    blk = tm.param_tree()["slots"]["s0"]
    assert ("post1" in blk and "post2" in blk) == (arch == "gemma2-2b")
    assert ("bq" in blk["mixer"]) == (arch == "qwen2-7b")
    fresh = StreamModel(TC.get_reduced(arch), Policy("float32", "float32", "float32"), device="cpu", generator=3)
    fb = fresh.param_tree()["slots"]["s0"]
    for k in ("bq", "bk", "bv"):
        if k in fb["mixer"]:
            assert fb["mixer"][k].shape == (cfg.n_layers // len(cfg.pattern), *blk["mixer"][k].shape[1:])
            assert not fb["mixer"][k].any()
    for k in ("post1", "post2"):
        if k in fb:
            assert torch.equal(fb[k]["w"], torch.ones_like(fb[k]["w"]))


@pytest.mark.parametrize("arch", FAMILY)
def test_family_forward_logits_match(arch):
    cfg, jm, jp, tm = _family(arch)
    toks = np.random.default_rng(21).integers(0, cfg.vocab, (2, 37)).astype(np.int32)
    lj, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    lt = tm(torch.from_numpy(toks))
    assert lt.dtype == torch.float32 and lt.shape == (2, 37, cfg.vocab_padded)
    _close(lt, lj, atol=1e-4)


@pytest.mark.parametrize("arch", FAMILY)
def test_family_prefill_and_decode_match_jax(arch):
    """Prefill logits and every cache leaf against JAX's (gemma2: a prompt
    past the window of 16, so its local layers' ring is filled rolled),
    then teacher-forced decode steps (gemma2's ring past its wrap), each
    step's logits and caches against JAX's; and the port's prefill then
    decode against its own forward (tests/test_models.py:77)."""
    cfg, jm, jp, tm = _family(arch)
    plen, gen, s_cache = 20, 6, 32
    toks = np.random.default_rng(22).integers(0, cfg.vocab, (2, plen + gen)).astype(np.int32)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :plen])}, s_cache, cache_dtype=jnp.float32)
    lt, ct = tm.prefill(torch.from_numpy(toks[:, :plen]), s_cache, cache_dtype=torch.float32)
    if arch == "gemma2-2b":
        assert ct["slots"]["s0"]["k"].shape[2] == cfg.window < plen  # the local slot's ring
        assert ct["slots"]["s1"]["k"].shape[2] == s_cache

    def check(lt, ct, lj, cj, tol):
        _close(lt, lj, atol=tol)
        fj = _flat(cj)
        ft = _flat({k: {n: {a: t.numpy() for a, t in s.items()} for n, s in v.items()} for k, v in ct.items()})
        assert set(fj) == set(ft)
        for path, leaf in fj.items():
            _close(torch.from_numpy(np.asarray(ft[path], np.float32)), np.asarray(leaf, np.float32), atol=tol)

    check(lt, ct, lj, cj, PREFILL_TOL)
    full = tm(torch.from_numpy(toks))
    _close(lt, full[:, plen - 1], atol=PREFILL_TOL)
    for i in range(plen, plen + gen):
        lj, cj = jm.decode_step(jp, cj, jnp.asarray(toks[:, i : i + 1]), i)
        lt, ct = tm.decode_step(ct, torch.from_numpy(toks[:, i : i + 1]))
        check(lt, ct, lj, cj, DECODE_TOL)
        _close(lt[:, 0], full[:, i], atol=DECODE_TOL)


@pytest.mark.parametrize("arch", ["qwen2-7b", "mistral-large-123b"])
def test_family_paged_decode_matches_jax(arch):
    """The dense members through the paged cache, as the continuous engine
    drives it: each row prefilled alone into whole blocks, admitted by
    paged_insert at its own length, then decoded at per-row positions;
    every step's logits against JAX's same calls and the port's forward."""
    cfg, jm, jp, tm = _family(arch)
    blk, max_blocks, n_blocks, gen = 4, 5, 12, 4
    lens = (5, 9)
    rng = np.random.default_rng(23)
    seqs = [rng.integers(0, cfg.vocab, n + gen).astype(np.int32) for n in lens]
    cj = jm.init_paged_cache(2, n_blocks, blk, max_blocks, dtype=jnp.float32)
    ct = tm.init_paged_cache(2, n_blocks, blk, max_blocks, dtype=torch.float32)
    tables = ([1, 2, 3, 0, 0], [4, 5, 6, 7, 0])
    for row, (n, seq, table) in enumerate(zip(lens, seqs, tables)):
        ids = [b for b in table if b][: -(-(n + gen) // blk)]
        lj, small_j = jm.prefill(jp, {"tokens": jnp.asarray(seq[None, :n])}, len(ids) * blk, cache_dtype=jnp.float32)
        lt, small_t = tm.prefill(torch.from_numpy(seq[None, :n]), len(ids) * blk, cache_dtype=torch.float32)
        _close(lt, lj, atol=PREFILL_TOL)
        cj = jm.paged_insert(cj, small_j, row, jnp.asarray(ids), jnp.asarray(table, jnp.int32), n)
        ct = tm.paged_insert(ct, small_t, row, ids, table, n)
    fulls = [tm(torch.from_numpy(s[None]))[0] for s in seqs]
    for i in range(gen):
        tok = np.array([[s[n + i]] for n, s in zip(lens, seqs)], np.int32)
        pos = np.array([n + i for n in lens], np.int32)
        lj, cj = jm.decode_step(jp, cj, jnp.asarray(tok), jnp.asarray(pos))
        lt, ct = tm.decode_step(ct, torch.from_numpy(tok))
        _close(lt, lj, atol=DECODE_TOL)
        for row, n in enumerate(lens):
            _close(lt[row, 0], fulls[row][n + i], atol=DECODE_TOL)


@pytest.mark.parametrize("arch", FAMILY)
def test_family_causality(arch):
    """Mirror of tests/test_models.py:101: logits[:, :20] do not depend on
    the tokens after 20 (gemma2: 32 tokens past its window of 16)."""
    cfg, _, _, tm = _family(arch)
    tok = torch.from_numpy(np.random.default_rng(24).integers(0, cfg.vocab, (2, 32)))
    full = tm(tok)
    short = tm(tok[:, :20])
    _close(full[:, :20], short.numpy(), atol=2e-4)


def test_gemma2_local_attention_respects_window():
    """Mirror of tests/test_models.py:150: every layer local (window 8);
    the last of 32 tokens does not see a change to token 0, token 4 does,
    as in JAX on the same weights."""
    cfg = dataclasses.replace(JC.get_reduced("gemma2-2b"), pattern=("local",), n_layers=2, window=8)
    jm = JModel(cfg, JPolicy(param_dtype="float32", compute_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(TC.get_reduced("gemma2-2b"), pattern=("local",), n_layers=2, window=8)
    tm = StreamModel(tcfg, Policy("float32", "float32", "float32"), device="cpu", generator=None)
    tm.load_params(convert.params_from_jax(jax.tree.map(np.asarray, jp)))
    t1 = np.random.default_rng(25).integers(0, cfg.vocab, (1, 32)).astype(np.int32)
    t2 = t1.copy()
    t2[:, 0] = (t1[:, 0] + 1) % cfg.vocab
    l1, l2 = tm(torch.from_numpy(t1)), tm(torch.from_numpy(t2))
    _close(l1[:, -1], l2[:, -1].numpy(), atol=2e-4)
    assert not np.allclose(l1[:, 4].numpy(), l2[:, 4].numpy(), atol=1e-4)
    _close(l1, jm.forward(jp, {"tokens": jnp.asarray(t1)})[0], atol=1e-4)


@pytest.mark.parametrize("arch", FAMILY)
def test_family_one_train_step(arch):
    """Mirror of tests/test_models.py:37: forward shapes, finite logits,
    one AdamW step, a finite loss after it, on the moved weights."""
    from repro_torch.train import adamw, build_train_step

    cfg, _, jp, _ = _family(arch)
    m = StreamModel(TC.get_reduced(arch), Policy("float32", "float32", "float32"), device="cpu", generator=None)
    m.load_params(convert.params_from_jax(jax.tree.map(np.asarray, jp)))
    tok = torch.from_numpy(np.random.default_rng(26).integers(0, cfg.vocab, (2, 32)))
    logits = m(tok)
    assert logits.shape == (2, 32, cfg.vocab_padded) and torch.isfinite(logits).all()
    step, _ = build_train_step(m, adamw(1e-3))
    state = {"params": m.param_tree(), "opt": adamw(1e-3).init(m.param_tree())}
    m.requires_grad_(True)
    state, metrics = step(state, {"tokens": tok})
    assert np.isfinite(float(metrics["loss"]))
    with torch.no_grad():
        l2, _ = m.loss(state["params"], {"tokens": tok})
    assert np.isfinite(float(l2)) and float(l2) < float(metrics["loss"])


@pytest.mark.parametrize("arch,refused", [
    ("gemma2-2b", []), ("qwen2-7b", []), ("mistral-large-123b", []),
    ("qwen3-moe-30b-a3b", []), ("arctic-480b", []), ("pixtral-12b", []), ("whisper-tiny", []),
])
def test_unsupported_refuses_what_the_port_lacks(arch, refused):
    """The JAX package's configs, field for field in the port's ArchConfig
    (an MoE's fields in the port's MoEParams): the attention-only family,
    the MoE configs, pixtral's patch frontend and whisper's encoder-decoder
    (its frames, learned positions and layer norm) are all taken."""
    from repro_torch.models.model import ArchConfig, _unsupported
    from repro_torch.models.moe import MoEParams

    jcfg = JC.get(arch)
    cfg = ArchConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ArchConfig)})
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=MoEParams(**dataclasses.asdict(cfg.moe)))
    got = ["pattern" if g.startswith("pattern ") else g for g in _unsupported(cfg)]
    assert got == refused, got
    if not refused:
        assert TC.get(arch) == cfg


# ------------------------------------------------ pixtral's patch frontend
# Reduced pixtral-12b (d 64, 3 layers, GQA 4/2, 8 patch positions) on
# JAX's weights, moved; patch embeddings drawn as JAX's make_batch draws
# them (standard normal, tests/test_models.py:30's _batch). Tolerances:
# logits 1e-4; prefill and decode at PREFILL_TOL and DECODE_TOL.
PX = "pixtral-12b"


@functools.lru_cache(maxsize=None)
def _pixtral():
    cfg = JC.get_reduced(PX)
    jm = JModel(cfg, JPolicy(param_dtype="float32", compute_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = StreamModel(TC.get_reduced(PX), Policy("float32", "float32", "float32"), device="cpu", generator=None)
    tm.load_params(convert.params_from_jax(jax.tree.map(np.asarray, jp)))
    return cfg, jm, jp, tm


def _pixtral_batch(cfg, seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            rng.standard_normal((b, cfg.frontend_len, cfg.d_model)).astype(np.float32))


def test_pixtral_logits_match_jax():
    """Logits over the patch positions and the tokens, (B, P + S, vocab)."""
    cfg, jm, jp, tm = _pixtral()
    toks, patches = _pixtral_batch(cfg, 41)
    lj, _ = jm.forward(jp, {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches)})
    lt = tm(torch.from_numpy(toks), torch.from_numpy(patches))
    assert lt.shape == (2, cfg.frontend_len + 24, cfg.vocab_padded)
    _close(lt, lj, atol=1e-4)


def test_pixtral_prefill_and_decode_match_jax():
    """Mirror of tests/test_models.py:77 with the patch offset: prefill of
    the patches and all but the last token against JAX's prefill (logits
    and cache) and the port's forward at position P + S - 2; then one
    decode step, JAX's at position S - 1 + front, against JAX's and the
    forward's last position; the cache's position runs over P + S."""
    cfg, jm, jp, tm = _pixtral()
    s = 24
    toks, patches = _pixtral_batch(cfg, 42, s=s)
    front = cfg.frontend_len
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "patch_embeds": jnp.asarray(patches)}
    lj, cj = jm.prefill(jp, jb, s + front + 8, cache_dtype=jnp.float32)
    lt, ct = tm.prefill(torch.from_numpy(toks[:, :-1]), s + front + 8, cache_dtype=torch.float32,
                        patch_embeds=torch.from_numpy(patches))
    _close(lt, lj, atol=PREFILL_TOL)
    for key in ("k", "v"):
        _close(ct["slots"]["s0"][key], np.asarray(cj["slots"]["s0"][key]), atol=PREFILL_TOL)
    assert int(ct["slots"]["s0"]["pos"][0]) == front + s - 1
    full = tm(torch.from_numpy(toks), torch.from_numpy(patches))
    _close(lt, full[:, -2].numpy(), atol=PREFILL_TOL)
    sj, _ = jm.decode_step(jp, cj, jnp.asarray(toks[:, -1:]), jnp.int32(s - 1 + front))
    st, _ = tm.decode_step(ct, torch.from_numpy(toks[:, -1:]))
    _close(st, sj, atol=DECODE_TOL)
    _close(st[:, 0], full[:, -1].numpy(), atol=DECODE_TOL)


def test_pixtral_causality():
    """Mirror of tests/test_models.py:101 over the token part: logits at the
    patches and the first 20 tokens do not depend on the later tokens."""
    cfg, _, _, tm = _pixtral()
    toks, patches = _pixtral_batch(cfg, 43, s=32)
    full = tm(torch.from_numpy(toks), torch.from_numpy(patches))
    short = tm(torch.from_numpy(toks[:, :20]), torch.from_numpy(patches))
    _close(full[:, :20 + cfg.frontend_len], short.numpy(), atol=2e-4)


def test_pixtral_refuses_without_patches():
    """A patch frontend needs its patches in every entry point; a model
    without one takes none."""
    cfg, _, _, tm = _pixtral()
    toks, patches = _pixtral_batch(cfg, 44)
    t = torch.from_numpy(toks)
    for call in (lambda: tm(t), lambda: tm.prefill(t, 64), lambda: tm.loss(tm.param_tree(), {"tokens": t}),
                 lambda: tm.hidden(tm.param_tree(), {"tokens": t})):
        with pytest.raises(ValueError, match="patch_embeds"):
            call()
    _, _, _, yi = _family("qwen2-7b")
    with pytest.raises(ValueError, match="no patch frontend"):
        yi(t, torch.from_numpy(patches))


def test_pixtral_one_train_step():
    """Mirror of tests/test_models.py:37 on pixtral: forward shapes over
    P + S, finite logits, one AdamW step on a batch with its patches, a
    finite and lower loss after it."""
    from repro_torch.train import adamw, build_train_step

    cfg, _, jp, _ = _pixtral()
    m = StreamModel(TC.get_reduced(PX), Policy("float32", "float32", "float32"), device="cpu", generator=None)
    m.load_params(convert.params_from_jax(jax.tree.map(np.asarray, jp)))
    toks, patches = _pixtral_batch(cfg, 45, s=32)
    batch = {"tokens": torch.from_numpy(toks), "patch_embeds": torch.from_numpy(patches)}
    logits = m(batch["tokens"], batch["patch_embeds"])
    assert logits.shape == (2, 32 + cfg.frontend_len, cfg.vocab_padded) and torch.isfinite(logits).all()
    step, _ = build_train_step(m, adamw(1e-3))
    state = {"params": m.param_tree(), "opt": adamw(1e-3).init(m.param_tree())}
    m.requires_grad_(True)
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    with torch.no_grad():
        l2, _ = m.loss(state["params"], batch)
    assert np.isfinite(float(l2)) and float(l2) < float(metrics["loss"])
