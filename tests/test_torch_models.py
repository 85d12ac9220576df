"""The port's layers and model against the JAX package's, on moved weights.

Reduced yi-6b in f32 on the CPU (``Policy`` as in tests/test_lm_engine.py);
inputs from numpy seeds. Layers are held at 1e-5, logits at 1e-4.
"""

import dataclasses

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
    base = TC.get_reduced("yi-6b")
    for change in ({"post_norms": True}, {"learned_pos": True}, {"norm": "ln"}):
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
