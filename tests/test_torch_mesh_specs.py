"""The port's mesh policy and specs against the JAX package's, and the
mesh paths that need no second process, on the CPU.

* ``Policy``'s mesh methods and ``logical_to_pspec``; ``param_pspecs``,
  the optimizers' ``state_pspecs`` (AdamW's and the 8-bit one's, whose
  scales keep their trailing dim whole) and the trainer's ``state_pspecs``
  equal the reference's entry for entry, for all 10 configs, full and
  reduced, on the mesh-axis dicts of ``POLICIES``: (data 2, model 2),
  (data 16, model 16), (pod 2, data 16, model 16), (data 4, model 4) with
  ZeRO-3 over ``data``, selective and not, and 2D expert parallelism over
  ``pod``. Specs need no devices: the reference's
  ``StreamModel(cfg, Policy(mesh_axes=...))`` gives them without a mesh,
  and the port's model is built on the meta device.
* A mesh of one rank runs the mesh-free step's operations: two steps of
  ``build_train_step(mesh=)`` give the losses and parameters of
  ``build_train_step`` without a mesh, to the bit (the CPU side of
  ``chip_smoke.py``'s one-card check).
* K1 with a query offset: ``ref.mha(q_offset=)`` and the CPU sides of
  ``flash_attention`` and ``flash_attention_bwd`` against JAX's
  ``_chunked_attention`` at offset positions (a context-parallel shard),
  causal, windowed and softcapped, at 1e-5.
* The SSD kernel's layout rule on the views the mixer makes of one rank's
  heads at mamba2-2.7b's full width, for every model axis that splits
  them.
* ``ShardedFeeder`` on a mesh of one rank (the reference's
  ``tests/test_pipeline.py`` case).
"""

from __future__ import annotations

import math
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models.layers import AttnParams as JAttnParams, _chunked_attention
from repro.models.model import StreamModel as JModel
from repro.models.policy import Policy as JPolicy, logical_to_pspec as jlogical
from repro.train.optimizer import adamw as jadamw, adamw8bit as jadamw8bit
from repro.train.trainer import state_pspecs as jstate_pspecs
import repro_torch.configs as TC
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref, ssd_scan
from repro_torch.models.model import StreamModel, param_pspecs
from repro_torch.models.policy import Policy, logical_to_pspec
from repro_torch.train import adamw, adamw8bit, build_train_step, state_pspecs
from repro_torch.train.optimizer import tree_leaves

ATTN_TOL = 1e-5

POLICIES = {
    "data2-model2": dict(mesh_axes={"data": 2, "model": 2}),
    "data16-model16": dict(mesh_axes={"data": 16, "model": 16}),
    "pod2-data16-model16": dict(mesh_axes={"pod": 2, "data": 16, "model": 16}, batch_axes=("pod", "data")),
    "data4-model4-zero3": dict(mesh_axes={"data": 4, "model": 4}, fsdp_axes=("data",), fsdp_selective=True),
    "data4-model4-zero3-full": dict(mesh_axes={"data": 4, "model": 4}, fsdp_axes=("data",), fsdp_selective=False),
    "pod2-data16-model16-ep-inner": dict(mesh_axes={"pod": 2, "data": 16, "model": 16}, batch_axes=("data",),
                                         ep_inner_axes=("pod",), fsdp_axes=("data",), fsdp_selective=False),
}
ARCHS = JC.names()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch: str, size: str):
    return (JC.get(arch), TC.get(arch)) if size == "full" else (JC.get_reduced(arch), TC.get_reduced(arch))


def _flat(tree) -> dict:
    """path -> spec entries (a spec is a tuple of entries)."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, prefix + (k,))
        else:
            out["/".join(prefix)] = tuple(t)

    walk(tree, ())
    return out


def _assert_same(got, want, what):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        assert g[k] == w[k], (what, k, g[k], w[k])


def test_logical_to_pspec_and_policy_methods_match_jax():
    """Every logical dim name, every spec builder and the axis sizes, on
    each policy of POLICIES at sizes that divide and sizes that do not."""
    dims = [("batch", 256), ("batch", 24), ("seq", 4096), ("heads", 28), ("kv_heads", 8), ("head_dim", 128),
            ("embed", 4096), ("embed", 4100), ("ff", 11008), ("experts", 128), ("vocab", 152064), ("state", 16),
            ("layers", 32), ("none", 3)]
    for name, kw in POLICIES.items():
        for seq_axis in (None, "model", ("data", "model")):
            jp, tp = JPolicy(seq_axis=seq_axis, **kw), Policy(seq_axis=seq_axis, **kw)
            assert tuple(logical_to_pspec(tp, dims)) == tuple(jlogical(jp, dims)), (name, seq_axis)
            for n in (1, 2, 3, 8, 24, 56, 128, 4100, 11008):
                assert tp.tp(n) == jp.tp(n) and tp.seq(n) == jp.seq(n), (name, n)
                assert tp.batch_spec(n) == jp.batch_spec(n) and tp.ep_inner(n) == jp.ep_inner(n), (name, n)
                for has in (False, True):
                    assert tp.fsdp(n, has_tp=has) == jp.fsdp(n, has_tp=has), (name, n, has)
            assert tp.dp_degree == jp.dp_degree and tp.size(("pod", "data")) == jp.size(("pod", "data"))
            assert tp.with_mesh_axes({"data": 8}).mesh_axes == jp.with_mesh_axes({"data": 8}).mesh_axes
    by_mesh = Policy.for_mesh({"pod": 2, "data": 4, "model": 2}, param_dtype="float32")
    assert by_mesh.batch_axes == ("pod", "data") and by_mesh.tp_axis == "model" and by_mesh.param_dtype == "float32"
    assert Policy.for_mesh({"data": 4}).tp_axis is None
    assert Policy("float32", "float32", "float32").compute_dtype == "float32"  # the dtype fields keep their places


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_jax(arch, size):
    """``param_pspecs`` equals the reference's ``StreamModel.param_pspecs``
    on every policy of POLICIES."""
    jcfg, tcfg = _cfgs(arch, size)
    for name, kw in POLICIES.items():
        _assert_same(param_pspecs(tcfg, Policy(**kw)), JModel(jcfg, JPolicy(**kw)).param_pspecs(), name)


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_state_pspecs_match_jax(arch, size):
    """AdamW's and the 8-bit AdamW's ``state_pspecs`` (the codes as their
    parameter, the scales with the trailing dim whole) equal the
    reference's on every policy of POLICIES."""
    jcfg, tcfg = _cfgs(arch, size)
    for name, kw in POLICIES.items():
        specs = param_pspecs(tcfg, Policy(**kw))
        jspecs = JModel(jcfg, JPolicy(**kw)).param_pspecs()
        _assert_same(adamw().state_pspecs(specs), jadamw().state_pspecs(jspecs), name)
        _assert_same(adamw8bit().state_pspecs(specs), jadamw8bit().state_pspecs(jspecs), name)


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_state_pspecs_match_jax(arch, size):
    """The trainer's ``state_pspecs(model, opt)`` of a model built on the
    meta device equals the reference's on every policy of POLICIES."""
    jcfg, tcfg = _cfgs(arch, size)
    for name, kw in POLICIES.items():
        m = StreamModel(tcfg, Policy(**kw), device="meta", generator=None)
        _assert_same(state_pspecs(m, adamw8bit()), jstate_pspecs(JModel(jcfg, JPolicy(**kw)), jadamw8bit()), name)


# ------------------------------------------------------------ serving's specs
CACHE_MESHES = {"1x4": {"data": 1, "model": 4}, "2x2": {"data": 2, "model": 2}, "4x1": {"data": 4, "model": 1}}


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_match_jax(arch, size):
    """``StreamModel.cache_pspecs`` equals the reference's, entry for entry
    (the doubled ``model`` of a split kv head count under ``seq_axis=
    "model"`` included), on (1, 4), (2, 2) and (4, 1) with ``seq_axis``
    None, ``"model"`` and ``"data"``, at batch sizes that split and that
    do not."""
    jcfg, tcfg = _cfgs(arch, size)
    for mname, axes in CACHE_MESHES.items():
        for seq in (None, "model", "data"):
            kw = dict(mesh_axes=axes, seq_axis=seq)
            m = StreamModel(tcfg, Policy(**kw), device="meta", generator=None)
            jm = JModel(jcfg, JPolicy(**kw))
            for b in (1, 4, 6):
                _assert_same(m.cache_pspecs(b), jm.cache_pspecs(b), (mname, seq, b))


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_pspecs_match_jax(arch):
    """The reference's ``tests/test_quantized_serving.py:43`` for every
    full-width config: ``quantized_pspecs`` of the float tree's shapes has
    the tree of ``quantize_params``' output and equals the reference's
    entry for entry (the scales' trailing dim whole), on (data 2, model
    4); a model built with int8 weights gives its serve step's specs from
    it."""
    import jax

    from repro.models.model import quantize_params as jquantize, quantized_pspecs as jquantized_pspecs
    from repro_torch.models.model import quantized_pspecs

    jcfg, tcfg = _cfgs(arch, "full")
    kw = dict(mesh_axes={"data": 2, "model": 4})
    jm = JModel(jcfg, JPolicy(**kw))
    raw = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    want = jquantized_pspecs(raw, jm.param_pspecs())
    m = StreamModel(tcfg, Policy(**kw, weights_int8=True), device="meta", generator=None)
    got = quantized_pspecs(m.float_shapes(), m.param_pspecs())
    _assert_same(got, want, arch)
    q = jax.eval_shape(jquantize, raw)
    assert sorted(_flat(got)) == sorted("/".join(str(k.key) for k in path) for path, _ in
                                        jax.tree_util.tree_flatten_with_path(q)[0])
    assert sorted(_flat(got)) == sorted(_flat(jax.tree.map(lambda _: (), m.param_tree(),
                                                             is_leaf=lambda x: isinstance(x, torch.Tensor))))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_jax(arch):
    """``ArchConfig.param_count`` and ``active_param_count`` (shapes on the
    meta device) equal the reference's for the full-width config."""
    jcfg, tcfg = _cfgs(arch, "full")
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_cache_on_a_mesh_as_jax(arch):
    """The paged cache on a (1, 1) mesh: a dense "attn" pattern gets its
    pool (the kv heads ``wk`` holds), any other raises the reference's
    NotImplementedError with the reference's text."""
    from repro_torch.launch import make_mesh

    jcfg, tcfg = _cfgs(arch, "reduced")
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    m = StreamModel(tcfg, Policy.for_mesh(mesh, param_dtype="float32", compute_dtype="float32"), generator=None,
                    mesh=mesh)
    try:
        JModel(jcfg, JPolicy()).init_paged_cache(2, 4, 4, 2)
    except NotImplementedError as e:
        with pytest.raises(NotImplementedError) as got:
            m.init_paged_cache(2, 4, 4, 2)
        assert str(got.value) == str(e)
        return
    pool = m.init_paged_cache(2, 4, 4, 2)["slots"]["s0"]
    assert tuple(pool["k"].shape) == (m.n_groups, 4, 4, tcfg.n_kv_heads, tcfg.hd)
    assert tuple(pool["bt"].shape) == (m.n_groups, 2, 2)


class _OneRankOf:
    """Rank ``k`` of a sequence axis of ``n`` ranks whose collectives see
    only itself: the rank's own flash-decode statistics, unmerged."""

    axis_names = ("model",)

    def __init__(self, n: int, k: int):
        self.n, self.k = n, k

    def size(self, axes) -> int:
        return self.n if axes else 1

    def coord(self, axes) -> int:
        return self.k if axes else 0

    def group(self, axes):
        return None


def test_flash_decode_masks_with_inf_and_guards_an_empty_shard():
    """JAX's ``_flash_decode`` guards: scores outside a rank's valid slots
    are ``-inf`` (not the plain path's -1e30, whose exponentials would be
    1 on a rank with no valid slot), the max of a rank that holds none is
    taken as 0, and its exponentials are 0: that rank's share is exactly
    zero (no NaN, no stale values), and its cache is rewritten with what
    it held. A rank that holds the slot writes the token there and its
    share is the softmax over its valid slots."""
    from repro_torch.models import layers as L

    gen = torch.Generator().manual_seed(7)
    ap = L.AttnParams(n_heads=4, n_kv=2, head_dim=8)
    q, kn, vn = (torch.randn((1, 1, h, 8), generator=gen) for h in (4, 2, 2))
    pos = torch.tensor(5)  # global slot 5 of 16: rank 1's of 4
    for k in range(4):
        ck, cv = (torch.randn((1, 4, 2, 8), generator=gen) for _ in range(2))
        k0, v0 = ck.clone(), cv.clone()
        out = L._flash_decode(q, kn, vn, ck, cv, pos, ap, _OneRankOf(4, k), "model", ring=False)
        assert torch.isfinite(out).all()
        if k > 1:  # slots 8..15: none valid at position 5
            assert torch.equal(out, torch.zeros_like(out)) and torch.equal(ck, k0) and torch.equal(cv, v0)
            continue
        valid = 4 if k == 0 else 2  # rank 0 holds slots 0..3, rank 1 slots 4 and 5 of 4..7
        if k == 1:
            assert torch.equal(ck[:, 1], kn[:, 0]) and torch.equal(cv[:, 1], vn[:, 0])
            assert torch.equal(ck[:, 2:], k0[:, 2:]) and torch.equal(ck[:, 0], k0[:, 0])
        kr, vr = ck[:, :valid].repeat_interleave(2, dim=2), cv[:, :valid].repeat_interleave(2, dim=2)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, kr) / math.sqrt(8), dim=-1)
        torch.testing.assert_close(out, torch.einsum("bhqk,bkhd->bqhd", w, vr), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ one rank
@pytest.mark.parametrize("arch,opt", [("yi-6b", "adamw"), ("yi-6b", "adamw8bit"), ("mamba2-2.7b", "adamw"),
                                      ("qwen3-moe-30b-a3b", "adamw8bit"), ("whisper-tiny", "adamw")])
def test_mesh_of_one_rank_is_the_mesh_free_step(arch, opt):
    """Two steps on a (1, 1) mesh (no process group) against two steps
    without a mesh, from the same seed: the same losses and parameters to
    the bit."""
    from repro_torch.launch import make_mesh

    cfg = TC.get_reduced(arch)
    mk = {"adamw": adamw, "adamw8bit": adamw8bit}[opt]
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)))}
    if cfg.enc_dec:
        batch["frames"] = torch.from_numpy(rng.standard_normal((4, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    runs = []
    for on_mesh in (False, True):
        pol = Policy.for_mesh(mesh, param_dtype="float32", compute_dtype="float32") if on_mesh else \
            Policy("float32", "float32", "float32")
        m = StreamModel(cfg, pol, device="cpu", generator=11, mesh=mesh if on_mesh else None)
        m.requires_grad_(True)
        o = mk(1e-3)
        params = m.param_tree()
        state = {"params": params, "opt": o.init(params, mesh=mesh, pspecs=m.param_pspecs()) if on_mesh
                 else o.init(params)}
        step, specs = build_train_step(m, o, mesh=mesh if on_mesh else None)
        assert (specs is None) != on_mesh
        losses = []
        for _ in range(2):
            state, met = step(state, batch)
            losses.append(met["loss"].item())
        runs.append((losses, [p.detach().clone() for p in tree_leaves(state["params"])]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


# ------------------------------------------------------------ K1's offset
OFFSET_CALLS = [  # (Sq, Sk, H, Kv, D, causal, window, softcap, offset)
    (16, 64, 4, 2, 64, True, None, None, 48),   # the last block
    (16, 64, 4, 2, 64, True, None, None, 0),
    (24, 96, 2, 1, 32, True, 16, 50.0, 40),     # gemma2's window and softcap, mid-block
    (24, 96, 2, 1, 32, True, 16, 50.0, 72),
    (32, 128, 4, 4, 64, True, 40, None, 64),    # a window that binds, offset on a tile edge
    (8, 32, 2, 2, 16, False, 10, None, 24),     # a window alone, the last block (JAX's sliced span holds it)
    (8, 32, 2, 2, 16, False, None, None, 24),   # no mask: the offset moves nothing
]


def _jax_attention(q, k, v, causal, window, softcap, off):
    """JAX's ``_chunked_attention`` of (B, S, heads, D) arrays with the
    queries at positions off.. (``qpos_l`` of a context-parallel shard)."""
    sq, h, d = q.shape[1], q.shape[2], q.shape[3]
    ap = JAttnParams(n_heads=h, n_kv=k.shape[2], head_dim=d, causal=causal, window=window, softcap=softcap,
                     q_block=8)
    return _chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.arange(sq) + off,
                              jnp.arange(k.shape[1]), ap, grouped=ap.n_kv != ap.n_heads)


@pytest.mark.parametrize("sq,sk,h,kv,d,causal,window,cap,off", OFFSET_CALLS)
def test_attention_with_a_query_offset_matches_jax(sq, sk, h, kv, d, causal, window, cap, off):
    """``ref.mha(q_offset=)`` (through ``attention_op``'s CPU side and
    ``flash_attention``'s, with its base-2 row log-sum-exp) against JAX's
    ``_chunked_attention`` at offset positions, and the CPU backward
    against ``jax.vjp`` of it, each at ATTN_TOL of the largest element."""
    import jax

    from repro_torch.kernels.ops import attention_op

    rng = np.random.default_rng(sq * 31 + off)
    q, do = (rng.standard_normal((2, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, sk, kv, d)).astype(np.float32) for _ in range(2))
    want, vjp = jax.vjp(lambda a, b, c: _jax_attention(a, b, c, causal, window, cap, off), q, k, v)
    got = attention_op(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal, window=window, softcap=cap,
                       q_offset=off)
    want = np.asarray(want)
    assert float(np.abs(got.numpy() - want).max()) <= ATTN_TOL * float(np.abs(want).max())
    qt, kt, vt, dot = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v, do))
    out, lse = fa.flash_attention(qt, kt, vt, causal=causal, window=window, softcap=cap, return_lse=True,
                                  q_offset=off)
    np.testing.assert_array_equal(out.transpose(1, 2).numpy(), got.numpy())
    rep = h // kv
    sc = ref.scores(qt, kt.repeat_interleave(rep, 1), causal=causal, window=window, softcap=cap, q_offset=off)
    assert torch.equal(lse, torch.logsumexp(sc, -1) * (1 / np.log(2.0)))
    grads = fa.flash_attention_bwd(qt, kt, vt, out, dot, lse, causal=causal, window=window, softcap=cap, q_offset=off)
    for g, w in zip(grads, vjp(do)):
        w = np.asarray(w)
        assert float(np.abs(g.transpose(1, 2).numpy() - w).max()) <= ATTN_TOL * max(float(np.abs(w).max()), 1e-30)


def test_offset_zero_is_the_call_of_before():
    """q_offset 0 at Sq == Sk gives the bits of the call without it."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 40, 32)).astype(np.float32)) for _ in range(3))
    for kw in ({"causal": True}, {"causal": True, "window": 9, "softcap": 30.0}, {"causal": False}):
        assert torch.equal(fa.flash_attention(q, k, v, **kw), fa.flash_attention(q, k, v, q_offset=0, **kw))
        assert torch.equal(ref.mha(q, k, v, **kw), ref.mha(q, k, v, q_offset=0, **kw))


@pytest.mark.parametrize("sq,sk,off,kw", [
    (16, 64, 49, {"causal": True}),              # past the keys' end
    (16, 64, -1, {"causal": True}),              # negative
    (16, 8, 0, {"causal": True}),                # more queries than keys under a mask
    (16, 64, 50, {"causal": False}),             # an offset without a mask still lies within the keys
])
def test_an_offset_outside_the_keys_is_refused(sq, sk, off, kw):
    """0 <= q_offset and q_offset + Sq <= Sk under a mask or with an
    offset; anything else raises in the forward and the backward."""
    q = torch.zeros((1, 2, sq, 16))
    k = torch.zeros((1, 2, sk, 16))
    with pytest.raises(ValueError, match="q_offset|different lengths|>= 0"):
        fa.flash_attention(q, k, k, q_offset=off, **kw)
    with pytest.raises(ValueError, match="q_offset|different lengths|>= 0"):
        fa.flash_attention_bwd(q, k, k, q, q, torch.zeros(q.shape[:3]), q_offset=off, **kw)


# ------------------------------------------------------------ K2's layout on a rank's heads
@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16])
def test_ssd_layout_on_a_ranks_heads(tp):
    """At mamba2-2.7b's full width (d_inner 5120, 80 heads of 64, one group
    of 128) the mixer's bf16 x, B and C views of one rank's heads pass
    ``ssd_scan.check_layout`` for every model axis that splits the heads:
    the mixer needs no copy before K2."""
    sp = TC.get("mamba2-2.7b").ssm
    din, gn = sp.d_inner // tp, sp.n_groups * sp.state_dim
    b, s = 2, 1024
    xh = torch.empty((b, s, din), dtype=torch.bfloat16, device="meta")  # causal_conv's output
    bc = torch.empty((b, s, 2 * gn), dtype=torch.bfloat16, device="meta")
    x = xh.reshape(b, s, din // sp.head_dim, sp.head_dim).transpose(1, 2)
    views = {"x": x, "B": bc[..., :gn].reshape(b, s, sp.n_groups, sp.state_dim).transpose(1, 2),
             "C": bc[..., gn:].reshape(b, s, sp.n_groups, sp.state_dim).transpose(1, 2)}
    for name, t in views.items():
        offset = t.storage_offset() * t.element_size()
        ssd_scan.check_layout(name, t.shape, t.stride(), offset, t.dtype)


# ------------------------------------------------------------ ShardedFeeder
def test_sharded_feeder_on_one_rank_places_batches():
    """The reference's ``test_sharded_feeder_places_batches``: on a mesh of
    one rank the feeder hands out every batch whole, in order."""
    from repro_torch.data.pipeline import ShardedFeeder
    from repro_torch.launch import make_mesh

    mesh = make_mesh((1,), ("data",), device="cpu")
    feeder = ShardedFeeder(mesh, ("data",), prefetch=1)
    batches = [{"x": np.ones((4, 2)) * i} for i in range(5)]
    out = list(feeder(iter(batches)))
    assert len(out) == 5
    assert float(out[3]["x"][0, 0]) == 3.0 and tuple(out[3]["x"].shape) == (4, 2)


def test_production_mesh_does_not_carry_over():
    """The reference's TPU v5e production meshes have no card counterpart."""
    from repro_torch.launch import make_production_mesh

    with pytest.raises(NotImplementedError, match="TPU v5e"):
        make_production_mesh()
