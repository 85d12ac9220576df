"""Model assembler (port of ``repro.models.model``): block patterns on one device.

``StreamModel`` is an ``nn.Module`` holding the JAX package's parameter
tree with the same nested keys and shapes: one stack per position of the
pattern, ``slots/s{i}``, its leaves stacked on ``n_groups = n_layers //
len(pattern)`` (``slots/s0/mixer/wq`` is ``(n_groups, d, H, hd)``), and
the leftover layers as ``tail/s{i}`` with a leading dim of 1, so that
``convert.params_from_jax`` moves weights across one for one. The layers
run group by group, each group's slots in pattern order, then the tail,
as a Python loop.

Block kinds ``attn`` (dense: yi-6b, qwen2, mistral), ``local`` (sliding
window with a ring decode cache: gemma2, recurrentgemma), ``ssm``
(Mamba-2, mamba2), ``rec`` (RG-LRU, recurrentgemma), ``bidir`` (the
encoder's bidirectional attention) and ``encdec`` (a decoder block:
causal self attention, ``norm_x``, then cross attention over the
encoder's states, whisper) are ported, with or without an MLP or an MoE
FFN in its place (qwen3-moe; with arctic's dense residual beside it),
tied or untied embeddings, gemma's embedding scale, gemma2's sandwich
norms (``post1`` / ``post2``) and attention and final logit softcaps,
qwen2's QKV bias (``bq`` / ``bk`` / ``bv``), RMS or layer norm
(``norm == "ln"``: every norm a ``{"w", "b"}`` part), learned positions
(``pos_embed``, added after the embedding), pixtral's patch frontend
(``frontend == "patches"``: precomputed patch embeddings, cast to the
compute dtype and put in front of the token embeddings, positions
running over both, as JAX's stub does) and whisper's encoder
(``enc_dec``, ``frontend == "frames"``: precomputed frame embeddings
plus a sinusoid through ``enc_layers`` ``bidir`` blocks and a final
norm, the tree's ``encoder``; every entry point takes the frames).
``_unsupported`` names what is refused: an ``enc_dec`` config with no
``encdec`` slot to read the encoder (or such a slot with no encoder),
frames without an encoder, an encoder beside an MoE. Caches keep the JAX layout,
stacked on the group dim for slots and not for the tail, and are updated
in place; a KV cache may be ``float8_e4m3fn`` (``Policy.kv_cache_dtype``
or ``cache_dtype``). The paged cache serves the dense pattern only, as in
JAX.

int8 weights (``Policy(weights_int8=True)``, serving): the leaves that
JAX's ``quantize_params`` quantizes (``_should_quantize``: a float leaf
of the layer stacks with ``ndim >= 2`` and at least 64Ki elements,
decided on the stacked leaf) are ``{"q8": int8, "scale": f32}`` buffers,
so ``param_tree()`` has the structure of ``quantize_params(params)`` and
``load_params`` takes it. A layer is dequantized to the compute dtype
where it runs and freed with it, as JAX dequantizes inside the block;
``init`` draws one layer at a time and keeps only its codes.

Training: :meth:`StreamModel.hidden` and the chunked
:meth:`StreamModel.loss` take a parameter tree in the JAX layout (the
model's own, ``param_tree()``, whose leaves are its parameters) as the
JAX functions do, and are differentiable. The parameters are built with
``requires_grad=False`` for serving; a trainer turns it on
(``requires_grad_(True)``). Under ``Policy.remat`` "full" or "block" a
training pass recomputes each layer group's forward in its backward (a
group is one pass over the pattern; whisper's encoder layers one each;
the tail layers are kept), as JAX's ``jax.checkpoint`` of its scan body
does: the gradients are the same bits, and the backward keeps each
group's input and rebuilds one group's activations at a time.

Training on a mesh (``StreamModel(cfg, policy, mesh=...)``, the port's
``sharding.Mesh`` and a policy with its axes, ``Policy.for_mesh``). Each
rank holds its block of every leaf, cut by :func:`param_pspecs` (JAX's
``param_pspecs``, entry for entry), and ``param_tree()`` is that rank's
blocks; ``loss`` takes the rank's rows of the global batch (its data
coordinate's) and returns the global batch's loss, the same number on
every rank. The layers run JAX's strategies with explicit collectives
(``sharding``): the heads, ``d_ff``, the SSD heads, the RG-LRU channels
and the experts split over the model axis, with each row-parallel
product summed over it; attention whose heads do not divide runs
context-parallel (``layers.attn_strategy``); a ZeRO-3 ``d_model`` dim is
gathered where a layer uses it; the embedding and the chunked loss are
vocab-parallel where the model axis divides the padded vocab (the loss's
log-sum-exp and label pick are sums over the model axis, so full-vocab
logits are never gathered). A trainer back-propagates the loss divided
by the world size and sums each leaf's gradient over the axes its spec
does not split (``train.trainer.build_train_step(mesh=)``). Without a
mesh every path is the one of before; a mesh of one rank runs the same
operations.

Serving on a mesh (``forward``, ``prefill``, ``decode_step``): every
rank passes the whole batch and gets the whole batch's logits; it runs
the rows ``batch_spec`` gives it (the rows and the vocab-split logits
gathered at the end) through the training strategies, and holds its
block of the decode cache (:meth:`StreamModel.init_cache`). Where the
cache lies follows what the decode reads (:meth:`_state_specs`): with
``Policy.seq_axis`` each rank holds its slice of the sequence and every kv
head, and the decode runs JAX's flash-decode (``layers._flash_decode``);
without it the kv heads split as ``wk``'s do. :meth:`cache_pspecs` is
JAX's, entry for entry (it can name the model axis twice; JAX places no
cache by it either). int8 weights on a mesh are cut by
:func:`quantized_pspecs`, and each rank dequantizes its blocks.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models import rglru as R
from repro_torch.models import sharding as SH
from repro_torch.models import ssm as M
from repro_torch.models.layers import AttnParams, cache_bits, to_cache
from repro_torch.models.moe import F32_LEAVES as MOE_F32
from repro_torch.models.moe import MoEParams, moe_ffn, moe_init, moe_pspecs, moe_shapes
from repro_torch.models.policy import P, Policy, torch_dtype
from repro_torch.models.rglru import RGLRUParams
from repro_torch.models.ssm import SSMParams

__all__ = [
    "BLOCK_SAVED", "ArchConfig", "StreamModel", "block_policy", "block_pspecs", "param_pspecs", "quantize_params",
    "quantized_pspecs",
]

# ``Policy.remat == "block"`` keeps the outputs of these ops, JAX's
# ``dots_with_no_batch_dims_saveable``: ``x @ w`` on a 3-D x folds its
# leading dims into one ``aten.mm``, so the batch-free projections reach
# them, while ``bmm`` (the experts) and every einsum with a batch dimension
# (attention, the RG-LRU's block-diagonal gates) is recomputed, like the
# kernels' custom Functions, whose launches no dispatch mode sees.
BLOCK_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def block_policy(ctx, op, *args, **kwargs):
    """The selective checkpoint's policy of ``"block"``: save
    :data:`BLOCK_SAVED`, recompute the rest."""
    cp = torch.utils.checkpoint.CheckpointPolicy
    return cp.MUST_SAVE if op in BLOCK_SAVED else cp.PREFER_RECOMPUTE


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    pattern: tuple[str, ...] = ("attn",)
    window: int | None = None
    attn_softcap: float | None = None
    final_softcap: float | None = None
    attn_bias: bool = False
    rope_theta: float = 10000.0
    mlp_kind: str = "gated"  # gated | plain | none
    mlp_act: str = "silu"
    norm: str = "rms"  # rms | ln
    norm_plus_one: bool = False
    post_norms: bool = False  # gemma2 sandwich norms
    embed_scale: bool = False
    tie_embeddings: bool = False
    moe: MoEParams | None = None
    ssm: SSMParams | None = None
    rglru: RGLRUParams | None = None
    enc_dec: bool = False
    enc_layers: int = 0
    enc_seq: int = 0
    frontend: str = "none"  # none | frames | patches
    frontend_len: int = 0
    norm_eps: float = 1e-6
    learned_pos: bool = False
    max_learned_pos: int = 32768
    q_block: int = 512

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // 128) * 128

    def attn_params(self, kind: str) -> AttnParams:
        return AttnParams(
            n_heads=self.n_heads,
            n_kv=self.n_kv_heads,
            head_dim=self.hd,
            rope_theta=self.rope_theta,
            use_rope=not self.learned_pos,
            causal=kind != "bidir",
            window=self.window if kind == "local" else None,
            softcap=self.attn_softcap,
            bias=self.attn_bias,
            cross=kind == "cross",
        )

    # ------------------------------------------------------------ accounting
    def param_count(self) -> int:
        """Every parameter of the tree ``init`` builds (JAX's
        ``param_count``), counted on the meta device: no weight drawn."""
        model = StreamModel(self, Policy(), device="meta", generator=None)
        return sum(t.numel() for t in _leaves(model.param_tree()))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        total = self.param_count()
        if self.moe is None:
            return total
        per_expert = 3 * self.d_model * self.moe.d_ff
        moe_total = self.n_layers * self.moe.n_experts * per_expert
        moe_active = self.n_layers * self.moe.top_k * per_expert
        return total - moe_total + moe_active


def _leaves(tree) -> list:
    """A nested dict's leaves, in key order."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    return [tree]


_KINDS = ("attn", "local", "ssm", "rec", "bidir", "encdec")
_ATTN_KINDS = ("attn", "local", "bidir", "encdec")  # the kinds whose mixer is attention


def _unsupported(cfg: ArchConfig) -> list[str]:
    """The fields of ``cfg`` the port refuses. An encoder is read only by
    ``encdec`` slots, so ``enc_dec`` without one is refused, as is an
    ``encdec`` slot with no encoder, frames with no encoder to take them,
    and an encoder beside an MoE (JAX builds the encoder's blocks with the
    MoE's leaves and runs them without: no config does it)."""
    checks = {
        f"pattern {cfg.pattern!r}": not cfg.pattern or any(k not in _KINDS for k in cfg.pattern),
        "ssm pattern without SSMParams": "ssm" in cfg.pattern and cfg.ssm is None,
        "rec pattern without RGLRUParams": "rec" in cfg.pattern and cfg.rglru is None,
        "moe not a MoEParams": cfg.moe is not None and not isinstance(cfg.moe, MoEParams),
        "enc_dec without an encdec slot": cfg.enc_dec and "encdec" not in cfg.pattern,
        "encdec slot without enc_dec": "encdec" in cfg.pattern and not cfg.enc_dec,
        "enc_dec with moe": cfg.enc_dec and cfg.moe is not None,
        f"frontend {cfg.frontend!r}": cfg.frontend not in ("none", "patches", "frames"),
        "frames without enc_dec": cfg.frontend == "frames" and not cfg.enc_dec,
        f"norm {cfg.norm!r}": cfg.norm not in ("rms", "ln"),
        f"mlp_kind {cfg.mlp_kind!r}": cfg.mlp_kind not in ("gated", "plain", "none"),
    }
    return [k for k, bad in checks.items() if bad]


# ------------------------------------------------------------- int8 weights
_Q8_MIN_SIZE = 1 << 16
_Q8_SUBTREES = ("slots", "tail", "encoder")


def _is_q8(x) -> bool:
    return isinstance(x, dict) and "q8" in x


def _q8_shape(shape) -> bool:
    return len(shape) >= 2 and math.prod(shape) >= _Q8_MIN_SIZE


def _should_quantize(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.is_floating_point() and _q8_shape(tuple(leaf.shape))


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's arithmetic on one slice: in f32, ``scale = max|x| / 127`` over
    the trailing dim, codes ``clip(round(x / scale), -127, 127)`` (a zero
    scale divides by 1; round half to even in both). Returns (int8, f32)."""
    x = x.float()
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.round(x / safe).clamp_(-127, 127).to(torch.int8)
    return codes, scale


def _quantize_leaf(leaf: torch.Tensor) -> dict:
    """``{"q8", "scale"}`` of a leaf, worked through in slices of its
    leading dim (the scale is per trailing row: the same bits as at once)."""
    q8 = torch.empty(leaf.shape, dtype=torch.int8, device=leaf.device)
    scale = torch.empty(leaf.shape[:-1] + (1,), dtype=torch.float32, device=leaf.device)
    for i in range(leaf.shape[0]):
        q8[i], scale[i] = _quantize(leaf[i])
    return {"q8": q8, "scale": scale}


def quantize_params(params: dict) -> dict:
    """Post-training int8 weight quantization for serving (port of JAX's
    ``quantize_params``): every leaf of the layer stacks that
    ``_should_quantize`` picks becomes ``{"q8": int8 codes, "scale": f32
    per-row (trailing-dim absmax) scales}``; the embeddings and the rest
    are the same tensors."""

    def one(tree):
        if isinstance(tree, dict):
            return {k: one(v) for k, v in tree.items()}
        return _quantize_leaf(tree) if _should_quantize(tree) else tree

    return {k: one(v) if k in _Q8_SUBTREES else v for k, v in params.items()}


def _scale_spec(spec, ndim: int) -> P:
    """An int8 leaf's scales' spec: its codes' spec with the trailing dim
    whole (each scale covers a whole trailing row)."""
    base = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return P(*base[:-1], None)


def quantized_pspecs(params, pspecs: dict) -> dict:
    """JAX's ``quantized_pspecs``: a parameter spec tree turned to match
    ``quantize_params(params)``. ``params`` is the float tree (its shapes
    and dtypes are read: tensors on the meta device do); a leaf that
    ``_should_quantize`` picks gets ``{"q8": its spec, "scale": its spec
    with the trailing dim whole}``."""

    def one(leaf, spec):
        if isinstance(leaf, dict):
            return {k: one(leaf[k], spec[k]) for k in leaf}
        return {"q8": spec, "scale": _scale_spec(spec, leaf.dim())} if _should_quantize(leaf) else spec

    return {k: one(params[k], v) if k in _Q8_SUBTREES else v for k, v in pspecs.items()}


def _dq_leaf(leaf, dtype):
    if _is_q8(leaf):
        return leaf["q8"].to(torch.float32).mul_(leaf["scale"]).to(dtype)
    return leaf


def _dq_tree(tree, dtype):
    def one(t):
        if _is_q8(t) or not isinstance(t, dict):
            return _dq_leaf(t, dtype)
        return {k: one(v) for k, v in t.items()}

    return one(tree)


class _Q8(nn.Module):
    """An int8 leaf as ``quantize_params`` leaves it: codes and their f32
    trailing-dim scales, buffers (served, not trained)."""

    def __init__(self, shape: tuple, device):
        super().__init__()
        self.register_buffer("q8", torch.empty(shape, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.empty(shape[:-1] + (1,), dtype=torch.float32, device=device))

    def leaf(self) -> dict:
        return {"q8": self.q8, "scale": self.scale}


class _Part(nn.Module):
    """A block part holding int8 leaves (``_Q8``) beside float parameters,
    read as a dict of leaves as an ``nn.ParameterDict`` is."""

    def __init__(self, params: nn.ParameterDict, q8: dict, order: list[str]):
        super().__init__()
        self.p = params
        self.q = nn.ModuleDict(q8)
        self.order = order

    def __getitem__(self, k: str):
        return self.q[k].leaf() if k in self.q else self.p[k]

    def items(self) -> list[tuple[str, Any]]:
        return [(k, self[k]) for k in self.order]


def _params(shapes: dict, dtype, device, f32: tuple[str, ...] = (), q8: bool = False, whole: dict | None = None
            ) -> nn.Module:
    """Empty parameters of ``dtype``; the leaves named in ``f32`` are
    float32. With ``q8`` the leaves that ``_should_quantize`` would pick
    are int8 ``_Q8`` pairs instead (then a ``_Part``), picked by their
    ``whole`` shapes where ``shapes`` are a rank's blocks of them."""
    big = [k for k, s in (whole or shapes).items() if q8 and _q8_shape(s)]
    params = nn.ParameterDict({
        k: nn.Parameter(
            torch.empty(s, dtype=torch.float32 if k in f32 else dtype, device=device),
            requires_grad=False,
        )
        for k, s in shapes.items() if k not in big
    })
    if not big:
        return params
    return _Part(params, {k: _Q8(shapes[k], device) for k in big}, list(shapes))


def _unbind(leaf) -> list:
    """A stacked leaf's per-layer views (an int8 pair's, pair by pair)."""
    if _is_q8(leaf):
        return [{"q8": q, "scale": sc} for q, sc in zip(leaf["q8"].unbind(0), leaf["scale"].unbind(0))]
    return leaf.unbind(0)


def _init_norm(part: dict) -> None:
    """A norm's JAX init: weights ones, a layer norm's biases zeros."""
    part["w"].fill_(1.0)
    if "b" in part:
        part["b"].zero_()


# --------------------------------------------------------------- the specs
def _norm_pspecs(norm: str) -> dict:
    return {"w": P(None, None), "b": P(None, None)} if norm == "ln" else {"w": P(None, None)}


def block_pspecs(cfg: ArchConfig, pol: Policy, kind: str) -> dict:
    """JAX's ``StreamModel._block_pspecs``: one slot's specs, with the
    leading layer dim of its stacked leaves."""
    blk: dict[str, Any] = {"norm1": _norm_pspecs(cfg.norm)}
    if kind in ("attn", "local", "bidir"):
        blk["mixer"] = L.attention_pspecs(pol, cfg.d_model, cfg.attn_params(kind))
    elif kind == "ssm":
        blk["mixer"] = M.ssm_pspecs(pol, cfg.d_model, cfg.ssm)
    elif kind == "rec":
        blk["mixer"] = R.rglru_pspecs(pol, cfg.d_model, cfg.rglru)
    elif kind == "encdec":
        blk["mixer"] = L.attention_pspecs(pol, cfg.d_model, cfg.attn_params("attn"))
        blk["norm_x"] = _norm_pspecs(cfg.norm)
        blk["cross"] = L.attention_pspecs(pol, cfg.d_model, cfg.attn_params("cross"))
    if cfg.post_norms:
        blk["post1"] = _norm_pspecs(cfg.norm)
    if cfg.mlp_kind != "none" or cfg.moe is not None:
        blk["norm2"] = _norm_pspecs(cfg.norm)
        if cfg.moe is not None:
            blk["moe"] = moe_pspecs(pol, cfg.d_model, cfg.moe)
            if cfg.moe.dense_residual:
                blk["mlp"] = L.mlp_pspecs(pol, cfg.d_model, cfg.d_ff, "gated")
        else:
            blk["mlp"] = L.mlp_pspecs(pol, cfg.d_model, cfg.d_ff, "gated" if cfg.mlp_kind == "gated" else "plain")
        if cfg.post_norms:
            blk["post2"] = _norm_pspecs(cfg.norm)
    return blk


def param_pspecs(cfg: ArchConfig, pol: Policy) -> dict:
    """JAX's ``StreamModel.param_pspecs``: the spec of every leaf of the
    parameter tree under ``pol``'s mesh axes (no mesh, no allocation)."""
    n_groups = cfg.n_layers // len(cfg.pattern)
    tail = cfg.n_layers - n_groups * len(cfg.pattern)
    vtp = pol.tp(cfg.vocab_padded)
    specs: dict[str, Any] = {
        "embed": P(vtp, pol.fsdp(cfg.d_model, has_tp=vtp is not None)),
        "final_norm": _norm_pspecs(cfg.norm),
        "slots": {f"s{i}": block_pspecs(cfg, pol, k) for i, k in enumerate(cfg.pattern)},
    }
    if tail:
        specs["tail"] = {f"s{i}": block_pspecs(cfg, pol, cfg.pattern[i]) for i in range(tail)}
    if not cfg.tie_embeddings:
        specs["unembed"] = P(pol.fsdp(cfg.d_model, has_tp=vtp is not None), vtp)
    if cfg.learned_pos:
        specs["pos_embed"] = P(None, pol.fsdp(cfg.d_model))
    if cfg.enc_dec:
        specs["encoder"] = {"slots": {"s0": block_pspecs(cfg, pol, "bidir")}, "final_norm": _norm_pspecs(cfg.norm)}
    return specs


class StreamModel(nn.Module):
    """Decoder of a block pattern with explicit caches; parameters in the JAX tree layout."""

    def __init__(
        self,
        cfg: ArchConfig,
        policy: Policy = Policy(),
        *,
        device: str | torch.device | None = None,
        generator: torch.Generator | int | None = 0,
        mesh: SH.Mesh | None = None,
    ):
        super().__init__()
        bad = _unsupported(cfg)
        if bad:
            raise NotImplementedError(f"{cfg.name}: not ported yet: {', '.join(bad)}")
        self.cfg = cfg
        self.policy = policy
        self.mesh = mesh
        self._specs = None  # the parameters' specs on a mesh
        if mesh is not None:
            if dict(policy.mesh_axes) != dict(mesh.sizes):
                raise ValueError(
                    f"policy.mesh_axes {dict(policy.mesh_axes)} are not the mesh's {dict(mesh.sizes)}: "
                    "build the policy with Policy.for_mesh(mesh)"
                )
            self._specs = param_pspecs(cfg, policy)
            kinds = set(cfg.pattern) | ({"bidir"} if cfg.enc_dec else set())
            self._layer_specs = {k: SH.layer_specs(block_pspecs(cfg, policy, k)) for k in kinds}
            device = mesh.device if device is None else device
        self.device = resolve_device(device)
        pat = cfg.pattern
        self.n_groups = cfg.n_layers // len(pat)
        self.tail = cfg.n_layers - self.n_groups * len(pat)  # leftover layers
        dtype = torch_dtype(policy.param_dtype)
        d = cfg.d_model
        q8 = policy.weights_int8
        sp = self._specs or {}

        def spec(*path):  # the spec (sub)tree at path on a mesh, else None
            t = sp
            for key in path:
                t = t.get(key) if isinstance(t, dict) else None
            return t

        self.tree = nn.ModuleDict({
            "embed": _params({"w": self._shape((cfg.vocab_padded, d), spec("embed"))}, dtype, self.device),
            "final_norm": self._norm_params(1, dtype),
            "slots": nn.ModuleDict({
                f"s{i}": self._block(k, self.n_groups, dtype, q8, spec("slots", f"s{i}")) for i, k in enumerate(pat)
            }),
        })
        if self.tail:
            self.tree["tail"] = nn.ModuleDict({
                f"s{i}": self._block(pat[i], 1, dtype, q8, spec("tail", f"s{i}")) for i in range(self.tail)
            })
        if not cfg.tie_embeddings:
            self.tree["unembed"] = _params({"w": self._shape((d, cfg.vocab_padded), spec("unembed"))}, dtype,
                                           self.device)
        if cfg.learned_pos:
            self.tree["pos_embed"] = _params({"w": self._shape((cfg.max_learned_pos, d), spec("pos_embed"))}, dtype,
                                             self.device)
        if cfg.enc_dec:  # JAX's tree: {"slots": {"s0": the bidir stack}, "final_norm"}
            self.tree["encoder"] = nn.ModuleDict({
                "slots": nn.ModuleDict({"s0": self._block("bidir", cfg.enc_layers, dtype, q8,
                                                          spec("encoder", "slots", "s0"))}),
                "final_norm": self._norm_params(1, dtype),
            })
        self._layers: dict[str, list[tuple]] = {}  # serving's per-layer views, by stack
        self._rows: tuple[str, ...] | None = None  # on a mesh, the axes a served batch's rows split over
        if generator is not None:
            self.init(generator)

    def _norm_params(self, n: int, dtype, q8: bool = False) -> nn.Module:
        """A norm's parts stacked over ``n``: ``w``, and ``b`` for layer norm."""
        d = self.cfg.d_model
        shapes = {"w": (n, d), "b": (n, d)} if self.cfg.norm == "ln" else {"w": (n, d)}
        return _params(shapes, dtype, self.device, q8=q8)

    def _shape(self, shape: tuple, spec) -> tuple:
        """The shape of this rank's block of a leaf of ``shape`` (itself
        without a spec)."""
        return tuple(shape) if spec is None else SH.local_shape(shape, spec, self.mesh)

    def _block(self, kind: str, n: int, dtype, q8: bool = False, specs: dict | None = None) -> nn.ModuleDict:
        """One slot's parameters, stacked over ``n`` layers (with ``q8``,
        the leaves JAX's ``quantize_params`` picks as int8 pairs; with the
        slot's ``specs`` on a mesh, this rank's blocks)."""
        cfg = self.cfg
        d, f = cfg.d_model, cfg.d_ff
        dev = self.device

        def part(name: str, shapes: dict, f32: tuple[str, ...] = ()) -> nn.Module:
            whole = shapes
            if specs is not None:  # this rank's blocks
                shapes = {k: self._shape(v, specs[name][k]) for k, v in shapes.items()}
            return _params(shapes, dtype, dev, f32=f32, q8=q8, whole=whole)

        block = nn.ModuleDict({"norm1": self._norm_params(n, dtype, q8)})
        if kind == "ssm":
            block["mixer"] = part("mixer", M.ssm_shapes(n, d, cfg.ssm), M.F32_LEAVES)
        elif kind == "rec":
            block["mixer"] = part("mixer", R.rglru_shapes(n, d, cfg.rglru), R.F32_LEAVES)
        else:
            hd = cfg.hd
            shapes = {
                "wq": (n, d, cfg.n_heads, hd),
                "wk": (n, d, cfg.n_kv_heads, hd),
                "wv": (n, d, cfg.n_kv_heads, hd),
                "wo": (n, cfg.n_heads, hd, d),
            }
            if cfg.attn_bias:  # qwen2: JAX's layers.attention_init
                shapes.update(bq=(n, cfg.n_heads, hd), bk=(n, cfg.n_kv_heads, hd), bv=(n, cfg.n_kv_heads, hd))
            block["mixer"] = part("mixer", shapes)
            if kind == "encdec":  # whisper's decoder block: the cross attention's norm and weights
                block["norm_x"] = self._norm_params(n, dtype, q8)
                block["cross"] = part("cross", shapes)
        if cfg.post_norms:  # gemma2's sandwich norm of the mixer's output
            block["post1"] = self._norm_params(n, dtype, q8)
        if cfg.mlp_kind != "none" or cfg.moe is not None:
            block["norm2"] = self._norm_params(n, dtype, q8)
            mlp_shapes = {"w_in": (n, d, f), "w_out": (n, f, d)}
            if cfg.mlp_kind == "gated" or cfg.moe is not None:  # arctic's dense MLP is always gated
                mlp_shapes["w_gate"] = (n, d, f)
            if cfg.moe is not None:  # the MoE FFN, with arctic's dense MLP beside it
                block["moe"] = part("moe", moe_shapes(n, d, cfg.moe), MOE_F32)
                if cfg.moe.dense_residual:
                    block["mlp"] = part("mlp", mlp_shapes)
            else:
                block["mlp"] = part("mlp", mlp_shapes)
            if cfg.post_norms:  # ... and of the MLP's
                block["post2"] = self._norm_params(n, dtype, q8)
        return block

    def _blocks(self):
        """(section, slot name, kind, stacked params, layers in the stack)
        of every block stack, the encoder's as section ``encoder``."""
        pat = self.cfg.pattern
        for sec in ("slots", "tail"):
            if sec in self.tree:
                for name, blk in self.tree[sec].items():
                    yield sec, name, pat[int(name[1:])], blk, self.n_groups if sec == "slots" else 1
        if "encoder" in self.tree:
            yield "encoder", "s0", "bidir", self.tree["encoder"]["slots"]["s0"], self.cfg.enc_layers

    # ------------------------------------------------------------ parameters
    def param_tree(self) -> dict:
        """The parameters as the JAX package's nested dict (``embed``,
        ``unembed`` and ``pos_embed`` are leaves there, so they are here; a
        tied model has no ``unembed``, a model whose layers fill whole
        groups no ``tail``; an encoder is ``{"slots": {"s0": ...},
        "final_norm"}``)."""
        t = self.tree
        tree: dict[str, Any] = {"embed": t["embed"]["w"], "final_norm": dict(t["final_norm"].items())}
        for sec, name, _, blk, _ in self._blocks():
            parts = {part: dict(sub.items()) for part, sub in blk.items()}
            if sec == "encoder":
                tree[sec] = {"slots": {name: parts}, "final_norm": dict(t[sec]["final_norm"].items())}
            else:
                tree.setdefault(sec, {})[name] = parts
        if "unembed" in t:
            tree["unembed"] = t["unembed"]["w"]
        if "pos_embed" in t:
            tree["pos_embed"] = t["pos_embed"]["w"]
        return tree

    @torch.no_grad()
    def load_params(self, tree: dict) -> None:
        """Copy a tree in the JAX layout (torch tensors) into the parameters."""

        def copy(dst, src, path):
            if isinstance(dst, dict):
                if set(dst) != set(src):
                    raise KeyError(f"{path or '<root>'}: keys {sorted(src)} != {sorted(dst)}")
                for k in dst:
                    copy(dst[k], src[k], f"{path}/{k}" if path else k)
                return
            if tuple(dst.shape) != tuple(src.shape):
                raise ValueError(f"{path}: shape {tuple(src.shape)} != {tuple(dst.shape)}")
            dst.copy_(src)

        copy(self.param_tree(), tree, "")
        self._layers = {}

    @torch.no_grad()
    def init(self, generator: torch.Generator | int) -> dict:
        """Random weights with the JAX init's scales (``layers._normal``,
        ``ssm.ssm_init``, ``rglru.rglru_init``, ``moe.moe_init``): normal /
        sqrt(fan_in), drawn in f32 and cast; norms (the sandwich norms too)
        are ones and QKV biases zeros; the SSM's decays, skips and dt
        biases are its fixed values, the RG-LRU's Lambda is drawn from its
        uniform law. An int seeds a new generator on the model's device.
        An int8 model draws each block stack one layer at a time in the
        parameter dtype and keeps that layer's codes, so the float model
        is never whole (the codes equal ``quantize_params`` of the layers
        drawn). On a mesh of several ranks each leaf is drawn whole and
        cut to this rank's block (:meth:`_init_blocks`). Returns the
        parameter tree (``param_tree()``), as the JAX ``init`` returns its
        params."""
        if self.mesh is not None and self.mesh.world > 1:
            return self._init_blocks(generator)
        normal, uniform = self._drawers(generator)
        d = self.cfg.d_model
        tree = self.param_tree()
        normal(tree["embed"], 1.0 / math.sqrt(d))
        for norm in [tree["final_norm"]] + ([tree["encoder"]["final_norm"]] if "encoder" in tree else []):
            _init_norm(norm)
        for sec, name, kind, _, n in self._blocks():
            blk = tree[sec]["slots"][name] if sec == "encoder" else tree[sec][name]
            if not self.policy.weights_int8:
                self._init_block(kind, blk, normal, uniform)
                continue
            one = self._block(kind, 1, torch_dtype(self.policy.param_dtype))
            one = {part: dict(sub.items()) for part, sub in one.items()}
            for i in range(n):
                self._init_block(kind, one, normal, uniform)
                for part, sub in blk.items():
                    for k, dst in sub.items():
                        if _is_q8(dst):
                            dst["q8"][i], dst["scale"][i] = _quantize(one[part][k][0])
                        else:
                            dst[i].copy_(one[part][k][0])
            del one
        if "unembed" in tree:
            normal(tree["unembed"], 1.0 / math.sqrt(d))
        if "pos_embed" in tree:  # JAX's scale for learned positions
            normal(tree["pos_embed"], 0.02)
        self._layers = {}
        return tree

    def _drawers(self, generator: torch.Generator | int):
        """(normal, uniform): ``normal(t, scale)`` draws a scaled standard
        normal into t, ``uniform(t, lo, hi)`` a uniform one, both in f32 on
        the model's device from ``generator`` (an int seeds a new one)."""
        if isinstance(generator, int):
            generator = torch.Generator(device=self.device).manual_seed(generator)

        def normal(p, scale):
            x = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=self.device)
            p.copy_(x.mul_(scale))

        def uniform(p, lo, hi):
            x = torch.rand(p.shape, generator=generator, dtype=torch.float32, device=self.device)
            p.copy_(x.mul_(hi - lo).add_(lo))

        return normal, uniform

    @torch.no_grad()
    def _init_blocks(self, generator: torch.Generator | int) -> dict:
        """:meth:`init` on a mesh of several ranks: every rank seeds the
        same generator and draws every leaf whole, a stacked leaf one layer
        at a time (as the int8 init does), and keeps its block of it. The
        draws are not those of the mesh-free init, which draws a stack at
        once: a mesh run that must equal a mesh-free one loads the same
        weights (``load_params`` of ``sharding.shard_tree``)."""
        normal, uniform = self._drawers(generator)
        cfg, mesh, specs = self.cfg, self.mesh, self._specs
        d = cfg.d_model

        def whole(dst, shape, spec, scale):
            x = torch.empty(shape, dtype=torch.float32, device=self.device)
            normal(x, scale)
            dst.copy_(SH.cut(x, spec, mesh))

        tree = self.param_tree()
        whole(tree["embed"], (cfg.vocab_padded, d), specs["embed"], 1.0 / math.sqrt(d))
        for norm in [tree["final_norm"]] + ([tree["encoder"]["final_norm"]] if "encoder" in tree else []):
            _init_norm(norm)
        for sec, name, kind, _, n in self._blocks():
            if sec == "encoder":
                blk, bspec = tree[sec]["slots"][name], specs[sec]["slots"][name]
            else:
                blk, bspec = tree[sec][name], specs[sec][name]
            one = self._block(kind, 1, torch_dtype(self.policy.param_dtype))
            one = {part: dict(sub.items()) for part, sub in one.items()}
            lspec = SH.layer_specs(bspec)
            for i in range(n):
                self._init_block(kind, one, normal, uniform)
                for part, sub in blk.items():
                    for k, dst in sub.items():
                        if _is_q8(dst):  # the whole layer's codes and scales, cut as quantized_pspecs cuts them
                            q8, scale = _quantize(one[part][k][0])
                            dst["q8"][i].copy_(SH.cut(q8, lspec[part][k], mesh))
                            dst["scale"][i].copy_(SH.cut(scale, _scale_spec(lspec[part][k], q8.dim()), mesh))
                        else:
                            dst[i].copy_(SH.cut(one[part][k][0], lspec[part][k], mesh))
            del one
        if "unembed" in tree:
            whole(tree["unembed"], (d, cfg.vocab_padded), specs["unembed"], 1.0 / math.sqrt(d))
        if "pos_embed" in tree:
            whole(tree["pos_embed"], (cfg.max_learned_pos, d), specs["pos_embed"], 0.02)
        self._layers = {}
        return tree

    def _init_block(self, kind: str, blk: dict, normal, uniform) -> None:
        """Fill one block stack's float leaves (a dict of parts) in place."""
        cfg = self.cfg
        d = cfg.d_model
        for norm in ("norm1", "post1", "post2", "norm2", "norm_x"):
            if norm in blk:
                _init_norm(blk[norm])
        if kind == "ssm":
            M.ssm_init(blk["mixer"], d, cfg.ssm, normal)
        elif kind == "rec":
            R.rglru_init(blk["mixer"], d, cfg.rglru, normal, uniform)
        else:
            for part in ("mixer", "cross") if kind == "encdec" else ("mixer",):
                for k in ("wq", "wk", "wv"):
                    normal(blk[part][k], 1.0 / math.sqrt(d))
                normal(blk[part]["wo"], 1.0 / math.sqrt(cfg.n_heads * cfg.hd))
                for k in ("bq", "bk", "bv"):
                    if k in blk[part]:
                        blk[part][k].zero_()
        if "moe" in blk:
            moe_init(blk["moe"], d, cfg.moe, normal)
        if "mlp" in blk:
            normal(blk["mlp"]["w_in"], 1.0 / math.sqrt(d))
            if "w_gate" in blk["mlp"]:
                normal(blk["mlp"]["w_gate"], 1.0 / math.sqrt(d))
            normal(blk["mlp"]["w_out"], 1.0 / math.sqrt(cfg.d_ff))

    def _layer_params(self, tree: dict | None = None, encoder: bool = False) -> list[tuple]:
        """``(kind, section, slot name, index, params)`` of every layer in
        execution order: group by group, each group's slots in pattern
        order, then the tail; params are per-layer views. With ``encoder``
        the encoder's ``bidir`` layers (section ``encoder``) instead.

        Serving (grad mode off, the model's own tree) builds the views once
        and keeps them. Under grad mode, or for a given ``tree``, they are
        built anew on every call, each stacked leaf unbound into its
        layers: a view made once under ``no_grad`` would carry no gradient,
        and one ``unbind`` writes the stacked gradient in one piece where a
        select per layer would add a full-size zero tensor per layer."""
        fresh = tree is not None or torch.is_grad_enabled()
        key = "encoder" if encoder else "decoder"
        if not fresh and key in self._layers:
            return self._layers[key]
        tree = self.param_tree() if tree is None else tree

        def views(blk, n):
            split = {part: {k: _unbind(v) for k, v in sub.items()} for part, sub in blk.items()}
            return [{part: {k: v[i] for k, v in sub.items()} for part, sub in split.items()} for i in range(n)]

        if encoder:
            enc = views(tree["encoder"]["slots"]["s0"], self.cfg.enc_layers)
            layers = [("bidir", "encoder", "s0", i, p) for i, p in enumerate(enc)]
        else:
            pat = self.cfg.pattern
            slots = [views(tree["slots"][f"s{j}"], self.n_groups) for j in range(len(pat))]
            tail = [views(tree["tail"][f"s{j}"], 1)[0] for j in range(self.tail)]
            layers = [
                (kind, "slots", f"s{j}", g, slots[j][g]) for g in range(self.n_groups) for j, kind in enumerate(pat)
            ] + [(pat[j], "tail", f"s{j}", 0, p) for j, p in enumerate(tail)]
        if not fresh:
            self._layers[key] = layers
        return layers

    # ----------------------------------------------------------------- stack
    def _norm(self, p: dict, x):
        """The config's norm with the part ``p`` (one layer's ``{"w"}``, or
        ``{"w", "b"}`` for layer norm)."""
        if self.cfg.norm == "ln":
            return L.layer_norm(x, p["w"], p["b"], self.cfg.norm_eps)
        return L.rms_norm(x, p["w"], self.cfg.norm_eps, plus_one=self.cfg.norm_plus_one)

    # ---------------------------------------------------------------- a mesh
    def param_pspecs(self) -> dict:
        """The parameters' specs under the model's policy (:func:`param_pspecs`)."""
        return param_pspecs(self.cfg, self.policy)

    def float_shapes(self) -> dict:
        """The whole float parameter tree's shapes and dtypes (JAX's
        ``eval_shape`` of ``init``): a mesh-free model of the same policy
        without int8 weights, on the meta device, none drawn."""
        pol = dataclasses.replace(self.policy, weights_int8=False, mesh_axes={})
        return StreamModel(self.cfg, pol, device="meta", generator=None).param_tree()

    def _mesh_kw(self) -> dict:
        return {} if self.mesh is None else {"mesh": self.mesh, "policy": self.policy}

    def _tp_split(self, size: int) -> bool:
        """Whether a dim of ``size`` splits over a model axis of several ranks."""
        mesh, pol = self.mesh, self.policy
        return mesh is not None and mesh.size(pol.tp_axis) > 1 and pol.tp(size) is not None

    def _unsharded(self, t, spec):
        """A leaf with its ZeRO-3 dims gathered (its model-axis dims stay blocks)."""
        if self.mesh is None or not self.policy.fsdp_axes:
            return t
        return SH.gather_dims(t, spec, self.mesh, self.policy.fsdp_axes)

    def _batch_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.policy.batch_axes if a in self.mesh.sizes)

    def _row_axes(self, batch: int) -> tuple[str, ...]:
        """The axes of more than one rank that a served batch of ``batch``
        rows splits over (JAX's ``batch_spec``); () without a mesh."""
        return () if self.mesh is None else L._row_axes(self.policy, self.mesh, batch)

    def _my_rows(self, t, axes: tuple[str, ...]):
        """This rank's rows of a batch tensor (or array) split over ``axes``,
        on the model's device."""
        t = torch.as_tensor(t, device=self.device)
        return t if not axes else SH.local_block(t, 0, self.mesh, axes)

    def _all_rows(self, t, axes: tuple[str, ...]):
        """Every rank's rows of ``t`` joined in order (collective)."""
        return t if not axes else SH.all_gather(t, 0, self.mesh, axes)

    def _mlp(self, p: dict, x, kind: str):
        """The MLP; on a mesh whose model axis splits ``d_ff``, this rank's
        columns and rows, summed over the axis (row-parallel)."""
        y = L.mlp(p, x, kind, self.cfg.mlp_act)
        return SH.all_reduce(y, self.mesh, self.policy.tp_axis) if self._tp_split(self.cfg.d_ff) else y

    def _ssm(self, p: dict, h, st):
        """The Mamba-2 mixer; on a mesh that splits its heads, this rank's
        heads (K2 on them), the gated norm's mean square and the
        out-projection summed over the model axis."""
        cfg, mesh, tp = self.cfg, self.mesh, self.policy.tp_axis
        sp = cfg.ssm
        if not self._tp_split(sp.d_inner):
            return M.ssm_mixer(p, h, sp, st, cfg.norm_eps)
        if self.policy.tp(sp.n_heads) is None or sp.n_groups > 1:
            raise NotImplementedError(f"{cfg.name}: the model axis splits d_inner but not the SSD heads and groups")
        n = mesh.size(tp)

        def norm(y, w, eps):  # rms_norm over the whole d_inner
            yf = y.float()
            var = SH.all_reduce(yf.square().sum(dim=-1, keepdim=True), mesh, tp) / sp.d_inner
            return (yf * torch.rsqrt(var + eps) * w.float()).to(y.dtype)

        out, new = M.ssm_mixer(p, h, dataclasses.replace(sp, d_inner=sp.d_inner // n), st, cfg.norm_eps, norm=norm)
        return SH.all_reduce(out, mesh, tp), new

    def _rec(self, p: dict, h, st):
        """The RG-LRU mixer; on a mesh that splits its channels, this
        rank's channels and gate blocks (K3 on them), the out-projection
        summed over the model axis."""
        cfg, mesh, tp = self.cfg, self.mesh, self.policy.tp_axis
        rp = cfg.rglru
        if not self._tp_split(rp.d_rnn):
            return R.rglru_mixer(p, h, rp, st)
        if self.policy.tp(rp.n_blocks) is None:
            raise NotImplementedError(f"{cfg.name}: the model axis splits d_rnn but not the gates' blocks")
        n = mesh.size(tp)
        out, new = R.rglru_mixer(p, h, dataclasses.replace(rp, d_rnn=rp.d_rnn // n, n_blocks=rp.n_blocks // n), st)
        return SH.all_reduce(out, mesh, tp), new

    def _layer(self, kind: str, blk: dict, x, positions, st: dict | None = None, enc=None):
        """One block: x plus its mixer, then plus its MLP or MoE FFN (each
        output through its sandwich norm first where the config has them).
        An ``encdec`` block adds, after its causal self attention, the cross
        attention of its ``norm_x`` of x over ``enc`` (the encoder's output,
        (B, S_enc, d)), as JAX's ``_apply_block`` does. With ``st`` (the
        layer's view of the cache) a full-sequence pass (prefill) writes the
        layer's K/V (and an ``encdec`` block's cross K/V, ``xk`` / ``xv``)
        or recurrent state into it and a one-token pass decodes from it;
        either way in place. An int8 layer is dequantized to the compute
        dtype here. Returns (x, the MoE's aux loss or None)."""
        cfg = self.cfg
        if self.policy.weights_int8:
            blk = _dq_tree(blk, torch_dtype(self.policy.compute_dtype))
        if self.mesh is not None:  # ZeRO-3: this layer's d_model dims gathered where it uses them
            blk = self._unsharded(blk, self._layer_specs[kind])
        kw = self._mesh_kw()
        rows = {"rows": self._rows} if kw and self._rows is not None else {}
        h = self._norm(blk["norm1"], x)
        decode = st is not None and x.shape[1] == 1  # JAX: any one-token pass with a cache
        if kind in ("ssm", "rec"):
            if kind == "ssm":
                out, new = self._ssm(blk["mixer"], h, st)
            else:
                out, new = self._rec(blk["mixer"], h, st)
            if st is not None:
                for k, v in new.items():
                    st[k].copy_(v)
        else:
            ap = cfg.attn_params("attn" if kind == "encdec" else kind)  # an encdec block's self attention
            if decode:
                if "bt" in st:
                    out, _, _ = L.paged_decode_attention(
                        blk["mixer"], h, st["k"], st["v"], st["pos"], st["bt"], ap, **kw)
                else:
                    out, _, _ = L.decode_attention(
                        blk["mixer"], h, st["k"], st["v"], st["pos"], ap, ring=kind == "local", **kw,
                    )
                st["pos"].add_(1)
            elif st is not None:  # prefill: fill the cache while attending
                out, k, v = L.attention(blk["mixer"], h, ap, positions, return_kv=True, **kw)
                self._fill_kv_cache(st, k, v, ap)
            else:
                out = L.attention(blk["mixer"], h, ap, positions, **kw)
        x = x + (self._norm(blk["post1"], out) if cfg.post_norms else out)
        if kind == "encdec":
            hx = self._norm(blk["norm_x"], x)
            capx = cfg.attn_params("cross")
            if decode:
                out, _, _ = L.decode_attention(blk["cross"], hx, st["xk"], st["xv"], st["pos"], capx, **kw)
            elif st is None:
                out = L.attention(blk["cross"], hx, capx, kv_source=enc, **kw)
            else:  # the encoder's projections, cached once (JAX computes them again)
                out, xk, xv = L.attention(blk["cross"], hx, capx, return_kv=True, kv_source=enc, **kw)
                for key, new in (("xk", xk), ("xv", xv)):
                    cache_bits(st[key]).copy_(cache_bits(to_cache(new, st[key].dtype)))
            x = x + out
        if cfg.mlp_kind == "none" and cfg.moe is None:
            return x, None
        h2 = self._norm(blk["norm2"], x)
        aux = None
        if cfg.moe is not None:
            dense = (lambda t: self._mlp(blk["mlp"], t, "gated")) if cfg.moe.dense_residual else None
            y, aux = moe_ffn(blk["moe"], h2, cfg.moe, dense_mlp=dense, **kw, **rows)
        else:
            y = self._mlp(blk["mlp"], h2, cfg.mlp_kind)
        return x + (self._norm(blk["post2"], y) if cfg.post_norms else y), aux

    def _run_layers(self, layers, x, aux, positions, caches=None, enc=None):
        """``layers`` (entries of :meth:`_layer_params`) in order from x;
        each MoE layer's aux loss added to ``aux``. Returns (x, aux)."""
        for kind, sec, name, i, blk in layers:
            st = None
            if caches is not None:
                st = caches[sec][name]
                if sec == "slots":
                    st = {k: v[i] for k, v in st.items()}
            x, a = self._layer(kind, blk, x, positions, st, enc)
            if a is not None:
                aux = aux + a
        return x, aux

    def _remat(self, caches=None) -> bool:
        """Whether this pass recomputes its layer groups: a training pass
        (grad mode, no cache) under ``Policy.remat`` "block" or "full"."""
        return caches is None and torch.is_grad_enabled() and self.policy.remat in ("block", "full")

    def _recomputed(self, layers, x, aux, positions, enc=None):
        """:meth:`_run_layers` of one layer group under
        ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint`` of the scan
        body): ``"full"`` keeps only the group's inputs and runs its forward
        again in the backward; ``"block"`` also keeps the outputs of
        :data:`BLOCK_SAVED`. Non-reentrant, so that ``torch.autograd.grad``
        reaches through it. The forward's second run counts no MoE route
        (``moe.RECOMPUTING``); the kernels' launch counts see it."""
        runs = [0]

        def group(x, aux):
            runs[0] += 1
            prev, moe.RECOMPUTING = moe.RECOMPUTING, runs[0] > 1
            try:
                return self._run_layers(layers, x, aux, positions, enc=enc)
            finally:
                moe.RECOMPUTING = prev

        kw = {}
        if self.policy.remat == "block":
            kw["context_fn"] = functools.partial(
                torch.utils.checkpoint.create_selective_checkpoint_contexts, block_policy)
        return torch.utils.checkpoint.checkpoint(group, x, aux, use_reentrant=False, **kw)

    def _run_stack(self, x, positions, caches=None, tree=None, enc=None):
        """Every layer in order; with ``caches`` each layer reads and writes
        its own view of them (prefill or decode); ``encdec`` layers attend
        to ``enc``. Under ``Policy.remat`` a training pass runs each group
        (one pass over the pattern) through :meth:`_recomputed` and the
        tail layers as they are, as JAX's ``_run_stack`` does. Returns (x,
        the MoE aux losses summed over the layers in order, f32; 0 without
        an MoE)."""
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        layers = self._layer_params(tree)
        if self._remat(caches):
            per = len(self.cfg.pattern)
            for g in range(self.n_groups):
                x, aux = self._recomputed(layers[g * per:(g + 1) * per], x, aux, positions, enc)
            layers = layers[self.n_groups * per:]
        return self._run_layers(layers, x, aux, positions, caches, enc)

    def _encode(self, frames, tree=None):
        """whisper's encoder (JAX's ``_encode``): the frame embeddings (B,
        S_enc, d) cast to the compute dtype plus the sinusoid, the
        ``bidir`` stack (each layer a group of its own under
        ``Policy.remat``), then the encoder's final norm."""
        dt = torch_dtype(self.policy.compute_dtype)
        x = torch.as_tensor(frames, device=self.device).to(dt)
        x = x + _sinusoid(x.shape[1], self.cfg.d_model, dt, self.device)
        positions = torch.arange(x.shape[1], device=self.device)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for layer in self._layer_params(tree, encoder=True):
            run = self._recomputed if self._remat() else self._run_layers
            x, aux = run([layer], x, aux, positions)
        norm = (self.tree if tree is None else tree)["encoder"]["final_norm"]
        return self._norm({k: v[0] for k, v in norm.items()}, x)

    def _embed_tokens(self, tokens, tree=None):
        tokens = torch.as_tensor(tokens, device=self.device).long()
        dt = torch_dtype(self.policy.compute_dtype)
        embed = _dq_leaf(self.tree["embed"]["w"] if tree is None else tree["embed"], dt)  # never int8
        if self._tp_split(self.cfg.vocab_padded):  # vocab-parallel: this rank's rows, summed over the axis
            embed = self._unsharded(embed, self._specs["embed"])
            rows = embed.shape[0]
            local = tokens - self.mesh.coord(self.policy.tp_axis) * rows
            inside = (local >= 0) & (local < rows)
            x = embed[torch.where(inside, local, 0)].to(dt)
            x = SH.all_reduce(torch.where(inside[..., None], x, torch.zeros_like(x)), self.mesh, self.policy.tp_axis)
        else:
            if self.mesh is not None:
                embed = self._unsharded(embed, self._specs["embed"])
            x = embed[tokens].to(dt)
        if self.cfg.embed_scale:  # the scale rounded to the compute dtype, as in JAX
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype, device=x.device)
        return x

    def _embed_inputs(self, tokens, patch_embeds=None, frames=None, tree=None):
        """The token embeddings with, for a ``patches`` frontend, the patch
        embeddings (B, P, d) cast to their dtype and put in front (JAX's
        ``forward``, ``hidden`` and ``prefill``; positions then run over P
        + S), plus the learned positions where the config has them; and
        the encoder's output of ``frames`` (B, S_enc, d) for an encoder,
        else None. Returns (x, enc); raises where the frontend and the
        inputs disagree."""
        cfg = self.cfg
        x = self._embed_tokens(tokens, tree)
        if cfg.frontend != "patches" and patch_embeds is not None:
            raise ValueError(f"{cfg.name} has no patch frontend: patch_embeds given")
        if cfg.frontend == "patches":
            if patch_embeds is None:
                raise ValueError(f"{cfg.name} takes patch_embeds (B, P, d) before its tokens")
            front = torch.as_tensor(patch_embeds, device=self.device).to(x.dtype)
            x = torch.cat([front, x], dim=1)
        if cfg.learned_pos:  # JAX adds the table's leaf as it is (its dtype promotes)
            pe = self.tree["pos_embed"]["w"] if tree is None else tree["pos_embed"]
            if self.mesh is not None:
                pe = self._unsharded(pe, self._specs["pos_embed"])
            x = x + pe[: x.shape[1]][None]
        if (frames is not None) != cfg.enc_dec:
            raise ValueError(f"{cfg.name} takes frames (B, S_enc, d) exactly when it has an encoder")
        return x, self._encode(frames, tree) if cfg.enc_dec else None

    def _logits(self, x):
        """f32 logits of the final norm of x. On a mesh that splits the
        vocab over the model axis each rank's block of the unembed gives
        its columns, gathered over the axis (every rank gets them all)."""
        x = self._norm({k: v[0] for k, v in self.tree["final_norm"].items()}, x)
        key = "embed" if self.cfg.tie_embeddings else "unembed"
        w = self.tree[key]["w"]
        if self.mesh is not None:
            w = self._unsharded(w, self._specs[key])
        logits = x @ (w.to(x.dtype).T if self.cfg.tie_embeddings else w.to(x.dtype))
        logits = L.softcap(logits, self.cfg.final_softcap).float()
        if self._tp_split(self.cfg.vocab_padded):
            logits = SH.all_gather(logits, -1, self.mesh, self.policy.tp_axis)
        return logits

    def _serving(self, batch: int) -> tuple[str, ...]:
        """The start of a served call of ``batch`` rows: on a mesh, the axes
        its rows split over (kept for the MoE's capacity), else ()."""
        self._rows = self._row_axes(batch)
        return self._rows

    # ------------------------------------------------------------ public API
    @torch.no_grad()
    def forward(self, tokens, patch_embeds=None, frames=None) -> torch.Tensor:
        """Full forward to f32 logits (B, S, vocab_padded); with a patch
        frontend, (B, P + S, vocab_padded) over ``patch_embeds`` (B, P, d)
        and the tokens; with an encoder, the tokens attend to the encoder's
        output of ``frames`` (B, S_enc, d). On a mesh every rank passes the
        whole batch and gets the whole batch's logits: each rank runs its
        rows (the batch split as JAX's ``batch_spec`` splits it) through
        the mesh's strategies, and the rows and the vocab are gathered."""
        rows = self._serving(len(tokens))
        mine = [None if t is None else self._my_rows(t, rows) for t in (tokens, patch_embeds, frames)]
        x, enc = self._embed_inputs(*mine)
        positions = torch.arange(x.shape[1], device=self.device)
        return self._all_rows(self._logits(self._run_stack(x, positions, enc=enc)[0]), rows)

    def hidden(self, params: dict, batch: dict):
        """Forward to the final hidden states (before the final norm) with
        the parameters of ``params`` (a tree in the JAX layout). Returns
        (h (B, S, d), aux): the MoE layers' load-balancing losses summed
        (f32; 0 without an MoE). A patch frontend reads
        ``batch["patch_embeds"]``, an encoder ``batch["frames"]``."""
        self._rows = None
        x, enc = self._embed_inputs(batch["tokens"], batch.get("patch_embeds"), batch.get("frames"), params)
        positions = torch.arange(x.shape[1], device=self.device)
        return self._run_stack(x, positions, tree=params, enc=enc)

    def loss(self, params: dict, batch: dict, *, loss_chunk: int = 1024):
        """Next-token cross entropy with a **chunked** unembed and softmax
        (port of the JAX ``loss``): the unembed product, the logsumexp and
        the label pick run per sequence chunk under activation
        checkpointing, so one (B, chunk, vocab) block of logits is live at
        a time, in the backward too. Labels >= vocab add nothing and are
        not counted. With a patch frontend of ``frontend_len`` positions
        the last patch position predicts the first token, as in JAX:
        ``h[:, front - 1:-1]`` against every token. Returns (loss + aux,
        {"loss": loss, "aux": aux}).

        On a mesh ``batch`` is this rank's rows of the global batch and the
        loss is the global batch's: the negative log-likelihoods and the
        label count summed over the data axes, each rank's logits only its
        block of the vocab where the model axis splits it (the log-sum-exp
        and the label pick summed over that axis). The MoE aux is JAX's,
        over the global batch."""
        cfg = self.cfg
        h, aux = self.hidden(params, batch)
        h = self._norm({k: v[0] for k, v in params["final_norm"].items()}, h)
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        front = cfg.frontend_len if cfg.frontend == "patches" else 0
        pred_h, labels = (h[:, :-1], tokens[:, 1:]) if front == 0 else (h[:, front - 1:-1], tokens)
        n = pred_h.shape[1]
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        if self.mesh is not None:
            w = (self._unsharded(params["embed"], self._specs["embed"]).T if cfg.tie_embeddings
                 else self._unsharded(params["unembed"], self._specs["unembed"]))
        dt = torch.promote_types(h.dtype, w.dtype)  # the einsum's promotion in JAX

        def chunk_nll(hc, lc):
            logits = L.softcap(hc.to(dt) @ w.to(dt), cfg.final_softcap).float()
            mask = (lc < cfg.vocab).float()
            lse = torch.logsumexp(logits, dim=-1)
            inside = (lc >= 0) & (lc < cfg.vocab_padded)  # JAX's one_hot picks 0 outside
            picked = logits.gather(-1, torch.where(inside, lc, 0)[..., None])[..., 0]
            picked = torch.where(inside, picked, torch.zeros_like(picked))
            return ((lse - picked) * mask).sum(), mask.sum()

        nll_fn = chunk_nll
        if self._tp_split(cfg.vocab_padded):
            mesh, tp = self.mesh, self.policy.tp_axis
            v0, rows = mesh.coord(tp) * w.shape[1], w.shape[1]

            def nll_fn(hc, lc):  # vocab-parallel
                logits = L.softcap(hc.to(dt) @ w.to(dt), cfg.final_softcap).float()
                mask = (lc < cfg.vocab).float()
                m = SH.all_reduce_max(logits.detach().amax(dim=-1), mesh, tp)
                lse = m + torch.log(SH.all_reduce(torch.exp(logits - m[..., None]).sum(dim=-1), mesh, tp))
                local = lc - v0
                inside = (local >= 0) & (local < rows)  # outside every rank's rows: no pick, as JAX's one_hot
                picked = logits.gather(-1, torch.where(inside, local, 0)[..., None])[..., 0]
                picked = SH.all_reduce(torch.where(inside, picked, torch.zeros_like(picked)), mesh, tp)
                return ((lse - picked) * mask).sum(), mask.sum()

        chunk = min(loss_chunk, n)
        tot = cnt = torch.zeros((), dtype=torch.float32, device=self.device)
        for c0 in range(0, n, chunk):  # whole chunks, then the ragged tail, in the scan's order
            nll, k = torch.utils.checkpoint.checkpoint(
                nll_fn, pred_h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], use_reentrant=False,
            )
            tot, cnt = tot + nll, cnt + k
        if self.mesh is not None:  # the global batch's sums
            tot = SH.all_reduce(tot, self.mesh, self._batch_axes())
            cnt = SH.all_reduce(cnt.detach(), self.mesh, self._batch_axes())
        loss = tot / torch.clamp(cnt, min=1.0)
        return loss + aux, {"loss": loss, "aux": aux}

    def _state_specs(self, kind: str, b: int) -> dict:
        """Where one layer's decode state of ``b`` rows lies on the mesh: a
        spec per leaf, without the group dim (mesh-free: every entry None).
        The rows split as ``batch_spec`` splits them. An attention cache
        with ``seq_axis`` holds the rank's slice of the sequence and every
        kv head (the layout ``_flash_decode`` reads), else the kv heads
        ``wk`` holds; the cross K/V those too. The SSM's and the RG-LRU's
        states split over their heads and channels as the mixers' weights
        do (an SSM conv state's spec covers its ``d_inner`` part: the B/C
        channels after it are whole on every rank)."""
        cfg, pol = self.cfg, self.policy
        rows = self._row_axes(b) or None
        tp = pol.tp_axis
        if kind == "ssm":
            h = tp if self._tp_split(cfg.ssm.d_inner) else None
            return {"conv": P(rows, None, h), "ssd": P(rows, h, None, None)}
        if kind == "rec":
            c = tp if self._tp_split(cfg.rglru.d_rnn) else None
            return {"conv": P(rows, None, c), "h": P(rows, c)}
        if kind == "bidir":
            raise ValueError("a bidir layer keeps no decode cache")
        kv = tp if self._tp_split(cfg.n_kv_heads) else None
        seq = pol.seq_axis if self.mesh is not None else None
        if seq is not None and set(SH.axes_of(seq)) & set(rows or ()):
            raise ValueError(f"seq_axis {seq!r} shares an axis with the batch's {rows}: a batch of {b} rows")
        sp = {"k": P(rows, seq, None if seq else kv, None), "pos": P()}
        sp["v"] = sp["k"]
        if kind == "encdec":
            sp["xk"] = sp["xv"] = P(rows, None, kv, None)
        return sp

    def _slot_cache(self, kind: str, b: int, s_cache: int, dtype) -> dict:
        """One layer's zero cache: K/V of ``s_cache`` slots (``min(window,
        s_cache)`` ring slots for a local layer) and its position count,
        with an ``encdec`` layer's cross K/V ``xk`` / ``xv`` of the
        encoder's ``enc_seq`` positions beside them; or the SSM / RG-LRU
        states (f32). A ``bidir`` layer decodes nothing (JAX raises too).
        On a mesh, this rank's block of each (:meth:`_state_specs`)."""
        cfg, mesh = self.cfg, self.mesh
        specs = self._state_specs(kind, b)
        if mesh is not None:
            b //= mesh.size(specs["conv" if kind in ("ssm", "rec") else "k"][0])
        n = 1 if mesh is None else mesh.size(self.policy.tp_axis)
        if kind == "ssm":
            sp = cfg.ssm if specs["ssd"][1] is None else dataclasses.replace(cfg.ssm, d_inner=cfg.ssm.d_inner // n)
            return M.ssm_init_state(b, sp, self.device)
        if kind == "rec":
            rp = cfg.rglru if specs["h"][1] is None else dataclasses.replace(cfg.rglru, d_rnn=cfg.rglru.d_rnn // n)
            return R.rglru_init_state(b, rp, self.device)
        sz = min(cfg.window, s_cache) if kind == "local" and cfg.window else s_cache
        shapes = {"k": (b, sz, cfg.n_kv_heads, cfg.hd)}
        if kind == "encdec":
            shapes["xk"] = (b, cfg.enc_seq, cfg.n_kv_heads, cfg.hd)
        if mesh is not None:  # the rows are cut already
            shapes = {k: SH.local_shape(v, P(None, *specs[k][1:]), mesh) for k, v in shapes.items()}
        st = {"k": torch.zeros(shapes["k"], dtype=dtype, device=self.device),
              "v": torch.zeros(shapes["k"], dtype=dtype, device=self.device),
              "pos": torch.zeros((), dtype=torch.int32, device=self.device)}
        if kind == "encdec":
            st["xk"] = torch.zeros(shapes["xk"], dtype=dtype, device=self.device)
            st["xv"] = torch.zeros(shapes["xk"], dtype=dtype, device=self.device)
        return st

    def _kinds(self):
        """(section, slot name, kind) of every cache stack."""
        pat = self.cfg.pattern
        yield from (("slots", f"s{i}", k) for i, k in enumerate(pat))
        yield from (("tail", f"s{i}", pat[i]) for i in range(self.tail))

    def init_cache(self, batch_size: int, s_cache: int, dtype=None):
        """Contiguous decode cache per slot, stacked on the group dim
        (``slots/s{i}``: k/v (n_groups, B, sz, Kv, hd) and pos (n_groups,)
        for attention, with xk/xv (n_groups, B, enc_seq, Kv, hd) for an
        ``encdec`` slot, conv (n_groups, B, W-1, C) and ssd or h for the
        SSM and RG-LRU states, f32) and unstacked for the tail. On a mesh
        each leaf is this rank's block of it (:meth:`_state_specs`;
        :meth:`gather_caches` joins them)."""
        dtype = torch_dtype(self.policy.kv_cache_dtype) if dtype is None else dtype

        def stack(st):  # an fp8 K/V through its bits
            return {
                k: cache_bits(v).unsqueeze(0).repeat((self.n_groups,) + (1,) * v.dim()).view(v.dtype)
                for k, v in st.items()
            }

        caches: dict = {}
        for sec, name, kind in self._kinds():
            st = self._slot_cache(kind, batch_size, s_cache, dtype)
            caches.setdefault(sec, {})[name] = stack(st) if sec == "slots" else st
        return caches

    def cache_pspecs(self, batch_size: int) -> dict:
        """JAX's ``cache_pspecs``, entry for entry: the specs JAX gives the
        decode cache of ``batch_size`` rows (the tail's without the group
        dim). Where ``seq_axis`` is the model axis and the kv heads divide
        it, JAX names that axis twice (``P(None, batch, 'model', 'model',
        None)``) and places no cache by it: its flash-decode reads the
        cache as ``P(batch, seq_axis)`` with every kv head, which is where
        the port's cache lies (:meth:`_state_specs`)."""
        pol, cfg = self.policy, self.cfg
        batch = pol.batch_spec(batch_size)
        seq = pol.seq_axis
        kv_tp = pol.tp(cfg.n_kv_heads)

        def attn_spec():
            return {"k": P(None, batch, seq, kv_tp, None), "v": P(None, batch, seq, kv_tp, None), "pos": P(None)}

        def slot_spec(kind):
            if kind in ("attn", "local"):
                return attn_spec()
            if kind == "ssm":
                return {"conv": P(None, batch, None, pol.tp(cfg.ssm.d_inner)),
                        "ssd": P(None, batch, pol.tp(cfg.ssm.n_heads), None, None)}
            if kind == "rec":
                return {"conv": P(None, batch, None, pol.tp(cfg.rglru.d_rnn)),
                        "h": P(None, batch, pol.tp(cfg.rglru.d_rnn))}
            if kind == "encdec":
                sp = attn_spec()
                sp["xk"] = P(None, batch, None, kv_tp, None)
                sp["xv"] = P(None, batch, None, kv_tp, None)
                return sp
            raise ValueError(kind)

        specs: dict = {"slots": {f"s{i}": slot_spec(k) for i, k in enumerate(cfg.pattern)}}
        if self.tail:
            specs["tail"] = {f"s{i}": {k: P(*sp[1:]) for k, sp in slot_spec(cfg.pattern[i]).items()}
                             for i in range(self.tail)}
        return specs

    @torch.no_grad()
    def gather_caches(self, caches, batch_size: int) -> dict:
        """The dense cache of every rank's blocks of ``caches`` (an
        ``init_cache`` of ``batch_size`` rows; collective: every rank calls
        it and gets the whole cache). Mesh-free, a copy."""
        if self.mesh is None:
            return {sec: {name: {k: v.clone() for k, v in st.items()} for name, st in slots.items()}
                    for sec, slots in caches.items()}
        out: dict = {}
        for sec, name, kind in self._kinds():
            st, lead = caches[sec][name], (None,) if sec == "slots" else ()
            specs = {k: P(*lead, *sp) for k, sp in self._state_specs(kind, batch_size).items()}
            dense = {}
            for k, t in st.items():
                spec = specs[k] if t.dim() == len(specs[k]) else P()  # a per-row pos: every rank's copy
                if kind == "ssm" and k == "conv":  # the d_inner part split, the B/C part whole
                    d_loc = t.shape[-1] - 2 * self.cfg.ssm.n_groups * self.cfg.ssm.state_dim
                    rows = P(*spec[:-1], None)
                    t = torch.cat([SH.gather(t[..., :d_loc], spec, self.mesh), SH.gather(t[..., d_loc:], rows, self.mesh)],
                                  dim=-1)
                    dense[k] = t
                else:
                    dense[k] = SH.gather(cache_bits(t), spec, self.mesh).view(t.dtype)
            out.setdefault(sec, {})[name] = dense
        return out

    def _fill_kv_cache(self, st: dict, k, v, ap: AttnParams) -> None:
        """A prefill's K/V into a layer's cache view: on a mesh whose cache
        splits the sequence, every kv head (gathered over the model axis
        where ``wk`` held the rank's) written to the rank's slice of the
        slots; else as they come (the kv heads ``wk`` holds)."""
        seq = self.policy.seq_axis if self.mesh is not None else None
        if seq is None:
            return _fill_kv_cache(st, k, v)
        if k.shape[2] != ap.n_kv:
            k, v = (SH.all_gather(t, 2, self.mesh, self.policy.tp_axis) for t in (k, v))
        n = st["k"].shape[1]
        _fill_kv_cache(st, k, v, offset=self.mesh.coord(seq) * n, sz=n * self.mesh.size(seq))

    # ------------------------------------------------------------ paged cache
    # One physical pool of (n_blocks, block_size) KV blocks per layer, no
    # batch dim, plus per-row positions and block tables; block 0 is the
    # scratch target of idle rows' discarded writes. On a mesh the pool
    # holds the kv heads ``wk`` holds and every row.
    def init_paged_cache(
        self, batch_size: int, n_blocks: int, block_size: int, max_blocks: int, dtype=None,
    ):
        cfg = self.cfg
        if cfg.pattern != ("attn",):
            raise NotImplementedError(
                f"paged KV cache supports dense 'attn' patterns only (got {cfg.pattern!r})"
            )
        dtype = torch_dtype(self.policy.kv_cache_dtype) if dtype is None else dtype
        n = self.n_groups
        n_kv = cfg.n_kv_heads // self.mesh.size(self.policy.tp_axis) if self._tp_split(cfg.n_kv_heads) else cfg.n_kv_heads
        kv = (n, n_blocks, block_size, n_kv, cfg.hd)
        return {"slots": {"s0": {
            "k": torch.zeros(kv, dtype=dtype, device=self.device),
            "v": torch.zeros(kv, dtype=dtype, device=self.device),
            "pos": torch.zeros((n, batch_size), dtype=torch.int32, device=self.device),
            "bt": torch.zeros((n, batch_size, max_blocks), dtype=torch.int32, device=self.device),
        }}}

    def paged_insert(self, caches, small_caches, row: int, block_ids, bt_row, plen: int):
        """Admit one prefilled request: the batch-1 contiguous cache (padded
        to ``len(block_ids) * block_size``) is split into whole blocks and
        written to ``block_ids``; the row's position becomes ``plen`` and its
        block table ``bt_row``. In place; returns ``caches``. On a mesh
        whose contiguous cache splits the sequence, its slices are gathered
        first and the pool's kv heads taken from them (collective)."""
        dst, src = caches["slots"]["s0"], small_caches["slots"]["s0"]
        ids = torch.as_tensor(block_ids, device=self.device).long()
        ng, _, blk, kv, hd = dst["k"].shape
        nb = ids.shape[0]
        seq = self.policy.seq_axis if self.mesh is not None else None
        for key in ("k", "v"):  # an fp8 pool through its bits, in JAX's cast
            bits = cache_bits(src[key])
            if seq is not None:
                bits = SH.all_gather(bits, 2, self.mesh, seq)
                if bits.shape[3] != kv:
                    bits = SH.local_block(bits, 3, self.mesh, self.policy.tp_axis)
            new = bits[:, 0].view(src[key].dtype)
            cache_bits(dst[key])[:, ids] = cache_bits(to_cache(new, dst[key].dtype)).reshape(ng, nb, blk, kv, hd)
        dst["pos"][:, row] = plen
        dst["bt"][:, row] = torch.as_tensor(bt_row, dtype=torch.int32, device=self.device)
        return caches

    def paged_clear(self, caches, row: int):
        """Recycle one slot: zero its position and block table so its idle
        writes land in the scratch block (the K/V blocks need no zeroing:
        the validity mask hides them). In place; returns ``caches``."""
        dst = caches["slots"]["s0"]
        dst["pos"][:, row] = 0
        dst["bt"][:, row] = 0
        return caches

    @torch.no_grad()
    def prefill(self, tokens, s_cache: int, cache_dtype=torch.bfloat16, patch_embeds=None, frames=None):
        """Run the full prompt (a patch frontend's ``patch_embeds`` (B, P,
        d) before its tokens: P + S positions; an encoder's ``frames`` (B,
        enc_seq, d), encoded once and their cross K/V cached), fill a cache
        of ``s_cache`` slots, return the last position's logits (B,
        vocab_padded) and the cache. A one-token prompt decodes, as in JAX
        (an ``encdec`` layer's cross K/V then stay zero). On a mesh every
        rank passes the whole batch and gets the whole batch's logits and
        its blocks of the cache (:meth:`init_cache`)."""
        b = len(tokens)
        rows = self._serving(b)
        mine = [None if t is None else self._my_rows(t, rows) for t in (tokens, patch_embeds, frames)]
        x, enc = self._embed_inputs(*mine)
        caches = self.init_cache(b, s_cache, cache_dtype)
        positions = torch.arange(x.shape[1], device=self.device)
        x, _ = self._run_stack(x, positions, caches, enc=enc)
        return self._all_rows(self._logits(x[:, -1:, :])[:, 0], rows), caches

    @torch.no_grad()
    def decode_step(self, caches, tokens, pos=None):
        """One decode step for tokens (B, 1). Attention layers take their
        positions from the cache: scalar per layer for ``init_cache``, per
        row for the paged cache; recurrent layers need none. ``pos`` (JAX's
        argument: a scalar, or (B,) per row) feeds only the learned position
        embeddings, ``pos_embed[pos]`` added to the token's; left None, it is
        the first attention slot's cache position (the tokens already in
        it, per row for the paged cache). Returns (logits (B, 1,
        vocab_padded), caches). On a mesh every rank passes the whole batch
        and its blocks of the cache, and gets the whole batch's logits; a
        paged cache keeps every row on every rank."""
        paged = "bt" in caches.get("slots", {}).get("s0", {})
        rows = self._serving(1 if paged else len(tokens))
        x = self._embed_tokens(self._my_rows(tokens, rows))
        if self.cfg.learned_pos:
            if pos is None:
                first = next(f"s{i}" for i, k in enumerate(self.cfg.pattern) if k in _ATTN_KINDS)
                pos = caches["slots" if self.n_groups else "tail"][first]["pos"]
                pos = pos[0] if self.n_groups else pos
            pos = torch.as_tensor(pos, device=self.device).long()
            if pos.dim() == 1 and pos.shape[0] != x.shape[0]:  # every row's: this rank's
                pos = self._my_rows(pos, rows)
            pe = self.tree["pos_embed"]["w"]
            if self.mesh is not None:
                pe = self._unsharded(pe, self._specs["pos_embed"])
            x = x + pe.index_select(0, pos.reshape(-1))[:, None]  # a gather: no host sync on a 0-d position
        x, _ = self._run_stack(x, None, caches)
        return self._all_rows(self._logits(x), rows), caches


def _fill_kv_cache(st: dict, k, v, offset: int = 0, sz: int | None = None) -> None:
    """Write one layer's prefill K/V (B, S, Kv, D) into a cache of ``sz``
    slots (the view's own where None) of which the view holds those from
    ``offset`` on (a rank's slice of a sequence-split cache); with S >= sz
    keep the last sz positions rotated so that slot == position % sz (the
    ring layout of the JAX function). Values enter in JAX's cast, an fp8
    cache through its bits."""
    n = st["k"].shape[1]
    sz = n if sz is None else sz
    s = k.shape[1]
    for key, new in (("k", k), ("v", v)):
        dst = cache_bits(st[key])
        new = cache_bits(to_cache(new[:, max(s - sz, 0):], st[key].dtype))
        if s >= sz:
            dst.copy_(torch.roll(new, s % sz, dims=1)[:, offset:offset + n])
        elif s > offset:
            dst[:, :min(s - offset, n)] = new[:, offset:offset + n]
    st["pos"].fill_(s)


def _sinusoid(s: int, d: int, dtype, device) -> torch.Tensor:
    """whisper's (S, d) sinusoid (JAX's ``model._sinusoid``): sines then
    cosines of pos / 10000^(2i / d), made in numpy float64 and cast."""
    pos = np.arange(s)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(emb).to(device=device, dtype=dtype)
