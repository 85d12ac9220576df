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
(Mamba-2, mamba2) and ``rec`` (RG-LRU, recurrentgemma) are ported, with
or without an MLP, tied or untied embeddings, gemma's embedding scale,
gemma2's sandwich norms (``post1`` / ``post2``) and attention and final
logit softcaps, and qwen2's QKV bias (``bq`` / ``bk`` / ``bv``); the other
kinds and fields (MoE, encoder-decoder, frontends, layer norm, learned
positions) raise ``NotImplementedError``. Caches keep the JAX layout,
stacked on the group dim for slots and not for the tail, and are updated
in place. The paged cache serves the dense pattern only, as in JAX.

Training: :meth:`StreamModel.hidden` and the chunked
:meth:`StreamModel.loss` take a parameter tree in the JAX layout (the
model's own, ``param_tree()``, whose leaves are its parameters) as the
JAX functions do, and are differentiable. The parameters are built with
``requires_grad=False`` for serving; a trainer turns it on
(``requires_grad_(True)``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import ssm as M
from repro_torch.models.layers import AttnParams
from repro_torch.models.policy import Policy, torch_dtype
from repro_torch.models.rglru import RGLRUParams
from repro_torch.models.ssm import SSMParams

__all__ = ["ArchConfig", "StreamModel"]


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
    moe: Any = None  # MoEParams in the JAX package; not ported yet
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


_KINDS = ("attn", "local", "ssm", "rec")


def _unsupported(cfg: ArchConfig) -> list[str]:
    checks = {
        f"pattern {cfg.pattern!r}": not cfg.pattern or any(k not in _KINDS for k in cfg.pattern),
        "ssm pattern without SSMParams": "ssm" in cfg.pattern and cfg.ssm is None,
        "rec pattern without RGLRUParams": "rec" in cfg.pattern and cfg.rglru is None,
        "moe": cfg.moe is not None,
        "enc_dec": cfg.enc_dec,
        f"frontend {cfg.frontend!r}": cfg.frontend != "none",
        "learned_pos": cfg.learned_pos,
        f"norm {cfg.norm!r}": cfg.norm != "rms",
        f"mlp_kind {cfg.mlp_kind!r}": cfg.mlp_kind not in ("gated", "plain", "none"),
    }
    return [k for k, bad in checks.items() if bad]


def _params(shapes: dict, dtype, device, f32: tuple[str, ...] = ()) -> nn.ParameterDict:
    """Empty parameters of ``dtype``; the leaves named in ``f32`` are float32."""
    return nn.ParameterDict({
        k: nn.Parameter(
            torch.empty(s, dtype=torch.float32 if k in f32 else dtype, device=device),
            requires_grad=False,
        )
        for k, s in shapes.items()
    })


class StreamModel(nn.Module):
    """Decoder of a block pattern with explicit caches; parameters in the JAX tree layout."""

    def __init__(
        self,
        cfg: ArchConfig,
        policy: Policy = Policy(),
        *,
        device: str | torch.device | None = None,
        generator: torch.Generator | int | None = 0,
    ):
        super().__init__()
        bad = _unsupported(cfg)
        if bad:
            raise NotImplementedError(f"{cfg.name}: not ported yet: {', '.join(bad)}")
        self.cfg = cfg
        self.policy = policy
        self.device = resolve_device(device)
        pat = cfg.pattern
        self.n_groups = cfg.n_layers // len(pat)
        self.tail = cfg.n_layers - self.n_groups * len(pat)  # leftover layers
        dtype = torch_dtype(policy.param_dtype)
        d = cfg.d_model
        self.tree = nn.ModuleDict({
            "embed": _params({"w": (cfg.vocab_padded, d)}, dtype, self.device),
            "final_norm": _params({"w": (1, d)}, dtype, self.device),
            "slots": nn.ModuleDict({
                f"s{i}": self._block(k, self.n_groups, dtype) for i, k in enumerate(pat)
            }),
        })
        if self.tail:
            self.tree["tail"] = nn.ModuleDict({
                f"s{i}": self._block(pat[i], 1, dtype) for i in range(self.tail)
            })
        if not cfg.tie_embeddings:
            self.tree["unembed"] = _params({"w": (d, cfg.vocab_padded)}, dtype, self.device)
        self._layers: list[tuple] | None = None
        if generator is not None:
            self.init(generator)

    def _block(self, kind: str, n: int, dtype) -> nn.ModuleDict:
        """One slot's parameters, stacked over ``n`` layers."""
        cfg = self.cfg
        d, f = cfg.d_model, cfg.d_ff
        block = nn.ModuleDict({"norm1": _params({"w": (n, d)}, dtype, self.device)})
        if kind == "ssm":
            block["mixer"] = _params(M.ssm_shapes(n, d, cfg.ssm), dtype, self.device, f32=M.F32_LEAVES)
        elif kind == "rec":
            block["mixer"] = _params(R.rglru_shapes(n, d, cfg.rglru), dtype, self.device, f32=R.F32_LEAVES)
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
            block["mixer"] = _params(shapes, dtype, self.device)
        if cfg.post_norms:  # gemma2's sandwich norm of the mixer's output
            block["post1"] = _params({"w": (n, d)}, dtype, self.device)
        if cfg.mlp_kind != "none":
            mlp_shapes = {"w_in": (n, d, f), "w_out": (n, f, d)}
            if cfg.mlp_kind == "gated":
                mlp_shapes["w_gate"] = (n, d, f)
            block["norm2"] = _params({"w": (n, d)}, dtype, self.device)
            block["mlp"] = _params(mlp_shapes, dtype, self.device)
            if cfg.post_norms:  # ... and of the MLP's
                block["post2"] = _params({"w": (n, d)}, dtype, self.device)
        return block

    def _blocks(self):
        """(section, slot name, kind, stacked params) of every block stack."""
        pat = self.cfg.pattern
        for sec in ("slots", "tail"):
            if sec in self.tree:
                for name, blk in self.tree[sec].items():
                    yield sec, name, pat[int(name[1:])], blk

    # ------------------------------------------------------------ parameters
    def param_tree(self) -> dict:
        """The parameters as the JAX package's nested dict (``embed`` and
        ``unembed`` are leaves there, so they are here; a tied model has
        no ``unembed``, a model whose layers fill whole groups no ``tail``)."""
        t = self.tree
        tree: dict[str, Any] = {"embed": t["embed"]["w"], "final_norm": {"w": t["final_norm"]["w"]}}
        for sec, name, _, blk in self._blocks():
            tree.setdefault(sec, {})[name] = {part: dict(sub.items()) for part, sub in blk.items()}
        if "unembed" in t:
            tree["unembed"] = t["unembed"]["w"]
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
        self._layers = None

    @torch.no_grad()
    def init(self, generator: torch.Generator | int) -> dict:
        """Random weights with the JAX init's scales (``layers._normal``,
        ``ssm.ssm_init``, ``rglru.rglru_init``): normal / sqrt(fan_in),
        drawn in f32 and cast; norms (the sandwich norms too) are ones and
        QKV biases zeros; the SSM's decays, skips and
        dt biases are its fixed values, the RG-LRU's Lambda is drawn from
        its uniform law. An int seeds a new generator on the model's device.
        Returns the parameter tree (``param_tree()``), as the JAX ``init``
        returns its params."""
        if isinstance(generator, int):
            generator = torch.Generator(device=self.device).manual_seed(generator)
        cfg = self.cfg
        d = cfg.d_model

        def normal(p, scale):
            x = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=self.device)
            p.copy_(x.mul_(scale))

        def uniform(p, lo, hi):
            x = torch.rand(p.shape, generator=generator, dtype=torch.float32, device=self.device)
            p.copy_(x.mul_(hi - lo).add_(lo))

        tree = self.param_tree()
        normal(tree["embed"], 1.0 / math.sqrt(d))
        tree["final_norm"]["w"].fill_(1.0)
        for sec, name, kind, _ in self._blocks():
            blk = tree[sec][name]
            for norm in ("norm1", "post1", "post2"):
                if norm in blk:
                    blk[norm]["w"].fill_(1.0)
            if kind == "ssm":
                M.ssm_init(blk["mixer"], d, cfg.ssm, normal)
            elif kind == "rec":
                R.rglru_init(blk["mixer"], d, cfg.rglru, normal, uniform)
            else:
                for k in ("wq", "wk", "wv"):
                    normal(blk["mixer"][k], 1.0 / math.sqrt(d))
                normal(blk["mixer"]["wo"], 1.0 / math.sqrt(cfg.n_heads * cfg.hd))
                for k in ("bq", "bk", "bv"):
                    if k in blk["mixer"]:
                        blk["mixer"][k].zero_()
            if "mlp" in blk:
                blk["norm2"]["w"].fill_(1.0)
                normal(blk["mlp"]["w_in"], 1.0 / math.sqrt(d))
                if "w_gate" in blk["mlp"]:
                    normal(blk["mlp"]["w_gate"], 1.0 / math.sqrt(d))
                normal(blk["mlp"]["w_out"], 1.0 / math.sqrt(cfg.d_ff))
        if "unembed" in tree:
            normal(tree["unembed"], 1.0 / math.sqrt(d))
        self._layers = None
        return tree

    def _layer_params(self, tree: dict | None = None) -> list[tuple]:
        """``(kind, section, slot name, index, params)`` of every layer in
        execution order: group by group, each group's slots in pattern
        order, then the tail; params are per-layer views.

        Serving (grad mode off, the model's own tree) builds the views once
        and keeps them. Under grad mode, or for a given ``tree``, they are
        built anew on every call, each stacked leaf unbound into its
        layers: a view made once under ``no_grad`` would carry no gradient,
        and one ``unbind`` writes the stacked gradient in one piece where a
        select per layer would add a full-size zero tensor per layer."""
        fresh = tree is not None or torch.is_grad_enabled()
        if not fresh and self._layers is not None:
            return self._layers
        tree = self.param_tree() if tree is None else tree
        pat = self.cfg.pattern
        split = {
            (sec, name): {part: {k: v.unbind(0) for k, v in sub.items()} for part, sub in blk.items()}
            for sec in ("slots", "tail") if sec in tree for name, blk in tree[sec].items()
        }

        def view(sec, name, i):
            return {part: {k: v[i] for k, v in sub.items()} for part, sub in split[sec, name].items()}

        layers = [
            (kind, "slots", f"s{j}", g, view("slots", f"s{j}", g))
            for g in range(self.n_groups) for j, kind in enumerate(pat)
        ] + [(pat[j], "tail", f"s{j}", 0, view("tail", f"s{j}", 0)) for j in range(self.tail)]
        if not fresh:
            self._layers = layers
        return layers

    # ----------------------------------------------------------------- stack
    def _norm(self, w, x):
        return L.rms_norm(x, w, self.cfg.norm_eps, plus_one=self.cfg.norm_plus_one)

    def _layer(self, kind: str, blk: dict, x, positions, st: dict | None = None):
        """One block: x plus its mixer, then plus its MLP (each output
        through its sandwich norm first where the config has them). With
        ``st`` (the layer's view of the cache) a full-sequence pass
        (prefill) writes the layer's K/V or recurrent state into it and a
        one-token pass decodes from it; either way in place."""
        cfg = self.cfg
        h = self._norm(blk["norm1"]["w"], x)
        if kind in ("ssm", "rec"):
            if kind == "ssm":
                out, new = M.ssm_mixer(blk["mixer"], h, cfg.ssm, st, cfg.norm_eps)
            else:
                out, new = R.rglru_mixer(blk["mixer"], h, cfg.rglru, st)
            if st is not None:
                for k, v in new.items():
                    st[k].copy_(v)
        elif st is not None and x.shape[1] == 1:  # decode
            ap = cfg.attn_params(kind)
            if "bt" in st:
                out, _, _ = L.paged_decode_attention(blk["mixer"], h, st["k"], st["v"], st["pos"], st["bt"], ap)
            else:
                out, _, _ = L.decode_attention(
                    blk["mixer"], h, st["k"], st["v"], st["pos"], ap, ring=kind == "local",
                )
            st["pos"].add_(1)
        elif st is not None:  # prefill: fill the cache while attending
            out, k, v = L.attention(blk["mixer"], h, cfg.attn_params(kind), positions, return_kv=True)
            _fill_kv_cache(st, k, v)
        else:
            out = L.attention(blk["mixer"], h, cfg.attn_params(kind), positions)
        x = x + (self._norm(blk["post1"]["w"], out) if cfg.post_norms else out)
        if cfg.mlp_kind == "none":
            return x
        y = L.mlp(blk["mlp"], self._norm(blk["norm2"]["w"], x), cfg.mlp_kind, cfg.mlp_act)
        return x + (self._norm(blk["post2"]["w"], y) if cfg.post_norms else y)

    def _run_stack(self, x, positions, caches=None, tree=None):
        """Every layer in order; with ``caches`` each layer reads and writes
        its own view of them (prefill or decode)."""
        for kind, sec, name, i, blk in self._layer_params(tree):
            st = None
            if caches is not None:
                st = caches[sec][name]
                if sec == "slots":
                    st = {k: v[i] for k, v in st.items()}
            x = self._layer(kind, blk, x, positions, st)
        return x

    def _embed_tokens(self, tokens, tree=None):
        tokens = torch.as_tensor(tokens, device=self.device).long()
        embed = self.tree["embed"]["w"] if tree is None else tree["embed"]
        x = embed[tokens].to(torch_dtype(self.policy.compute_dtype))
        if self.cfg.embed_scale:  # the scale rounded to the compute dtype, as in JAX
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype, device=x.device)
        return x

    def _logits(self, x):
        x = self._norm(self.tree["final_norm"]["w"][0], x)
        if self.cfg.tie_embeddings:
            logits = x @ self.tree["embed"]["w"].to(x.dtype).T
        else:
            logits = x @ self.tree["unembed"]["w"].to(x.dtype)
        return L.softcap(logits, self.cfg.final_softcap).float()

    # ------------------------------------------------------------ public API
    @torch.no_grad()
    def forward(self, tokens) -> torch.Tensor:
        """Full forward to f32 logits (B, S, vocab_padded)."""
        x = self._embed_tokens(tokens)
        positions = torch.arange(x.shape[1], device=self.device)
        return self._logits(self._run_stack(x, positions))

    def hidden(self, params: dict, batch: dict):
        """Forward to the final hidden states (before the final norm) with
        the parameters of ``params`` (a tree in the JAX layout). Returns
        (h (B, S, d), aux); aux is 0 (no MoE is ported)."""
        x = self._embed_tokens(batch["tokens"], params)
        positions = torch.arange(x.shape[1], device=self.device)
        x = self._run_stack(x, positions, tree=params)
        return x, torch.zeros((), dtype=torch.float32, device=self.device)

    def loss(self, params: dict, batch: dict, *, loss_chunk: int = 1024):
        """Next-token cross entropy with a **chunked** unembed and softmax
        (port of the JAX ``loss``): the unembed product, the logsumexp and
        the label pick run per sequence chunk under activation
        checkpointing, so one (B, chunk, vocab) block of logits is live at
        a time, in the backward too. Labels >= vocab add nothing and are
        not counted. Returns (loss + aux, {"loss": loss, "aux": aux})."""
        cfg = self.cfg
        h, aux = self.hidden(params, batch)
        h = self._norm(params["final_norm"]["w"][0], h)
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        pred_h, labels = h[:, :-1], tokens[:, 1:]
        n = pred_h.shape[1]
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        dt = torch.promote_types(h.dtype, w.dtype)  # the einsum's promotion in JAX

        def chunk_nll(hc, lc):
            logits = L.softcap(hc.to(dt) @ w.to(dt), cfg.final_softcap).float()
            mask = (lc < cfg.vocab).float()
            lse = torch.logsumexp(logits, dim=-1)
            inside = (lc >= 0) & (lc < cfg.vocab_padded)  # JAX's one_hot picks 0 outside
            picked = logits.gather(-1, torch.where(inside, lc, 0)[..., None])[..., 0]
            picked = torch.where(inside, picked, torch.zeros_like(picked))
            return ((lse - picked) * mask).sum(), mask.sum()

        chunk = min(loss_chunk, n)
        tot = cnt = torch.zeros((), dtype=torch.float32, device=self.device)
        for c0 in range(0, n, chunk):  # whole chunks, then the ragged tail, in the scan's order
            nll, k = torch.utils.checkpoint.checkpoint(
                chunk_nll, pred_h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], use_reentrant=False,
            )
            tot, cnt = tot + nll, cnt + k
        loss = tot / torch.clamp(cnt, min=1.0)
        return loss + aux, {"loss": loss, "aux": aux}

    def _slot_cache(self, kind: str, b: int, s_cache: int, dtype) -> dict:
        """One layer's zero cache: K/V of ``s_cache`` slots (``min(window,
        s_cache)`` ring slots for a local layer) and its position count, or
        the SSM / RG-LRU states (f32)."""
        cfg = self.cfg
        if kind == "ssm":
            return M.ssm_init_state(b, cfg.ssm, self.device)
        if kind == "rec":
            return R.rglru_init_state(b, cfg.rglru, self.device)
        sz = min(cfg.window, s_cache) if kind == "local" and cfg.window else s_cache
        kv = (b, sz, cfg.n_kv_heads, cfg.hd)
        return {
            "k": torch.zeros(kv, dtype=dtype, device=self.device),
            "v": torch.zeros(kv, dtype=dtype, device=self.device),
            "pos": torch.zeros((), dtype=torch.int32, device=self.device),
        }

    def init_cache(self, batch_size: int, s_cache: int, dtype=None):
        """Contiguous decode cache per slot, stacked on the group dim
        (``slots/s{i}``: k/v (n_groups, B, sz, Kv, hd) and pos (n_groups,)
        for attention, conv (n_groups, B, W-1, C) and ssd or h for the
        SSM and RG-LRU states, f32) and unstacked for the tail."""
        dtype = torch_dtype(self.policy.kv_cache_dtype) if dtype is None else dtype
        pat = self.cfg.pattern

        def stack(st):
            return {k: v.unsqueeze(0).repeat((self.n_groups,) + (1,) * v.dim()) for k, v in st.items()}

        caches = {"slots": {
            f"s{i}": stack(self._slot_cache(k, batch_size, s_cache, dtype)) for i, k in enumerate(pat)
        }}
        if self.tail:
            caches["tail"] = {
                f"s{i}": self._slot_cache(pat[i], batch_size, s_cache, dtype) for i in range(self.tail)
            }
        return caches

    # ------------------------------------------------------------ paged cache
    # One physical pool of (n_blocks, block_size) KV blocks per layer, no
    # batch dim, plus per-row positions and block tables; block 0 is the
    # scratch target of idle rows' discarded writes.
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
        kv = (n, n_blocks, block_size, cfg.n_kv_heads, cfg.hd)
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
        block table ``bt_row``. In place; returns ``caches``."""
        dst, src = caches["slots"]["s0"], small_caches["slots"]["s0"]
        ids = torch.as_tensor(block_ids, device=self.device).long()
        ng, _, blk, kv, hd = dst["k"].shape
        nb = ids.shape[0]
        dst["k"][:, ids] = src["k"][:, 0].reshape(ng, nb, blk, kv, hd).to(dst["k"].dtype)
        dst["v"][:, ids] = src["v"][:, 0].reshape(ng, nb, blk, kv, hd).to(dst["v"].dtype)
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
    def prefill(self, tokens, s_cache: int, cache_dtype=torch.bfloat16):
        """Run the full prompt, fill a cache of ``s_cache`` slots, return the
        last position's logits (B, vocab_padded) and the cache."""
        x = self._embed_tokens(tokens)
        caches = self.init_cache(x.shape[0], s_cache, cache_dtype)
        positions = torch.arange(x.shape[1], device=self.device)
        x = self._run_stack(x, positions, caches)
        return self._logits(x[:, -1:, :])[:, 0], caches

    @torch.no_grad()
    def decode_step(self, caches, tokens):
        """One decode step for tokens (B, 1). Positions come from the cache:
        scalar per attention layer for ``init_cache``, per row for the paged
        cache (the JAX signature's ``pos`` feeds only learned position
        embeddings, which are not ported); recurrent layers need none.
        Returns (logits (B, 1, vocab_padded), caches)."""
        x = self._run_stack(self._embed_tokens(tokens), None, caches)
        return self._logits(x), caches


def _fill_kv_cache(st: dict, k, v) -> None:
    """Write one layer's prefill K/V (B, S, Kv, D) into its cache view of
    ``sz`` slots; with S >= sz keep the last sz positions rotated so that
    slot == position % sz (the ring layout of the JAX function)."""
    sz = st["k"].shape[1]
    s = k.shape[1]
    if s >= sz:
        shift = s % sz
        st["k"].copy_(torch.roll(k[:, s - sz:], shift, dims=1))
        st["v"].copy_(torch.roll(v[:, s - sz:], shift, dims=1))
    else:
        st["k"][:, :s] = k.to(st["k"].dtype)
        st["v"][:, :s] = v.to(st["v"].dtype)
    st["pos"].fill_(s)
