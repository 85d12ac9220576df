"""Model assembler (port of ``repro.models.model``): one-kind stacks on one device.

``StreamModel`` is an ``nn.Module`` holding the JAX package's parameter
tree with the same nested keys and shapes, the layer stack included as a
leading dim (``slots/s0/mixer/wq`` is ``(L, d, H, hd)``), so that
``convert.params_from_jax`` moves weights across one for one. The layer
loop is a Python loop over ``L``.

The dense ``("attn",)`` pattern (yi-6b) and the Mamba-2 ``("ssm",)``
pattern (mamba2) are ported, with or without an MLP and with tied or
untied embeddings; the other block kinds (local/ring attention, RG-LRU,
MoE, encoder-decoder, frontends) raise ``NotImplementedError``. Caches
keep the JAX layout, stacked on the layer dim, and are updated in place.
The paged cache serves the dense pattern only, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import AttnParams
from repro_torch.models.policy import Policy, torch_dtype
from repro_torch.models.ssm import F32_LEAVES, SSMParams, ssm_init, ssm_init_state, ssm_mixer, ssm_shapes

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
    rglru: Any = None  # RGLRUParams; not ported yet
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


def _unsupported(cfg: ArchConfig) -> list[str]:
    checks = {
        f"pattern {cfg.pattern!r}": cfg.pattern not in (("attn",), ("ssm",)),
        "ssm pattern without SSMParams": cfg.pattern == ("ssm",) and cfg.ssm is None,
        "moe": cfg.moe is not None,
        "rglru": cfg.rglru is not None,
        "enc_dec": cfg.enc_dec,
        f"frontend {cfg.frontend!r}": cfg.frontend != "none",
        "learned_pos": cfg.learned_pos,
        f"norm {cfg.norm!r}": cfg.norm != "rms",
        "post_norms": cfg.post_norms,
        "embed_scale": cfg.embed_scale,
        "attn_bias": cfg.attn_bias,
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
    """Dense or Mamba-2 decoder with explicit caches; parameters in the JAX tree layout."""

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
        self.n_groups = cfg.n_layers
        self.kind = cfg.pattern[0]
        self.ap = cfg.attn_params("attn") if self.kind == "attn" else None
        dtype = torch_dtype(policy.param_dtype)
        n, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
        block = nn.ModuleDict({"norm1": _params({"w": (n, d)}, dtype, self.device)})
        if self.kind == "ssm":
            block["mixer"] = _params(ssm_shapes(n, d, cfg.ssm), dtype, self.device, f32=F32_LEAVES)
        else:
            hd = cfg.hd
            block["mixer"] = _params({
                "wq": (n, d, cfg.n_heads, hd),
                "wk": (n, d, cfg.n_kv_heads, hd),
                "wv": (n, d, cfg.n_kv_heads, hd),
                "wo": (n, cfg.n_heads, hd, d),
            }, dtype, self.device)
        if cfg.mlp_kind != "none":
            mlp_shapes = {"w_in": (n, d, f), "w_out": (n, f, d)}
            if cfg.mlp_kind == "gated":
                mlp_shapes["w_gate"] = (n, d, f)
            block["norm2"] = _params({"w": (n, d)}, dtype, self.device)
            block["mlp"] = _params(mlp_shapes, dtype, self.device)
        self.tree = nn.ModuleDict({
            "embed": _params({"w": (cfg.vocab_padded, d)}, dtype, self.device),
            "final_norm": _params({"w": (1, d)}, dtype, self.device),
            "slots": nn.ModuleDict({"s0": block}),
        })
        if not cfg.tie_embeddings:
            self.tree["unembed"] = _params({"w": (d, cfg.vocab_padded)}, dtype, self.device)
        self._layers: list[dict] | None = None
        if generator is not None:
            self.init(generator)

    # ------------------------------------------------------------ parameters
    def param_tree(self) -> dict:
        """The parameters as the JAX package's nested dict (``embed`` and
        ``unembed`` are leaves there, so they are here; a tied model has
        no ``unembed``)."""
        t = self.tree
        tree = {
            "embed": t["embed"]["w"],
            "final_norm": {"w": t["final_norm"]["w"]},
            "slots": {"s0": {
                name: dict(sub.items()) for name, sub in t["slots"]["s0"].items()
            }},
        }
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
    def init(self, generator: torch.Generator | int) -> None:
        """Random weights with the JAX init's scales (``layers._normal``,
        ``ssm.ssm_init``): normal / sqrt(fan_in), drawn in f32 and cast;
        norms are ones; the SSM's decays, skips and dt biases are its
        fixed values. An int seeds a new generator on the model's device."""
        if isinstance(generator, int):
            generator = torch.Generator(device=self.device).manual_seed(generator)
        cfg = self.cfg
        d = cfg.d_model

        def normal(p, scale):
            x = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=self.device)
            p.copy_(x.mul_(scale))

        tree = self.param_tree()
        normal(tree["embed"], 1.0 / math.sqrt(d))
        tree["final_norm"]["w"].fill_(1.0)
        blk = tree["slots"]["s0"]
        blk["norm1"]["w"].fill_(1.0)
        if self.kind == "ssm":
            ssm_init(blk["mixer"], d, cfg.ssm, normal)
        else:
            for k in ("wq", "wk", "wv"):
                normal(blk["mixer"][k], 1.0 / math.sqrt(d))
            normal(blk["mixer"]["wo"], 1.0 / math.sqrt(cfg.n_heads * cfg.hd))
        if "mlp" in blk:
            blk["norm2"]["w"].fill_(1.0)
            normal(blk["mlp"]["w_in"], 1.0 / math.sqrt(d))
            if "w_gate" in blk["mlp"]:
                normal(blk["mlp"]["w_gate"], 1.0 / math.sqrt(d))
            normal(blk["mlp"]["w_out"], 1.0 / math.sqrt(cfg.d_ff))
        if "unembed" in tree:
            normal(tree["unembed"], 1.0 / math.sqrt(d))
        self._layers = None

    def _layer_params(self) -> list[dict]:
        """Per-layer views of the stacked block params (built once)."""
        if self._layers is None:
            blk = self.param_tree()["slots"]["s0"]
            self._layers = [
                {name: {k: v[i] for k, v in sub.items()} for name, sub in blk.items()}
                for i in range(self.n_groups)
            ]
        return self._layers

    # ----------------------------------------------------------------- stack
    def _norm(self, w, x):
        return L.rms_norm(x, w, self.cfg.norm_eps, plus_one=self.cfg.norm_plus_one)

    def _add_mlp(self, blk, x):
        """x plus the block's MLP of x (x itself when the config has no MLP)."""
        cfg = self.cfg
        if cfg.mlp_kind == "none":
            return x
        return x + L.mlp(blk["mlp"], self._norm(blk["norm2"]["w"], x), cfg.mlp_kind, cfg.mlp_act)

    def _ssm(self, blk, h, slot, i):
        """The SSM mixer of layer ``i``; with ``slot`` it starts from the
        layer's cached state and writes the new one back in place."""
        cfg = self.cfg
        state = None if slot is None else {"conv": slot["conv"][i], "ssd": slot["ssd"][i]}
        out, new = ssm_mixer(blk["mixer"], h, cfg.ssm, state, cfg.norm_eps)
        if slot is not None:
            slot["conv"][i].copy_(new["conv"])
            slot["ssd"][i].copy_(new["ssd"])
        return out

    def _run_stack(self, x, positions, caches=None):
        """Full-sequence pass; with ``caches`` (prefill) each layer's K/V or
        SSM state is written into them."""
        slot = caches["slots"]["s0"] if caches is not None else None
        for i, blk in enumerate(self._layer_params()):
            h = self._norm(blk["norm1"]["w"], x)
            if self.kind == "ssm":
                out = self._ssm(blk, h, slot, i)
            elif slot is None:
                out = L.attention(blk["mixer"], h, self.ap, positions)
            else:
                out, k, v = L.attention(blk["mixer"], h, self.ap, positions, return_kv=True)
                _fill_kv_cache(slot, i, k, v)
            x = self._add_mlp(blk, x + out)
        return x

    def _embed_tokens(self, tokens):
        tokens = torch.as_tensor(tokens, device=self.device).long()
        embed = self.tree["embed"]["w"]
        return embed[tokens].to(torch_dtype(self.policy.compute_dtype))

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

    def init_cache(self, batch_size: int, s_cache: int, dtype=None):
        """Contiguous decode cache: k/v (L, B, s_cache, Kv, hd), pos (L,);
        for the SSM pattern the per-layer states conv (L, B, W-1, C) and
        ssd (L, B, H, N, P), both f32 (``s_cache`` and ``dtype`` unused)."""
        cfg = self.cfg
        if self.kind == "ssm":
            st = ssm_init_state(batch_size, cfg.ssm, self.device)
            return {"slots": {"s0": {
                k: v.unsqueeze(0).repeat((self.n_groups,) + (1,) * v.dim()) for k, v in st.items()
            }}}
        dtype = torch_dtype(self.policy.kv_cache_dtype) if dtype is None else dtype
        shape = (self.n_groups, batch_size, s_cache, cfg.n_kv_heads, cfg.hd)
        return {"slots": {"s0": {
            "k": torch.zeros(shape, dtype=dtype, device=self.device),
            "v": torch.zeros(shape, dtype=dtype, device=self.device),
            "pos": torch.zeros((self.n_groups,), dtype=torch.int32, device=self.device),
        }}}

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
        scalar per layer for ``init_cache``, per row for the paged cache (the
        JAX signature's ``pos`` feeds only learned position embeddings, which
        are not ported); SSM layers need none. Returns (logits (B, 1,
        vocab_padded), caches)."""
        slot = caches["slots"]["s0"]
        x = self._embed_tokens(tokens)
        for i, blk in enumerate(self._layer_params()):
            h = self._norm(blk["norm1"]["w"], x)
            if self.kind == "ssm":
                out = self._ssm(blk, h, slot, i)
            elif "bt" in slot:
                out, _, _ = L.paged_decode_attention(
                    blk["mixer"], h, slot["k"][i], slot["v"][i], slot["pos"][i],
                    slot["bt"][i], self.ap,
                )
            else:
                out, _, _ = L.decode_attention(
                    blk["mixer"], h, slot["k"][i], slot["v"][i], slot["pos"][i], self.ap,
                )
            x = self._add_mlp(blk, x + out)
        if "pos" in slot:
            slot["pos"] += 1
        return self._logits(x), caches


def _fill_kv_cache(slot: dict, i: int, k, v) -> None:
    """Write layer ``i``'s prefill K/V (B, S, Kv, D) into a cache of ``sz``
    slots; with S > sz keep the last sz positions rotated so that slot ==
    position % sz (the ring layout of the JAX function)."""
    sz = slot["k"].shape[2]
    s = k.shape[1]
    if s >= sz:
        shift = s % sz
        slot["k"][i] = torch.roll(k[:, s - sz:], shift, dims=1).to(slot["k"].dtype)
        slot["v"][i] = torch.roll(v[:, s - sz:], shift, dims=1).to(slot["v"].dtype)
    else:
        slot["k"][i, :, :s] = k.to(slot["k"].dtype)
        slot["v"][i, :, :s] = v.to(slot["v"].dtype)
    slot["pos"][i] = s
