"""Shared transformer layers (port of ``repro.models.layers``, one device).

Conventions follow the JAX package: parameters are dicts of tensors with
the same keys and shapes as there (the caller indexes one layer out of
the stacked ``(L, ...)`` leaves), activations are (B, S, H, D), RoPE uses
the *interleaved* pairing, and softmax weights are cast to the query
dtype before the PV product.

Differences that belong to PyTorch: prefill attention goes through
``kernels.ops.attention_op`` (the Hopper kernel on the card) where JAX
runs ``_chunked_attention``, cross attention (the decoder's queries over
the encoder's keys, whisper) included; and the decode paths write the new token's
K/V into the cache tensors in place (no functional copy of a multi-GB
cache per step) and return those same tensors.

A cache may be ``float8_e4m3fn``. Values enter it through
:func:`to_cache`, JAX's cast (torch saturates where JAX gives NaN), and
every index write and gather on it goes through its ``uint8`` view
(:func:`cache_bits`): a bit copy, which runs on every device
(``index_copy_`` and ``roll`` have no fp8 kernel on the CPU or in CUDA).
Reads are cast to the query's dtype after the head repeat, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import attention_op
from repro_torch.models import sharding as SH
from repro_torch.models.policy import P, Policy

__all__ = [
    "AttnParams",
    "attention",
    "attention_pspecs",
    "attn_strategy",
    "cache_bits",
    "decode_attention",
    "layer_norm",
    "mlp",
    "mlp_pspecs",
    "paged_decode_attention",
    "rms_norm",
    "rope",
    "softcap",
    "to_cache",
]

MASKED = -1e30
# float8_e4m3fn's largest value is 448; a value past 464 rounds beyond it,
# which JAX's cast (ml_dtypes, XLA) makes NaN and torch's saturates to 448
FP8_E4M3_OVERFLOW = 464.0


# ---------------------------------------------------------------- KV caches
def to_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to a cache of ``dtype`` as JAX casts it: into
    ``float8_e4m3fn`` a value of magnitude above 464 (infinities included)
    becomes NaN of its sign; any other cast is ``.to``."""
    if dtype == torch.float8_e4m3fn and x.dtype != dtype:
        nan = torch.copysign(torch.full_like(x, float("nan")), x)
        x = torch.where(x.abs() > FP8_E4M3_OVERFLOW, nan, x)
    return x.to(dtype)


def cache_bits(t: torch.Tensor) -> torch.Tensor:
    """An 8-bit float tensor's ``uint8`` view (index writes and gathers on
    it copy bits exactly, on every device); any other tensor itself."""
    return t.view(torch.uint8) if t.is_floating_point() and t.element_size() == 1 else t


def _gather(cache: torch.Tensor, idx) -> torch.Tensor:
    """``cache[idx]`` through its bits."""
    return cache_bits(cache)[idx].view(cache.dtype)


# ---------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float, *, plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in f32 (gemma-style ``(1 + w)`` scaling when plus_one)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if plus_one else w.float()
    return (y * scale).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm in f32 (JAX's ``layers.layer_norm``): the mean and the
    population variance of the centred values over the last dim, then the
    scale and shift, cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ----------------------------------------------------------------------- RoPE
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Interleaved rotary embedding.

    x: (B, S, H, D) with D even; positions: (S,) or (B, S).
    """
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs  # (B?, S, half)
    cos = torch.cos(ang)[:, :, None, :]  # (B?, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :]
    xf = x.float().reshape(x.shape[:-1] + (half, 2))
    x0, x1 = xf[..., 0], xf[..., 1]
    y0 = x0 * cos - x1 * sin
    y1 = x0 * sin + x1 * cos
    return torch.stack([y0, y1], dim=-1).reshape(x.shape).to(x.dtype)


# ------------------------------------------------------------------------ MLP
def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (d, *out) -> (..., *out)."""
    out = x @ w.reshape(w.shape[0], -1).to(x.dtype)
    return out.reshape(x.shape[:-1] + w.shape[1:])


def mlp_pspecs(policy: Policy, d: int, d_ff: int, kind: str) -> dict:
    """JAX's ``mlp_pspecs``: ``d_ff`` over the model axis (column-parallel
    in, row-parallel out), ``d`` ZeRO-3 where the policy says."""
    tp = policy.tp(d_ff)
    io = P(None, policy.fsdp(d, has_tp=tp is not None), tp)
    oi = P(None, tp, policy.fsdp(d, has_tp=tp is not None))
    p = {"w_in": io, "w_out": oi}
    if kind == "gated":
        p["w_gate"] = io
    return p


def mlp(p: dict, x: torch.Tensor, kind: str, act: str = "silu") -> torch.Tensor:
    h = _proj(x, p["w_in"])
    actf = {"silu": F.silu, "gelu": lambda t: F.gelu(t, approximate="tanh")}[act]
    if kind == "gated":
        h = actf(_proj(x, p["w_gate"])) * h
    else:
        h = actf(h)
    return _proj(h, p["w_out"])


# ------------------------------------------------------------------ attention
@dataclasses.dataclass(frozen=True)
class AttnParams:
    """Static attention hyper-params for one block kind."""

    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 10000.0
    use_rope: bool = True
    causal: bool = True
    window: int | None = None  # sliding-window size (local attention)
    softcap: float | None = None  # gemma2 attn-logit capping
    bias: bool = False  # qwen2 QKV bias
    cross: bool = False  # enc-dec cross attention (K/V from encoder)


def attn_strategy(ap: AttnParams, policy: Policy, seq_len: int) -> str:
    """JAX's ``attn_strategy``: ``"heads"`` where the heads split over the
    model axis, else ``"seq"`` (context parallelism: the queries split by
    position) where the sequence does, else ``"none"`` (replicated)."""
    tp = policy.size(policy.tp_axis)
    if tp == 1:
        return "none"
    if ap.n_heads % tp == 0:
        return "heads"
    if seq_len % tp == 0 and seq_len >= tp:
        return "seq"
    return "none"


def attention_pspecs(policy: Policy, d: int, ap: AttnParams) -> dict:
    """JAX's ``attention_pspecs``: query heads (and kv heads where they
    divide) over the model axis, ``d`` ZeRO-3 where the policy says."""
    h = policy.tp(ap.n_heads)
    kv = policy.tp(ap.n_kv)
    eq = policy.fsdp(d, has_tp=h is not None)
    ekv = policy.fsdp(d, has_tp=kv is not None)
    p = {
        "wq": P(None, eq, h, None),
        "wk": P(None, ekv, kv, None),
        "wv": P(None, ekv, kv, None),
        "wo": P(None, h, None, eq),
    }
    if ap.bias:
        p["bq"] = P(None, h, None)
        p["bk"] = P(None, kv, None)
        p["bv"] = P(None, kv, None)
    return p


def _project_qkv(p: dict, x: torch.Tensor, ap: AttnParams, positions: torch.Tensor):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if ap.bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if ap.use_rope:
        q = rope(q, positions, ap.rope_theta)
        k = rope(k, positions, ap.rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,S,Kv,D) -> (B,S,H,D), kv head h serves q heads [h*rep, (h+1)*rep)."""
    rep = n_heads // k.shape[2]
    return k if rep == 1 else cache_bits(k).repeat_interleave(rep, dim=2).view(k.dtype)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) x (H, D, d) -> (B, S, d)."""
    b, s = out.shape[:2]
    return out.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1]).to(out.dtype)


def attention(
    p: dict,
    x: torch.Tensor,  # (B, S, d)
    ap: AttnParams,
    positions: torch.Tensor | None = None,  # (S,)
    return_kv: bool = False,  # prefill: also return unrepeated K/V
    kv_source: torch.Tensor | None = None,  # (B, S_src, d) encoder states for cross attention
    *,
    mesh=None,  # training on a mesh: p holds this rank's blocks
    policy: Policy | None = None,
):
    """Full-sequence attention (training / prefill): self attention, causal
    or not as ``ap`` says; with ``ap.cross`` the queries come from x and
    the keys and values from ``kv_source``, with no RoPE, no bias and no
    mask (JAX's ``attention``, ``causal and not cross``). On a ``mesh`` it
    runs JAX's strategy (:func:`attn_strategy`): :func:`_heads_attention`
    or :func:`_seq_attention`, or replicated as here."""
    strat = "none" if mesh is None else attn_strategy(ap, policy, x.shape[1])
    if strat != "none" and return_kv:
        raise NotImplementedError("a prefill's K/V on a mesh (serving on a mesh, ROADMAP Queue 1 item 10b)")
    if strat == "heads":
        return _heads_attention(p, x, ap, positions, kv_source, mesh, policy.tp_axis)
    if strat == "seq":
        return _seq_attention(p, x, ap, positions, kv_source, mesh, policy.tp_axis)
    if ap.cross:
        q = _proj(x, p["wq"])
        k = _proj(kv_source, p["wk"])
        v = _proj(kv_source, p["wv"])
    else:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        q, k, v = _project_qkv(p, x, ap, positions)
    out = attention_op(q, k, v, causal=ap.causal and not ap.cross, window=ap.window, softcap=ap.softcap)
    y = _out_proj(out, p["wo"])
    if return_kv:
        return y, k, v
    return y


def _heads_attention(p, x, ap: AttnParams, positions, kv_source, mesh, tp) -> torch.Tensor:
    """``"heads"``: this rank's query heads (the model axis divides them)
    over the kv heads they read. Where the kv heads split too, ``wk`` and
    ``wv`` are this rank's; where they do not (replicated), the rank takes
    the kv heads its query heads read, unrepeated (K1 reads each query
    head's kv head by its index). The output projection's rows are the
    rank's heads: summed over the axis."""
    n, r = mesh.size(tp), mesh.coord(tp)
    h_loc, rep = ap.n_heads // n, ap.n_heads // ap.n_kv
    p = dict(p)
    if ap.n_kv % n == 0:
        kv_loc = ap.n_kv // n
    elif h_loc % rep == 0 or rep % h_loc == 0:  # whole groups, or a share of one
        lo, hi = r * h_loc // rep, ((r + 1) * h_loc - 1) // rep + 1
        for key in ("wk", "wv", "bk", "bv"):
            if key in p:
                p[key] = p[key][..., lo:hi, :]
        kv_loc = hi - lo
    else:
        raise NotImplementedError(
            f"{n} ranks split {ap.n_heads} query heads into blocks that straddle the groups of {rep} over "
            f"{ap.n_kv} kv heads unevenly"
        )
    apl = dataclasses.replace(ap, n_heads=h_loc, n_kv=kv_loc)
    if ap.cross:
        q, k, v = _proj(x, p["wq"]), _proj(kv_source, p["wk"]), _proj(kv_source, p["wv"])
    else:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        q, k, v = _project_qkv(p, x, apl, positions)
    out = attention_op(q, k, v, causal=ap.causal and not ap.cross, window=ap.window, softcap=ap.softcap)
    return SH.all_reduce(_out_proj(out, p["wo"]), mesh, tp)


def _seq_attention(p, x, ap: AttnParams, positions, kv_source, mesh, tp) -> torch.Tensor:
    """``"seq"``, JAX's ``_context_parallel_attention``: Q, K and V over
    every head and position (replicated over the model axis, as the
    weights are), this rank's contiguous block of the queries over all
    the keys (or, for cross attention, the encoder's whole K/V) through K1
    with the block's query offset, the blocks gathered along the sequence
    (``out_specs=P(batch, tp)``), then the output projection."""
    n, r = mesh.size(tp), mesh.coord(tp)
    if ap.cross:
        q, k, v = _proj(x, p["wq"]), _proj(kv_source, p["wk"]), _proj(kv_source, p["wv"])
    else:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        q, k, v = _project_qkv(p, x, ap, positions)
    blk = x.shape[1] // n
    out = attention_op(
        q[:, r * blk:(r + 1) * blk], k, v, causal=ap.causal and not ap.cross, window=ap.window,
        softcap=ap.softcap, q_offset=0 if ap.cross else r * blk,
    )
    return _out_proj(SH.all_gather(out, 1, mesh, tp), p["wo"])


def _attend(q, kf, vf, valid, ap: AttnParams) -> torch.Tensor:
    """One query token over a (B, S, Kv, D) key/value view; valid: (B or 1, S)."""
    kf = _repeat_kv(kf, ap.n_heads).to(q.dtype)
    vf = _repeat_kv(vf, ap.n_heads).to(q.dtype)
    scale = 1.0 / math.sqrt(ap.head_dim)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, kf).float() * scale
    sc = softcap(sc, ap.softcap) if ap.softcap else sc
    sc = torch.where(valid[:, None, None, :], sc, torch.full_like(sc, MASKED))
    w = torch.softmax(sc, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, vf)


# ------------------------------------------------------------- decode (1-tok)
def decode_attention(
    p: dict,
    x: torch.Tensor,  # (B, 1, d)
    cache_k: torch.Tensor,  # (B, S_cache, Kv, D), written in place
    cache_v: torch.Tensor,
    cache_pos: torch.Tensor,  # int count of tokens already in cache: scalar
    #                           (whole batch in lockstep) or (B,) per row
    ap: AttnParams,
    *,
    ring: bool = False,  # the cache is a window-sized ring (local layers)
):
    """One-token decode against a contiguous KV cache; returns (out,
    cache_k, cache_v) with the caches updated in place. In a ring the new
    K/V goes to slot ``pos % S_cache``. With ``ap.cross`` the caches are
    the encoder's K/V projections: no write, no mask, and the f32 scores
    divided by sqrt(D) as JAX divides them (the self path multiplies by
    the scale)."""
    if ap.cross:
        q = _proj(x, p["wq"])
        kf = _repeat_kv(cache_k, ap.n_heads).to(q.dtype)
        vf = _repeat_kv(cache_v, ap.n_heads).to(q.dtype)
        sc = torch.einsum("bqhd,bkhd->bhqk", q, kf).float() / math.sqrt(ap.head_dim)
        w = torch.softmax(sc, dim=-1).to(q.dtype)
        return _out_proj(torch.einsum("bhqk,bkhd->bqhd", w, vf), p["wo"]), cache_k, cache_v
    b = x.shape[0]
    s_cache = cache_k.shape[1]
    pos = cache_pos.to(device=x.device, dtype=torch.long)
    per_row = pos.dim() == 1
    positions = pos[:, None] if per_row else pos.reshape(1)

    q, kn, vn = _project_qkv(p, x, ap, positions)
    slot = pos % s_cache if ring else pos
    if per_row:
        rows = torch.arange(b, device=x.device)
        cache_bits(cache_k)[rows, slot] = cache_bits(to_cache(kn[:, 0], cache_k.dtype))
        cache_bits(cache_v)[rows, slot] = cache_bits(to_cache(vn[:, 0], cache_v.dtype))
    else:
        cache_bits(cache_k).index_copy_(1, slot.reshape(1), cache_bits(to_cache(kn, cache_k.dtype)))
        cache_bits(cache_v).index_copy_(1, slot.reshape(1), cache_bits(to_cache(vn, cache_v.dtype)))
    valid = _decode_valid(pos, s_cache, ring=ring, window=ap.window)
    out = _attend(q, cache_k, cache_v, valid, ap)
    return _out_proj(out, p["wo"]), cache_k, cache_v


def _decode_valid(pos: torch.Tensor, s_cache: int, *, ring: bool, window: int | None) -> torch.Tensor:
    """Slots holding positions 0..pos (the token just written included),
    within the sliding window for a window layer that is not a ring: (B, S)
    for per-row pos, (1, S) else. In a ring a slot index is no position:
    the ring holds the last S_cache positions, so the window needs no mask
    and only the slots not yet written (idx > pos) are invalid."""
    idx = torch.arange(s_cache, device=pos.device)[None, :]
    p = pos.reshape(-1, 1)
    valid = idx <= p
    if not ring and window is not None:
        valid &= idx > p - window
    return valid


def paged_decode_attention(
    p: dict,
    x: torch.Tensor,  # (B, 1, d)
    cache_k: torch.Tensor,  # (N_blocks, block, Kv, D) physical pool, written in place
    cache_v: torch.Tensor,
    cache_pos: torch.Tensor,  # (B,) per-row token counts
    block_table: torch.Tensor,  # (B, max_blocks) physical block ids; virtual
    #                             position p of row b lives at
    #                             (block_table[b, p // block], p % block)
    ap: AttnParams,
):
    """One-token decode against a paged (block-table) KV cache.

    The new token's K/V is scattered to its (block, offset); rows whose
    position drifted past their table clamp to the last entry (an
    all-zeros table routes idle rows to scratch block 0). Reads gather
    each row's blocks into a (B, max_blocks * block) view and mask
    everything past the row's position (stale freed blocks included) to
    -1e30. Returns (out, cache_k, cache_v), the caches updated in place.
    """
    b = x.shape[0]
    n_phys, blk_sz, n_kv, hd = cache_k.shape
    max_blocks = block_table.shape[1]
    pos = cache_pos.to(device=x.device, dtype=torch.long)
    q, kn, vn = _project_qkv(p, x, ap, pos[:, None])

    rows = torch.arange(b, device=x.device)
    tbl_idx = torch.clamp(pos // blk_sz, max=max_blocks - 1)
    blk = block_table[rows, tbl_idx].long()
    off = pos % blk_sz
    cache_bits(cache_k)[blk, off] = cache_bits(to_cache(kn[:, 0], cache_k.dtype))
    cache_bits(cache_v)[blk, off] = cache_bits(to_cache(vn[:, 0], cache_v.dtype))

    s_virt = max_blocks * blk_sz
    bt = block_table.long()
    kf = _gather(cache_k, bt).reshape(b, s_virt, n_kv, hd)
    vf = _gather(cache_v, bt).reshape(b, s_virt, n_kv, hd)
    out = _attend(q, kf, vf, _decode_valid(pos, s_virt, ring=False, window=ap.window), ap)
    return _out_proj(out, p["wo"]), cache_k, cache_v
