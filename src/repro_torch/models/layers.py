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

On a mesh (``mesh`` and ``policy``) the layers take the rank's blocks of
the weights and run JAX's strategies with explicit collectives: the
prefill's "heads" and "seq" attention hand back their K/V for the cache,
and the decode runs the rank's query heads (the plain path) or, with
``seq_axis``, JAX's ``_flash_decode`` over the rank's slice of the cache.
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
    mesh=None,  # on a mesh: p holds this rank's blocks
    policy: Policy | None = None,
):
    """Full-sequence attention (training / prefill): self attention, causal
    or not as ``ap`` says; with ``ap.cross`` the queries come from x and
    the keys and values from ``kv_source``, with no RoPE, no bias and no
    mask (JAX's ``attention``, ``causal and not cross``). On a ``mesh`` it
    runs JAX's strategy (:func:`attn_strategy`): :func:`_heads_attention`
    or :func:`_seq_attention`, or replicated as here. A prefill's K/V
    (``return_kv``) are every position's, over the kv heads ``wk`` holds:
    this rank's block where the model axis splits them, else all."""
    strat = "none" if mesh is None else attn_strategy(ap, policy, x.shape[1])
    if strat == "heads":
        return _heads_attention(p, x, ap, positions, kv_source, mesh, policy.tp_axis, return_kv)
    if strat == "seq":
        return _seq_attention(p, x, ap, positions, kv_source, mesh, policy.tp_axis, return_kv)
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


def _head_blocks(ap: AttnParams, mesh, tp) -> tuple[bool, bool, int, int]:
    """How a mesh's model axis splits one attention: (query heads split,
    kv heads split, and the range [lo, hi) of the kv heads the rank's
    query heads read, among those ``wk`` holds). The query heads split
    where the axis divides them, the kv heads where it divides those too
    (JAX's ``attention_pspecs``); where only the query heads split, the
    rank reads whole groups of them, or a share of one."""
    n = 1 if mesh is None else mesh.size(tp)
    h_split = n > 1 and ap.n_heads % n == 0
    kv_split = h_split and ap.n_kv % n == 0
    if not h_split:
        return False, False, 0, ap.n_kv
    if kv_split:
        return True, True, 0, ap.n_kv // n
    r, h_loc, rep = mesh.coord(tp), ap.n_heads // n, ap.n_heads // ap.n_kv
    if not (h_loc % rep == 0 or rep % h_loc == 0):  # whole groups, or a share of one
        raise NotImplementedError(
            f"{n} ranks split {ap.n_heads} query heads into blocks that straddle the groups of {rep} over "
            f"{ap.n_kv} kv heads unevenly"
        )
    return True, False, r * h_loc // rep, ((r + 1) * h_loc - 1) // rep + 1


def _heads_attention(p, x, ap: AttnParams, positions, kv_source, mesh, tp, return_kv: bool = False):
    """``"heads"``: this rank's query heads (the model axis divides them)
    over the kv heads they read. Where the kv heads split too, ``wk`` and
    ``wv`` are this rank's; where they do not (replicated), the rank takes
    the kv heads its query heads read, unrepeated (K1 reads each query
    head's kv head by its index), and a prefill projects them all for its
    cache. The output projection's rows are the rank's heads: summed over
    the axis."""
    h_loc = ap.n_heads // mesh.size(tp)
    _, kv_split, lo, hi = _head_blocks(ap, mesh, tp)
    p = dict(p)
    whole = {}
    if not kv_split:
        for key in ("wk", "wv", "bk", "bv"):
            if key in p:
                whole[key] = p[key]
                p[key] = p[key][..., lo:hi, :]
    apl = dataclasses.replace(ap, n_heads=h_loc, n_kv=hi - lo)
    src = kv_source if ap.cross else x
    if return_kv and whole:  # every kv head for the cache, the rank's among them for K1
        pk = dict(p, **whole)
        k_all, v_all = _proj(src, pk["wk"]), _proj(src, pk["wv"])
        if not ap.cross and ap.bias:
            k_all, v_all = k_all + pk["bk"], v_all + pk["bv"]
    if ap.cross:
        q, k, v = _proj(x, p["wq"]), _proj(kv_source, p["wk"]), _proj(kv_source, p["wv"])
    else:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        q, k, v = _project_qkv(p, x, apl, positions)
        if return_kv and whole and ap.use_rope:
            k_all = rope(k_all, positions, ap.rope_theta)
    out = attention_op(q, k, v, causal=ap.causal and not ap.cross, window=ap.window, softcap=ap.softcap)
    y = SH.all_reduce(_out_proj(out, p["wo"]), mesh, tp)
    if return_kv:
        return (y, k_all, v_all) if whole else (y, k, v)
    return y


def _seq_attention(p, x, ap: AttnParams, positions, kv_source, mesh, tp, return_kv: bool = False):
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
    y = _out_proj(SH.all_gather(out, 1, mesh, tp), p["wo"])
    return (y, k, v) if return_kv else y


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
    mesh=None,  # on a mesh: p and the caches hold this rank's blocks
    policy: Policy | None = None,
):
    """One-token decode against a contiguous KV cache; returns (out,
    cache_k, cache_v) with the caches updated in place. In a ring the new
    K/V goes to slot ``pos % S_cache``. With ``ap.cross`` the caches are
    the encoder's K/V projections: no write, no mask, and the f32 scores
    divided by sqrt(D) as JAX divides them (the self path multiplies by
    the scale).

    On a ``mesh`` x is this rank's rows. Where the model axis splits the
    heads the rank computes its query heads (and its kv heads, where
    those split too) and the row-parallel output projection is summed
    over the axis. With ``policy.seq_axis`` the cache holds this rank's
    slice of the sequence and every kv head, and a scalar or per-row
    position decodes through :func:`_flash_decode`; otherwise (JAX's
    plain path) it holds the kv heads ``wk`` holds, every slot."""
    tp = None if mesh is None else policy.tp_axis
    h_split, kv_split, lo, hi = _head_blocks(ap, mesh, tp)
    apl = dataclasses.replace(ap, n_heads=ap.n_heads // mesh.size(tp), n_kv=hi - lo) if h_split else ap
    kview = (lambda t: t[:, :, lo:hi]) if h_split and not kv_split else (lambda t: t)
    if ap.cross:
        q = _proj(x, p["wq"])
        kf = _repeat_kv(kview(cache_k), apl.n_heads).to(q.dtype)
        vf = _repeat_kv(kview(cache_v), apl.n_heads).to(q.dtype)
        sc = torch.einsum("bqhd,bkhd->bhqk", q, kf).float() / math.sqrt(ap.head_dim)
        w = torch.softmax(sc, dim=-1).to(q.dtype)
        y = _out_proj(torch.einsum("bhqk,bkhd->bqhd", w, vf), p["wo"])
        return (SH.all_reduce(y, mesh, tp) if h_split else y), cache_k, cache_v
    b = x.shape[0]
    pos = cache_pos.to(device=x.device, dtype=torch.long)
    per_row = pos.dim() == 1
    if per_row and pos.shape[0] != b:  # a per-row position of every row: this rank's rows
        pos = pos.reshape(-1, b)[mesh.coord(_row_axes(policy, mesh, pos.shape[0]))]
    positions = pos[:, None] if per_row else pos.reshape(1)

    q, kn, vn = _project_qkv(p, x, apl, positions)
    if mesh is not None and policy.seq_axis is not None:
        if h_split:  # every head on every rank of the sequence axes (JAX's replicated q, kn, vn)
            q = SH.all_gather(q, 2, mesh, tp)
            if kv_split:
                kn, vn = SH.all_gather(kn, 2, mesh, tp), SH.all_gather(vn, 2, mesh, tp)
        out = _flash_decode(q, kn, vn, cache_k, cache_v, pos, ap, mesh, policy.seq_axis, ring=ring)
        if h_split:
            h_loc = ap.n_heads // mesh.size(tp)
            out = out[:, :, mesh.coord(tp) * h_loc:(mesh.coord(tp) + 1) * h_loc]
            return SH.all_reduce(_out_proj(out, p["wo"]), mesh, tp), cache_k, cache_v
        return _out_proj(out, p["wo"]), cache_k, cache_v
    s_cache = cache_k.shape[1]
    slot = pos % s_cache if ring else pos
    if per_row:
        rows = torch.arange(b, device=x.device)
        cache_bits(cache_k)[rows, slot] = cache_bits(to_cache(kn[:, 0], cache_k.dtype))
        cache_bits(cache_v)[rows, slot] = cache_bits(to_cache(vn[:, 0], cache_v.dtype))
    else:
        cache_bits(cache_k).index_copy_(1, slot.reshape(1), cache_bits(to_cache(kn, cache_k.dtype)))
        cache_bits(cache_v).index_copy_(1, slot.reshape(1), cache_bits(to_cache(vn, cache_v.dtype)))
    valid = _decode_valid(pos, s_cache, ring=ring, window=ap.window)
    out = _attend(q, kview(cache_k), kview(cache_v), valid, apl)
    y = _out_proj(out, p["wo"])
    return (SH.all_reduce(y, mesh, tp) if h_split else y), cache_k, cache_v


def _row_axes(policy: Policy, mesh, batch: int) -> tuple[str, ...]:
    """The mesh axes of more than one rank that a batch of ``batch`` rows
    splits over (JAX's ``batch_spec``)."""
    return tuple(a for a in SH.axes_of(policy.batch_spec(batch)) if mesh.size(a) > 1)


def _flash_decode(q, kn, vn, cache_k, cache_v, pos, ap: AttnParams, mesh, seq_axes, *, ring: bool):
    """JAX's ``_flash_decode`` in torch ops and the mesh's collectives: the
    cache's sequence is split over ``seq_axes`` (this rank's slice of
    S_cache / n slots, every kv head), q, kn and vn hold every head. The
    slot's owner writes the new K/V (the others rewrite what they hold:
    ``clip`` and ``in_range``, in a ring too); each rank scores its slots,
    masked with ``-inf``, takes its max (0 where it holds no valid slot),
    its sum of exponentials and its weighted values, and the ranks merge
    them: the max over the axes, then the sums scaled by ``exp(m - max)``
    (the correction in o's dtype, as JAX casts it), divided by ``max(l,
    1e-30)``. A per-row position (B,) masks and writes each row at its
    own slot, the same merge (JAX runs its plain path there, on the
    partitioner's gathers). Returns (B, 1, H, D); the caches in place."""
    b = q.shape[0]
    axes = SH.axes_of(seq_axes)
    order = [mesh.axis_names.index(a) for a in axes if a in mesh.axis_names]
    if order != sorted(order):
        raise ValueError(f"seq_axis {seq_axes} must name the mesh's axes in its order {mesh.axis_names}")
    s_loc = cache_k.shape[1]
    s_cache = s_loc * mesh.size(axes)
    offset = mesh.coord(axes) * s_loc
    scale = 1.0 / math.sqrt(ap.head_dim)
    gq = ap.n_heads // ap.n_kv
    per_row = pos.dim() == 1
    slot = pos % s_cache if ring else pos
    lslot = torch.clamp(slot - offset, 0, s_loc - 1)
    in_range = (slot >= offset) & (slot < offset + s_loc)
    rows = torch.arange(b, device=q.device)
    for cache, new in ((cache_k, kn), (cache_v, vn)):  # predicated write, through an fp8 cache's bits
        bits = cache_bits(cache)
        new = cache_bits(to_cache(new[:, 0], cache.dtype))
        if per_row:
            bits[rows, lslot] = torch.where(in_range[:, None, None], new, bits[rows, lslot])
        else:
            cur = bits.index_select(1, lslot.reshape(1))[:, 0]
            bits.index_copy_(1, lslot.reshape(1), torch.where(in_range, new, cur)[:, None])
    qg = q.reshape(b, 1, ap.n_kv, gq, ap.head_dim)
    sc = torch.einsum("bqkgd,bskd->bkgqs", qg, cache_k.to(q.dtype)).float() * scale  # (B, K, G, 1, S_loc)
    sc = softcap(sc, ap.softcap) if ap.softcap else sc
    gidx = offset + torch.arange(s_loc, device=q.device)
    p_ = pos.reshape(-1, 1)
    valid = gidx[None, :] <= p_
    if not ring and ap.window is not None:
        valid &= gidx[None, :] > p_ - ap.window
    sc = torch.where(valid[:, None, None, None, :], sc, torch.full_like(sc, -math.inf))
    m_loc = sc.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m_loc), m_loc, torch.zeros_like(m_loc))
    w = torch.where(torch.isfinite(sc), torch.exp(sc - m_safe), torch.zeros_like(sc))
    l_loc = w.sum(dim=-1, keepdim=True)
    o_loc = torch.einsum("bkgqs,bskd->bkgqd", w.to(q.dtype), cache_v.to(q.dtype))
    m_g = SH.all_reduce_max(m_safe, mesh, axes)
    corr = torch.exp(m_safe - m_g)
    l_g = SH.all_reduce(l_loc * corr, mesh, axes)
    o_g = SH.all_reduce(o_loc * corr.to(o_loc.dtype), mesh, axes)
    out = (o_g / torch.clamp(l_g, min=1e-30).to(o_loc.dtype)).to(q.dtype)
    return out.reshape(b, 1, ap.n_heads, ap.head_dim)


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
    *,
    mesh=None,  # on a mesh: p and the pool hold this rank's heads
    policy: Policy | None = None,
):
    """One-token decode against a paged (block-table) KV cache.

    The new token's K/V is scattered to its (block, offset); rows whose
    position drifted past their table clamp to the last entry (an
    all-zeros table routes idle rows to scratch block 0). Reads gather
    each row's blocks into a (B, max_blocks * block) view and mask
    everything past the row's position (stale freed blocks included) to
    -1e30. Returns (out, cache_k, cache_v), the caches updated in place.
    On a ``mesh`` the pool holds the kv heads ``wk`` holds and every row;
    the rank decodes its query heads, as :func:`decode_attention`'s plain
    path does.
    """
    b = x.shape[0]
    n_phys, blk_sz, n_kv, hd = cache_k.shape
    max_blocks = block_table.shape[1]
    pos = cache_pos.to(device=x.device, dtype=torch.long)
    tp = None if mesh is None else policy.tp_axis
    h_split, kv_split, lo, hi = _head_blocks(ap, mesh, tp)
    if h_split:
        ap = dataclasses.replace(ap, n_heads=ap.n_heads // mesh.size(tp), n_kv=hi - lo)
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
    if h_split and not kv_split:
        kf, vf = kf[:, :, lo:hi], vf[:, :, lo:hi]
    out = _attend(q, kf, vf, _decode_valid(pos, s_virt, ring=False, window=ap.window), ap)
    y = _out_proj(out, p["wo"])
    return (SH.all_reduce(y, mesh, tp) if h_split else y), cache_k, cache_v
