"""K1's backward (``csrc/flash_attention_bwd.cu``, bf16 path) on the CPU:
the tiles it visits and the arithmetic it does, in its order.

The CUDA kernels cannot run here, so this file mirrors them in Python:

- ``kv_steps`` / ``q_tiles`` are the ranges the dK/dV and dQ blocks walk
  (``Mask::queries`` and ``Mask::key_tiles`` at the kernels' tile sizes),
  and ``interior_keys`` / ``interior_rows`` the tests that let a block skip
  the per-element mask. They are held against a brute-force scan of the
  mask: a tile that is skipped but holds a kept pair fails, and so does an
  "interior" tile that holds a dropped pair.
- ``kernel_model`` computes dq, dk and dv as the kernels do: P from the
  forward's base-2 log-sum-exp, Di = rowsum(dO o O), dQ by query tile over
  its key tiles, dK and dV by key tile over the query steps of each GQA
  group's heads, the groups' f32 partial sums added in group order, and
  (``bf16=True``) P and dS rounded to bf16 where the kernels round them.
  With a softcap (head dim 256, gemma2-2b's 50) it mirrors the capped
  path: t = tanh(s scale / cap) from the raw score, P from the forward's
  lse2 of the capped scores cap t (the mask applied after the cap), and
  the factor 1 - t^2 folded into the value dS takes for P, P (1 - t^2),
  as the kernels fold it (they keep no t), while dV's product takes P.
  In f32 it is held to autograd through ``ref.mha`` and to ``jax.grad`` of
  the JAX package's ``layers._chunked_attention`` on the same numpy inputs
  at 2e-5 of each gradient's largest element (the f32 tolerance the card
  holds the kernel to; sums in another order); with the bf16 rounding, to
  autograd at 2e-2 (``chip_smoke.BWD_TOL``'s bf16 tolerance).

The tile sizes and the GQA split are read from the kernel's source, so
the mirror follows it, at head dim 256 too: there a dK/dV block holds 64
keys (its two warpgroups each one D half of them, which changes no sum's
order), dQ takes 64-key tiles, and the split's cap is GQA_SPLIT_D256. The kernels themselves are held on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import AttnParams, _chunked_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

SRC = (Path(fa.__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu").read_text()
LOG2E = 1.4426950408889634
F32_TOL, BF16_TOL = 2e-5, 2e-2


def _source_int(pattern: str) -> int:
    m = re.search(pattern, SRC)
    assert m is not None, f"{pattern!r} not in the kernel's source"
    return int(m.group(1))


GQA_SPLIT = _source_int(r"constexpr int GQA_SPLIT = (\d+);")
KV_CONSUMERS = _source_int(r"constexpr int KV_CONSUMERS = (\d+);")
BN_KV = 64 * KV_CONSUMERS  # KvTiles::BN: keys a dK/dV block
BQ = _source_int(r"static constexpr int BQ = (\d+);")  # KvTiles::BQ: queries a dK/dV step
BM = 64 * _source_int(r"struct QTiles \{[^}]*?static constexpr int CONSUMERS = (\d+);")  # queries a dQ block
DQ_KEYS = _source_int(r"constexpr int DQ_KEYS = (\d+);")  # QTiles::BN: keys a dQ tile
# head dim 256: the split's cap, keys a dK/dV block (64 x CONSUMERS / HALVES), keys a dQ tile
GQA_SPLIT_D256 = _source_int(r"constexpr int GQA_SPLIT_D256 = (\d+);")
BN_KV_D256 = (64 * _source_int(r"static constexpr int CONSUMERS = D == 256 \? (\d+) : KV_CONSUMERS;")
              // _source_int(r"static constexpr int HALVES = D == 256 \? (\d+) : 1;"))
DQ_KEYS_D256 = _source_int(r"static constexpr int BN = D == 256 \? (\d+) : DQ_KEYS;")


def gqa_split(rep: int, d: int = 128) -> int:
    """``gqa_split``: the largest divisor of rep up to GQA_SPLIT (GQA_SPLIT_D256 at head dim 256)."""
    g = min(GQA_SPLIT_D256 if d == 256 else GQA_SPLIT, rep)
    while rep % g:
        g -= 1
    return g


def kv_steps(s, causal, window, k0, bn=BN_KV, bq=BQ, sk=None, qoff=0):
    """The query steps (their first rows) the dK/dV block of keys [k0, k0 +
    bn) walks; s queries at positions qoff.. and ``sk`` keys (s where
    None). Empty where no query sees the block (``Mask::queries`` gives lo
    > hi and the block walks no step)."""
    sk = s if sk is None else sk
    k_last = min(k0 + bn, sk) - 1
    lo = max(0, k0 - qoff) if causal else 0
    hi = min(s - 1, k_last + window - 1 - qoff) if window else s - 1
    if hi < lo:
        return range(0)
    return range(lo // bq * bq, hi + 1, bq)


def q_tiles(s, causal, window, q0, bn, bm=BM, sk=None, qoff=0):
    """The bn-key tiles the dQ block of queries [q0, q0 + bm) walks (the
    forward's ``Mask::key_tiles`` too, at its tile sizes)."""
    sk = s if sk is None else sk
    q_last = min(q0 + bm, s) - 1 + qoff
    hi = min(q_last, sk - 1) // bn if causal else (sk - 1) // bn
    lo = max(0, q0 + qoff - window + 1) // bn if window else 0
    return range(lo, hi + 1)


def interior_rows(s, causal, window, qw, k0, tk, sk=None, qoff=0):
    """``Mask::interior``: 64 query rows from qw against keys [k0, k0 + tk)."""
    sk = s if sk is None else sk
    q_last = min(qw + 63, s - 1) + qoff
    if k0 + tk > sk or (causal and k0 + tk - 1 > qw + qoff):
        return False
    return not (window and k0 <= q_last - window)


def interior_keys(s, causal, window, kw, q0, tq=BQ, sk=None, qoff=0):
    """``Mask::interior_keys``: 64 keys from kw against queries [q0, q0 + tq)."""
    sk = s if sk is None else sk
    if kw + 64 > sk or (causal and kw + 63 > q0 + qoff):
        return False
    return not (window and kw <= min(q0 + tq, s) - 1 + qoff - window)


def kept(s, causal, window, sk=None, qoff=0):
    """(query, key) pairs the mask keeps, (S, Sk) bool: ``Mask::ok``, query
    i at position qoff + i."""
    sk = s if sk is None else sk
    q, k = np.arange(s)[:, None] + qoff, np.arange(sk)[None, :]
    ok = np.ones((s, sk), bool)
    if causal:
        ok &= k <= q
    if window:
        ok &= k > q - window
    return ok


# S at and around every tile size the kernels use (64, 128), ragged
SEQS = (1, 2, 63, 64, 65, 127, 128, 129, 191, 192, 193, 255, 256, 257, 300, 383, 384, 385, 513, 777)
MASKS = [(True, None), (True, 1), (True, 64), (True, 100), (True, 129), (False, 50), (False, 128), (False, None)]


@pytest.mark.parametrize("causal,window", MASKS)
def test_dkdv_walk_covers_every_kept_pair(causal, window):
    """Every kept pair lies in a query step its key tile visits; every step
    visited starts inside S; a warpgroup's step called interior holds only
    kept pairs (queries past S aside)."""
    for s in SEQS:
        ok = kept(s, causal, window)
        for k0 in range(0, s, BN_KV):
            steps = list(kv_steps(s, causal, window, k0))
            assert steps and all(0 <= q0 < s for q0 in steps)
            need = {q // BQ * BQ for q in np.nonzero(ok[:, k0 : k0 + BN_KV].any(1))[0]}
            assert need <= set(steps), (s, k0, sorted(need - set(steps)))
            for kw in range(k0, k0 + BN_KV, 64):
                for q0 in steps:
                    if interior_keys(s, causal, window, kw, q0):
                        assert ok[q0 : min(q0 + BQ, s), kw : kw + 64].all(), (s, kw, q0)


@pytest.mark.parametrize("causal,window", MASKS)
def test_dkdv_walk_at_head_dim_256_covers_every_kept_pair(causal, window):
    """The same at head dim 256, whose dK/dV blocks hold BN_KV_D256 keys
    (both warpgroups on the same 64)."""
    assert BN_KV_D256 == 64
    for s in SEQS:
        ok = kept(s, causal, window)
        for k0 in range(0, s, BN_KV_D256):
            steps = list(kv_steps(s, causal, window, k0, bn=BN_KV_D256))
            assert steps and all(0 <= q0 < s for q0 in steps)
            need = {q // BQ * BQ for q in np.nonzero(ok[:, k0 : k0 + BN_KV_D256].any(1))[0]}
            assert need <= set(steps), (s, k0, sorted(need - set(steps)))
            for q0 in steps:
                if interior_keys(s, causal, window, k0, q0):
                    assert ok[q0 : min(q0 + BQ, s), k0 : k0 + 64].all(), (s, k0, q0)


@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("causal,window", MASKS)
def test_dq_walk_covers_every_kept_pair(bn, causal, window):
    """Every kept pair lies in a key tile its query tile visits; every tile
    visited starts inside S; a warpgroup's tile called interior holds only
    kept pairs (rows past S aside). At key tiles of 128 (the kernel's
    DQ_KEYS) and 64 (scripts/torch_kernel_ab.py's dq_keys_64)."""
    for s in SEQS:
        ok = kept(s, causal, window)
        for q0 in range(0, s, BM):
            tiles = list(q_tiles(s, causal, window, q0, bn))
            assert tiles and all(0 <= kt * bn < s for kt in tiles)
            need = {k // bn for k in np.nonzero(ok[q0 : q0 + BM].any(0))[0]}
            assert need <= set(tiles), (s, q0, sorted(need - set(tiles)))
            for qw in range(q0, q0 + BM, 64):
                for kt in tiles:
                    if qw < s and interior_rows(s, causal, window, qw, kt * bn, bn):
                        assert ok[qw : min(qw + 64, s), kt * bn : (kt + 1) * bn].all(), (s, qw, kt)


@pytest.mark.parametrize("rep", [1, 2, 3, 4, 6, 8, 16])
def test_gqa_split_gives_each_head_one_block(rep):
    """The G blocks of a kv head take rep / G query heads each, every head once."""
    g = gqa_split(rep)
    assert 1 <= g <= GQA_SPLIT and rep % g == 0
    heads = [hk * rep + grp * (rep // g) + r for hk in range(3) for grp in range(g) for r in range(rep // g)]
    assert sorted(heads) == list(range(3 * rep))


@pytest.mark.parametrize("rep", [1, 2, 4, 8, 16])
def test_gqa_split_at_head_dim_256(rep):
    """At head dim 256 the cap is GQA_SPLIT_D256: recurrentgemma's 16 query
    heads over one kv head go to GQA_SPLIT_D256 blocks a key tile, each
    head once."""
    g = gqa_split(rep, 256)
    assert 1 <= g <= GQA_SPLIT_D256 and rep % g == 0
    assert gqa_split(16, 256) == GQA_SPLIT_D256
    heads = [grp * (rep // g) + r for grp in range(g) for r in range(rep // g)]
    assert sorted(heads) == list(range(rep))


def _mask_t(s, causal, window, sk=None, qoff=0):
    return torch.from_numpy(kept(s, causal, window, sk, qoff))


def kernel_model(q, k, v, do, causal, window, bf16=False, softcap=None, qoff=0):
    """dq, dk, dv (q, do (B, H, Sq, D) at positions qoff..; k, v (B, Kv,
    Sk, D)) in the kernels' order."""
    b, h, s, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    rep, g = h // kv, gqa_split(h // kv, d)
    bn_kv = BN_KV_D256 if d == 256 else BN_KV
    scale = 1.0 / math.sqrt(d)
    sl2 = scale * LOG2E
    rnd = (lambda x: x.bfloat16().float()) if bf16 else (lambda x: x)
    kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    # the forward's outputs: O and the base-2 row log-sum-exp of the scaled (capped) scores
    out = ref.mha(q, kr, vr, causal=causal, window=window, softcap=softcap, q_offset=qoff)
    lse2 = torch.logsumexp(ref.scores(q, kr, causal=causal, window=window, softcap=softcap, q_offset=qoff), -1) * LOG2E
    di = (do * out).sum(-1)  # Di, (B, H, Sq)
    ok = _mask_t(s, causal, window, sk, qoff)

    def probs(raw, lse):
        """(P, the value dS takes for P) of raw dot products: the kernels'
        ``probs`` and ``capped_probs`` (masked pairs are zeroed by the caller)."""
        if softcap is None:
            p = torch.exp2(raw * sl2 - lse)
            return p, p
        th = torch.tanh(raw * (scale / softcap))  # Cap::inv, from the raw score: the mask comes after the cap
        p = torch.exp2(softcap * LOG2E * th - lse)  # Cap::log2
        return p, p * (1 - th * th)

    # dQ: a block per BM queries, its key tiles in order; all heads at once
    bn = DQ_KEYS_D256 if d == 256 else DQ_KEYS
    dq = torch.zeros_like(q)
    for q0 in range(0, s, BM):
        rows = slice(q0, min(q0 + BM, s))
        for kt in q_tiles(s, causal, window, q0, bn, sk=sk, qoff=qoff):
            cols = slice(kt * bn, min((kt + 1) * bn, sk))
            keep = ok[rows, cols]
            _, pf = probs(q[:, :, rows] @ kr[:, :, cols].transpose(-1, -2), lse2[:, :, rows, None])
            dp = do[:, :, rows] @ vr[:, :, cols].transpose(-1, -2)
            ds = torch.where(keep, pf * (dp - di[:, :, rows, None]), 0.0)
            dq[:, :, rows] += rnd(ds) @ kr[:, :, cols]
    dq = dq * scale

    # dK, dV: a block per (bn_kv keys, kv head, group); each group's f32 partial sums
    part_k = torch.zeros((g, b, kv, sk, d))
    part_v = torch.zeros((g, b, kv, sk, d))
    for k0 in range(0, sk, bn_kv):
        cols = slice(k0, min(k0 + bn_kv, sk))
        for hk in range(kv):
            for grp in range(g):
                for i in range(rep // g):
                    hh = hk * rep + grp * (rep // g) + i
                    for q0 in kv_steps(s, causal, window, k0, bn=bn_kv, sk=sk, qoff=qoff):
                        rows = slice(q0, min(q0 + BQ, s))
                        keep = ok[rows, cols].T
                        st = k[:, hk, cols] @ q[:, hh, rows].transpose(-1, -2)
                        pt, pft = probs(st, lse2[:, hh, None, rows])
                        pt = torch.where(keep, pt, 0.0)
                        dpt = v[:, hk, cols] @ do[:, hh, rows].transpose(-1, -2)
                        dst = torch.where(keep, pft * (dpt - di[:, hh, None, rows]), 0.0)
                        part_v[grp, :, hk, cols] += rnd(pt) @ do[:, hh, rows]
                        part_k[grp, :, hk, cols] += rnd(dst) @ q[:, hh, rows]
    dk, dv = part_k[0].clone(), part_v[0].clone()
    for grp in range(1, g):  # reduce_dkdv_kernel: in group order
        dk += part_k[grp]
        dv += part_v[grp]
    return dq, dk * scale, dv


def _inputs(seed, b, s, h, kv, d, sk=None):
    sk = s if sk is None else sk
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in ((b, s, h, d), (b, sk, kv, d), (b, sk, kv, d),
                                                                        (b, s, h, d))]


def _autograd(q, k, v, do, causal, window, softcap=None, qoff=0):
    rep = q.shape[1] // k.shape[1]
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = ref.mha(leaves[0], leaves[1].repeat_interleave(rep, 1), leaves[2].repeat_interleave(rep, 1),
                  causal=causal, window=window, softcap=softcap, q_offset=qoff)
    return torch.autograd.grad(out, leaves, do)


def _jax_grads(arrays, causal, window, softcap=None, qoff=None):
    """jax.grad of layers._chunked_attention on (B, S, heads, D) arrays, as
    (B, heads, S, D) torch tensors; with ``qoff`` the queries sit at
    positions qoff.. (a context-parallel shard's ``qpos_l``) under the mask."""
    q, k, v, do = (jnp.asarray(a) for a in arrays)
    s, h, d = q.shape[1], q.shape[2], q.shape[3]
    ap = AttnParams(n_heads=h, n_kv=k.shape[2], head_dim=d, causal=causal, window=window, softcap=softcap,
                    q_block=64, cross=qoff is None and k.shape[1] != s)
    qp, kp = jnp.arange(s) + (qoff or 0), jnp.arange(k.shape[1])
    _, vjp = jax.vjp(lambda q_, k_, v_: _chunked_attention(q_, k_, v_, qp, kp, ap, grouped=False), q, k, v)
    return [torch.from_numpy(np.array(g)).transpose(1, 2) for g in vjp(do)]


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("b,s,h,kv,d,causal,window", [
    (2, 129, 8, 2, 64, True, None),    # rep 4: G 2; S a tile + 1
    (1, 255, 8, 1, 128, True, None),   # rep 8; S two dK/dV tiles - 1
    (1, 200, 4, 4, 64, True, 70),      # rep 1: G 1, no partials; causal window
    (2, 130, 6, 2, 128, False, 50),    # rep 3: G 1; window alone
    (1, 257, 16, 2, 64, True, 129),    # rep 8; S a tile multiple + 1, window past a tile
    (1, 192, 4, 2, 128, False, None),  # no mask
    (1, 130, 16, 1, 256, True, None),  # head dim 256, rep 16: G GQA_SPLIT_D256; S two 64-key tiles + 2
    (2, 100, 4, 2, 256, True, 37),     # head dim 256, a window that binds inside a tile
])
def test_kernel_model_matches_autograd_and_jax(b, s, h, kv, d, causal, window):
    arrays = _inputs(31, b, s, h, kv, d)
    q, k, v, do = (torch.from_numpy(a).transpose(1, 2) for a in arrays)
    got = kernel_model(q, k, v, do, causal, window)
    want = _autograd(q, k, v, do, causal, window)
    want_jax = _jax_grads(arrays, causal, window)
    for name, g, w, wj in zip(("dq", "dk", "dv"), got, want, want_jax):
        assert g.shape == w.shape == wj.shape
        assert _rel(g, w) <= F32_TOL, (name, _rel(g, w))
        assert _rel(g, wj) <= F32_TOL, (name, _rel(g, wj))


@pytest.mark.parametrize("s,h,kv,d,causal,window", [
    (300, 8, 1, 128, True, None),
    (257, 8, 2, 64, True, 100),
    (129, 4, 2, 128, False, 64),
    (200, 16, 1, 256, True, 50),
])
def test_kernel_model_bf16_rounding_within_tolerance(s, h, kv, d, causal, window):
    """With bf16 inputs and P and dS rounded to bf16 where the kernels round
    them, the gradients stay within the card's bf16 tolerance of autograd."""
    arrays = _inputs(32, 1, s, h, kv, d)
    q, k, v, do = (torch.from_numpy(a).bfloat16().float().transpose(1, 2) for a in arrays)
    got = kernel_model(q, k, v, do, causal, window, bf16=True)
    want = _autograd(q, k, v, do, causal, window)
    errs = [_rel(g, w) for g, w in zip(got, want)]
    assert max(errs) <= BF16_TOL, errs


# The softcap at head dim 256 (gemma2-2b's 50, and 2, where tanh bends the
# scores enough that 1 - t^2 is far from 1 and a missing factor fails):
# gemma2's GQA 2 and recurrentgemma's 16, with and without a window; window
# 2 leaves each row two keys, so every row is masked whole on every tile but
# one or two (its P 0 there and its 1 - t^2 finite: no NaN); non-causal with
# a window. The inputs are scaled by 3 so that scale QK^T reaches well past
# cap 2.
@pytest.mark.parametrize("cap", [50.0, 2.0])
@pytest.mark.parametrize("b,s,h,kv,causal,window", [
    (1, 130, 8, 4, True, None),   # gemma2's heads; S two 64-key tiles + 2
    (2, 100, 4, 2, True, 37),     # a window that binds inside a tile
    (1, 130, 4, 2, True, 2),      # every row masked whole on all tiles but one or two
    (1, 129, 16, 1, False, 50),   # rep 16: G GQA_SPLIT_D256; a window alone
])
def test_kernel_model_softcap_matches_autograd_and_jax(cap, b, s, h, kv, causal, window):
    arrays = [3 * a for a in _inputs(33, b, s, h, kv, 256)]
    q, k, v, do = (torch.from_numpy(a).transpose(1, 2) for a in arrays)
    got = kernel_model(q, k, v, do, causal, window, softcap=cap)
    want = _autograd(q, k, v, do, causal, window, softcap=cap)
    want_jax = _jax_grads(arrays, causal, window, softcap=cap)
    for name, g, w, wj in zip(("dq", "dk", "dv"), got, want, want_jax):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, w) <= F32_TOL, (name, _rel(g, w))
        assert _rel(g, wj) <= F32_TOL, (name, _rel(g, wj))
    if cap == 2.0:  # the factor matters: without it dq and dk are far off
        plain = kernel_model(q, k, v, do, causal, window, softcap=None)
        assert _rel(plain[0], want[0]) > 100 * F32_TOL


@pytest.mark.parametrize("cap", [50.0, 2.0])
def test_kernel_model_softcap_bf16_rounding_within_tolerance(cap):
    """The capped path with bf16 inputs and P and dS rounded where the
    kernels round them (dV's product takes P, dK's and dQ's P (1 - t^2)
    (dP - Di)), within the card's bf16 tolerance of autograd."""
    arrays = _inputs(34, 1, 200, 8, 4, 256)
    q, k, v, do = (torch.from_numpy(a).bfloat16().float().transpose(1, 2) for a in arrays)
    got = kernel_model(q, k, v, do, True, 50, bf16=True, softcap=cap)
    want = _autograd(q, k, v, do, True, 50, softcap=cap)
    errs = [_rel(g, w) for g, w in zip(got, want)]
    assert max(errs) <= BF16_TOL, errs


# Queries and keys of different lengths (whisper-tiny's cross attention:
# the decoder's tokens over the encoder's frames), no mask. The walks at
# every pair of SEQS-like lengths, then the kernels' arithmetic against
# autograd and jax.grad of _chunked_attention with a cross AttnParams.
CROSS_SEQS = (1, 5, 63, 64, 65, 128, 129, 200, 300, 448)


def test_walks_at_cross_lengths_cover_every_pair():
    """With no mask every dK/dV block walks every query step of Sq and every
    dQ block every key tile of Sk (at D 64 / 128 and 256); a tile called
    interior lies inside both extents."""
    for sq in CROSS_SEQS:
        for sk in CROSS_SEQS:
            for bn_kv in (BN_KV, BN_KV_D256):
                for k0 in range(0, sk, bn_kv):
                    steps = list(kv_steps(sq, False, None, k0, bn=bn_kv, sk=sk))
                    assert steps == list(range(0, sq, BQ)), (sq, sk, k0)
                    for kw in range(k0, min(k0 + bn_kv, sk), 64):
                        for q0 in steps:
                            assert interior_keys(sq, False, None, kw, q0, sk=sk) == (kw + 64 <= sk)
            for bn in (DQ_KEYS, DQ_KEYS_D256):
                for q0 in range(0, sq, BM):
                    tiles = list(q_tiles(sq, False, None, q0, bn, sk=sk))
                    assert tiles == list(range((sk - 1) // bn + 1)), (sq, sk, q0)
                    for kt in tiles:
                        assert interior_rows(sq, False, None, q0, kt * bn, bn, sk=sk) == ((kt + 1) * bn <= sk)


@pytest.mark.parametrize("b,sq,sk,h,kv,d", [
    (2, 5, 200, 4, 4, 64),     # a prompt's few queries over more keys: the query tile nearly all past Sq
    (1, 129, 200, 8, 2, 64),   # rep 4: G 2; Sq a tile + 1, Sk ragged
    (1, 300, 129, 4, 2, 64),   # Sq > Sk
    (1, 77, 130, 16, 1, 256),  # head dim 256, rep 16: G GQA_SPLIT_D256
])
def test_kernel_model_cross_lengths_match_autograd_and_jax(b, sq, sk, h, kv, d):
    arrays = _inputs(35, b, sq, h, kv, d, sk=sk)
    q, k, v, do = (torch.from_numpy(a).transpose(1, 2) for a in arrays)
    got = kernel_model(q, k, v, do, False, None)
    want = _autograd(q, k, v, do, False, None)
    want_jax = _jax_grads(arrays, False, None)
    for name, g, w, wj in zip(("dq", "dk", "dv"), got, want, want_jax):
        assert g.shape == w.shape == wj.shape
        assert _rel(g, w) <= F32_TOL, (name, _rel(g, w))
        assert _rel(g, wj) <= F32_TOL, (name, _rel(g, wj))


@pytest.mark.parametrize("sq,sk", [(4, 1500), (448, 1500)])
def test_kernel_model_cross_lengths_bf16_rounding_within_tolerance(sq, sk):
    """whisper-tiny's calls (6 heads of 64; a 4-token prompt and the
    448-token context over 1500 frames) with bf16 inputs and P and dS
    rounded where the kernels round them: within the card's bf16 tolerance
    of autograd."""
    arrays = _inputs(36, 1, sq, 6, 6, 64, sk=sk)
    q, k, v, do = (torch.from_numpy(a).bfloat16().float().transpose(1, 2) for a in arrays)
    got = kernel_model(q, k, v, do, False, None, bf16=True)
    want = _autograd(q, k, v, do, False, None)
    errs = [_rel(g, w) for g, w in zip(got, want)]
    assert max(errs) <= BF16_TOL, errs


# ------------------------------------------------------------ query offsets
# Context parallelism: a rank of the model axis holds the Sq = S / tp
# queries from q_offset over all Sk = S keys. The mirrors above take the
# offset as the kernels' Mask does (query i at position qoff + i); the
# forward's Mask::key_tiles and interior are the same formulas at its own
# tile sizes (bf16: 128 queries over 128 keys, 64 at head dim 256; f32: 64
# over 64).
FWD_TILES = [(64, 64), (128, 128), (128, 64)]  # (queries, keys) a forward block walks
OFFSET_CASES = [  # (Sq, Sk, q_offset): offset 0, a tile edge, mid-tile, the last block
    (112, 448, 0), (112, 448, 112), (112, 448, 224), (112, 448, 336),  # whisper-tiny at model 4
    (128, 1024, 0), (128, 1024, 64), (128, 1024, 37), (128, 1024, 896),  # qwen2-7b at model 8
    (100, 300, 128), (100, 300, 200), (65, 257, 192), (1, 130, 129), (64, 64, 0),
]
OFFSET_MASKS = [(True, None), (True, 1), (True, 64), (True, 100), (False, 50)]


@pytest.mark.parametrize("causal,window", OFFSET_MASKS)
def test_walks_with_a_query_offset_cover_every_kept_pair(causal, window):
    """With a query offset every kept pair lies in a step (dK/dV) and a key
    tile (dQ, the forward) its block visits; every tile called interior
    holds only kept pairs; a key block no query sees walks no step (its dK
    and dV are the zeros the kernel writes)."""
    for sq, sk, off in OFFSET_CASES:
        ok = kept(sq, causal, window, sk, off)
        for bn_kv in (BN_KV, BN_KV_D256):
            for k0 in range(0, sk, bn_kv):
                steps = list(kv_steps(sq, causal, window, k0, bn=bn_kv, sk=sk, qoff=off))
                assert all(0 <= q0 < sq for q0 in steps)
                need = {q // BQ * BQ for q in np.nonzero(ok[:, k0:k0 + bn_kv].any(1))[0]}
                assert need <= set(steps), (sq, sk, off, k0, sorted(need - set(steps)))
                if not ok[:, k0:k0 + bn_kv].any():
                    assert not steps or not any(ok[q0:q0 + BQ, k0:k0 + bn_kv].any() for q0 in steps)
                for kw in range(k0, min(k0 + bn_kv, sk), 64):
                    for q0 in steps:
                        if interior_keys(sq, causal, window, kw, q0, sk=sk, qoff=off):
                            assert ok[q0:min(q0 + BQ, sq), kw:kw + 64].all(), (sq, sk, off, kw, q0)
        for bm, bn in [(BM, DQ_KEYS), (BM, DQ_KEYS_D256)] + FWD_TILES:
            for q0 in range(0, sq, bm):
                tiles = list(q_tiles(sq, causal, window, q0, bn, bm=bm, sk=sk, qoff=off))
                assert tiles and all(0 <= kt * bn < sk for kt in tiles), (sq, sk, off, q0)
                need = {k // bn for k in np.nonzero(ok[q0:q0 + bm].any(0))[0]}
                assert need <= set(tiles), (sq, sk, off, q0, sorted(need - set(tiles)))
                for qw in range(q0, min(q0 + bm, sq), 64):
                    for kt in tiles:
                        if interior_rows(sq, causal, window, qw, kt * bn, bn, sk=sk, qoff=off):
                            assert ok[qw:min(qw + 64, sq), kt * bn:(kt + 1) * bn].all(), (sq, sk, off, qw, kt)


def test_every_row_keeps_a_key_under_an_offset():
    """Each query keeps at least its own position's key (q_offset + Sq <=
    Sk), so no row's denominator is 0 and a tile's masked leading rows are
    wiped by the first kept score (the kernels' masked-whole-tile rule)."""
    for sq, sk, off in OFFSET_CASES:
        for causal, window in OFFSET_MASKS:
            assert kept(sq, causal, window, sk, off).any(1).all(), (sq, sk, off, causal, window)


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window,off", [
    (1, 112, 448, 6, 6, 64, True, None, 224),      # whisper-tiny's decoder at model 4, rank 2
    (2, 100, 300, 4, 2, 64, True, 70, 128),        # a window that binds, offset on a tile edge
    (1, 65, 257, 8, 2, 128, True, None, 192),      # rep 4: G 2; the last block, ragged
    (1, 64, 256, 4, 1, 256, True, 100, 37),        # head dim 256, mid-tile offset, keys no query sees
    (1, 50, 120, 4, 4, 64, False, 30, 70),         # a window alone
])
def test_kernel_model_with_offset_matches_autograd_and_jax(b, sq, sk, h, kv, d, causal, window, off):
    """The backward kernels' arithmetic with a query offset against autograd
    through ``ref.mha(q_offset=)`` and ``jax.grad`` of JAX's
    ``_chunked_attention`` at positions offset.. (what a context-parallel
    shard computes); dk and dv of keys no query sees are 0."""
    arrays = _inputs(37, b, sq, h, kv, d, sk=sk)
    q, k, v, do = (torch.from_numpy(a).transpose(1, 2) for a in arrays)
    got = kernel_model(q, k, v, do, causal, window, qoff=off)
    want = _autograd(q, k, v, do, causal, window, qoff=off)
    want_jax = _jax_grads(arrays, causal, window, qoff=off)
    for name, g, w, wj in zip(("dq", "dk", "dv"), got, want, want_jax):
        assert g.shape == w.shape == wj.shape
        assert _rel(g, w) <= F32_TOL, (name, _rel(g, w))
        assert _rel(g, wj) <= F32_TOL, (name, _rel(g, wj))
    if causal:
        unseen = slice(off + sq, sk)
        assert not got[1][:, :, unseen].any() and not got[2][:, :, unseen].any()


@pytest.mark.parametrize("off", [0, 112, 224, 336])
def test_kernel_model_with_offset_bf16_rounding_within_tolerance(off):
    """whisper-tiny's causal decoder call at model 4 (112 queries from each
    offset over 448 keys, 6 heads of 64) with bf16 inputs and P and dS
    rounded where the kernels round them: within the card's bf16 tolerance
    of autograd."""
    arrays = _inputs(38, 1, 112, 6, 6, 64, sk=448)
    q, k, v, do = (torch.from_numpy(a).bfloat16().float().transpose(1, 2) for a in arrays)
    got = kernel_model(q, k, v, do, True, None, bf16=True, qoff=off)
    want = _autograd(q, k, v, do, True, None, qoff=off)
    errs = [_rel(g, w) for g, w in zip(got, want) if w.abs().max() > 0]
    assert max(errs) <= BF16_TOL, errs
