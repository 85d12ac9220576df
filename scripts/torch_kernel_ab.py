#!/usr/bin/env python3
"""Time K1 (flash attention), its backward, K2 (SSD scan), its backward, K3 (RG-LRU scan), its backward or the
8-bit AdamW update of two checkouts on one card, in turns.

    mkdir -p build/ab_parent && git archive <parent commit> | tar -x -C build/ab_parent
    python3 scripts/torch_kernel_ab.py --parent build/ab_parent \
        [--kernel attention|attention_bwd|ssd|ssd_bwd|rglru|rglru_bwd|adamw8bit] [--ablate | --variants A,B]
        [--rounds N]

``--parent`` is another checkout of the repository, unpacked in a
directory that .gitignore lists. Each round runs the parent, this
checkout, this checkout again and the parent, each in a fresh process
that imports ``repro_torch`` from its own ``src/`` and builds its own
kernels, and hands that checkout's wrapper to this checkout's
``chip_smoke.check_attention``, ``check_attention_bwd``, ``check_ssd``,
``check_ssd_bwd``, ``check_rglru`` or ``check_opt8_tree``, which holds
the kernel against its plain version and times it and the plain version
(and, for K1, the library call ``F.scaled_dot_product_attention`` on
pre-repeated K/V; with a boolean mask where there is a window) with CUDA
events (``chip_smoke.time_ms``: 20 calls back to back after a warm-up,
so a call's time includes the wrapper's host time wherever that is the
longer). Each process also times 20 calls replayed from one CUDA graph
(``graph_ms``), the kernel's device time without the host's share. The
calls are the kernel's on the serving paths, bf16:

- K1 (``--kernel attention``, the default): yi-6b's four prefills,
  (1, S, 32/4, 128) causal at ``chip_smoke.PROMPT_LENS``, and
  recurrentgemma-9b's wave, (4, 3000, 16/1, 256) causal, window 2048;
- K1's backward (``--kernel attention_bwd``): the training path's call,
  (4, 1024, 32/4, 128) bf16 causal, ``phase_kernels_bwd``'s head-dim
  64 row, (2, 777, 8/2, 64) causal, recurrentgemma-9b's training
  call, (4, 1024, 16/1, 256) causal with its window of 2048, without and
  with a softcap of 50, and gemma2-2b's, (4, 1024, 8/4, 256) causal,
  with its softcap of 50 and without (a checkout whose backward lacks head
  dim 256 or the softcap gives that row no times), each held to autograd
  through ``ref.mha`` at ``BWD_TOL`` beside SDPA's backward on
  pre-repeated K/V (``library_ms``; with the softcap flex_attention's,
  ``chip_smoke.flex_library``). Each row also carries ``bit_identical``
  (two calls on one input give the same dq, dk and dv to the bit),
  ``digest`` (a hash of dq, dk and dv on an input drawn from the row's own
  seed, the same in every process: the summary's ``same_bits_as_parent``
  compares the sides) and ``kernel_us``, each CUDA kernel's device time a
  call (Di, dQ, dK/dV, the reduction) from torch.profiler;
- K2 (``--kernel ssd``): mamba2-2.7b's wave, (4, 2000, 80/1, 64), N 128,
  chunk 256, the model's decays, a zero initial state, in bf16 and in
  f32, and the teacher-forced forward's (1, 2015, 80/1, 64) with no
  initial state; then ``chip_smoke.SSD_SWEEP``'s shapes in bf16 and f32
  with a random initial state: every K2 call that ``chip_smoke.py``
  checks (a variant of ``--ablate``: the two bf16 path calls). Each row
  also carries ``el_err_state``, the final state's
  largest error against the plain version relative to rms + |want|, and
  ``kernel_us``, each CUDA kernel's device time a call from
  torch.profiler;
- K2's backward (``--kernel ssd_bwd``): mamba2-2.7b's training call,
  ``chip_smoke.SSD_TRAIN`` = (4, 1024, 80/1, 64), N 128, chunk 256, bf16,
  the model's decays, no state; then ``chip_smoke.SSD_SWEEP``'s shapes in
  bf16 and f32 with a random initial state and d(final state), each held
  to ``ref.ssd_bwd`` at ``SSD_TOL`` with ``bit_identical`` (two calls, the
  same bits) and ``kernel_us`` (each of its five CUDA kernels' device
  time a call: in bf16 chunk terms, state passing, gradients, finish and
  the partials' sums). A checkout without the backward (from before it)
  gives its rows no times;
- K3 (``--kernel rglru``, f32): recurrentgemma-9b's wave, (4, 3000, 4096)
  with the model's decays and a random h0 (the stricter check of the
  carry) and again with the zero h0 the cache hands it, and the
  teacher-forced forward's (1, 3015, 4096) with no h0, and the training
  call (4, 1024, 4096) with no h0; then
  ``chip_smoke.RGLRU_SWEEP``'s and ``RGLRU_EDGES``'s shapes with the
  tests' decays and a random h0: every K3 call that ``chip_smoke.py``
  checks (a variant of ``--ablate``: the path's random-h0 and forward
  calls). Each row also carries ``flushed_ms``, the mean of 20 calls each
  timed alone by CUDA events after 256 MB were written to evict the 50 MB
  L2 (at B 1 the inputs are 99 MB and a back-to-back call finds part of
  them in L2), and ``kernel_vs_f64_el_err``, the largest error against
  the float64 run relative to the check's tolerance.
- K3's backward (``--kernel rglru_bwd``, f32): recurrentgemma-9b's
  training call, ``chip_smoke.RGLRU_TRAIN`` = (4, 1024, 4096) with the
  model's decays, no h0 and no d(h_last) (as the mixer hands it), and
  again with both; then ``chip_smoke.RGLRU_SWEEP``'s and
  ``RGLRU_BWD_EDGES``' shapes with the tests' decays, each held to
  ``ref.rglru_bwd`` in float64 (``chip_smoke.check_rglru_bwd``), with
  ``flushed_ms``, ``bit_identical`` and ``kernel_el_err`` (the largest of
  dx's, dlog_a's and dh0's error relative to the check's tolerance); a
  variant of ``--ablate`` takes the two training calls. A checkout from
  before the backward gives its rows no times.
- the 8-bit AdamW update (``--kernel adamw8bit``): the training path's
  calls, one a leaf over yi-6b's 32-layer tree (bf16, 12 leaves), timed
  as the whole tree and held leaf by leaf against
  ``ref.adamw8bit_update`` (``chip_smoke.check_opt8_tree``), with g as
  given (the call both checkouts' wrappers take); the row's
  ``max_abs_err`` is the largest over the leaves and ``matched`` says
  whether every leaf met chip_smoke's gate. The parent and the change
  also time their optimizer phase (``optimizer_ms``): one
  ``adamw8bit(...).update`` over the tree with the global-norm clip at 1
  (their grads' norm is about 78), whatever form each checkout gives the
  clip. Each process also counts its kernels' SASS (``sass``: static
  instructions of each kernel from ``cuobjdump -sass``, with the opcodes
  of its body). No library call, no CUDA graph time.

``--ablate`` adds, in the same turns, this checkout's kernel built with
each of its refinements switched off (the named constants in the
kernel's source set to false in a copy of ``src/`` under
``build/ab_variants/``): for the 8-bit update ``ABLATE_ARITH`` (the
same loads and stores, the arithmetic cut to a copy) and ``ABLATE_LOADS``
(the arithmetic and the stores, the loads of p, g and the codes cut),
switched on, a warp a unit instead of the persistent grid
(``PERSISTENT``), and 2 or 3 thread blocks an SM in the register budget
instead of 4 (``MIN_BLOCKS``); for K1 ``OVERLAP`` and ``PINGPONG``, and one
consumer warpgroup (64-row query tiles) instead of two; for K1's
backward ``FUSED_DI`` (Di in a pass of its own) and ``STAGGER``,
``GQA_SPLIT`` 1, 4 and 8 instead of 2, ``KV_CONSUMERS`` 1 (64-key dK/dV
blocks) and ``DQ_KEYS`` 64 (the dQ kernel's key tiles); for K2
``SPLIT_XD`` (the state update's decayed xdt as one bf16 operand instead
of hi + lo), ``FAST_DECAY``, ``STATE_BF16``, ``P1_ROWS`` (the whole
chunk at once), ``P1_BLOCKS`` (no register cap), ``OUT_WARPGROUPS`` (two)
and ``HEADS_PER_BLOCK`` (one); for K2's backward ``SPLIT_DE`` (D's and
E's decayed operands as one bf16 each instead of hi + lo),
``FAST_DECAY``, ``HEADS_PER_BLOCK`` 1, 10 and 20 instead of 40, ``AHEAD``
1 (the state passing's chunks loaded one at a time), ``TERMS_BLOCKS`` 1
(no register cap on the chunk terms) and ``STAGGER``; for K3 ``PREFETCH``, ``FAST_EXP`` and
``FAST_SQRT``, 8 warps a block (``WARPS``: time blocks of 128 steps, two
blocks an SM) and 32 warps of 8 steps (``STEPS``: 1024 threads a block);
for K3's backward ``PREFETCH``, ``FAST_EXP``, ``FAST_SQRT``, 8 warps a
block (``WARPS``) and 16 steps a warp (``STEPS``: the forward's tile); for
K1's backward at head dim 256 also ``GQA_SPLIT_D256`` 2 and 8 instead of
4, and ``fast_tanh`` (the softcap's tanhf as ``tanh.approx.f32``, which
no longer meets the forward's lse2 exactly: a time, not a candidate
default). ``--variants`` takes a comma-separated subset of them.

Prints each process's rows, then a summary (per side, the median over
its processes, and the change over the parent, over SDPA and the bound
over the change) beside the card's name and power limit; writes both to
``kernel_ab.json`` in the output directory (``kernel_ab_attention_bwd.json``
for K1's backward, ``kernel_ab_ssd.json`` for K2, ``kernel_ab_ssd_bwd.json``
for its backward, ``kernel_ab_rglru.json`` for K3, ``kernel_ab_rglru_bwd.json``
for its backward, ``kernel_ab_adamw8bit.json`` for the 8-bit update).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (imports neither torch nor repro_torch here)

SOURCES = {
    "attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "attention_bwd": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "ssd": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "ssd_bwd": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
    "rglru": "src/repro_torch/kernels/csrc/rglru_scan.cu",
    "rglru_bwd": "src/repro_torch/kernels/csrc/rglru_scan_bwd.cu",
    "adamw8bit": "src/repro_torch/kernels/csrc/adamw8bit.cu",
}
# each variant: the lines of the kernel's source it changes, old -> new (each old line must occur once)
VARIANTS = {
    "attention": {
        "no_overlap": [("constexpr bool OVERLAP = true;", "constexpr bool OVERLAP = false;")],
        "no_pingpong": [("constexpr bool PINGPONG = true;", "constexpr bool PINGPONG = false;")],
        "rows_64": [("static constexpr int CONSUMERS = 2;", "static constexpr int CONSUMERS = 1;")],
    },
    "attention_bwd": {
        "no_fused_di": [("constexpr bool FUSED_DI = true;", "constexpr bool FUSED_DI = false;")],
        "no_stagger": [("constexpr bool STAGGER = true;", "constexpr bool STAGGER = false;")],
        "split_1": [("constexpr int GQA_SPLIT = 2;", "constexpr int GQA_SPLIT = 1;")],
        "split_4": [("constexpr int GQA_SPLIT = 2;", "constexpr int GQA_SPLIT = 4;")],
        "split_8": [("constexpr int GQA_SPLIT = 2;", "constexpr int GQA_SPLIT = 8;")],
        "kv_keys_64": [("constexpr int KV_CONSUMERS = 2;", "constexpr int KV_CONSUMERS = 1;")],
        "dq_keys_64": [("constexpr int DQ_KEYS = 128;", "constexpr int DQ_KEYS = 64;")],
        "split_d256_2": [("constexpr int GQA_SPLIT_D256 = 4;", "constexpr int GQA_SPLIT_D256 = 2;")],
        "split_d256_8": [("constexpr int GQA_SPLIT_D256 = 4;", "constexpr int GQA_SPLIT_D256 = 8;")],
        "fast_tanh": [("      const float th = tanhf(sc[x] * cap.inv);",
                       "      const float th = [](float u) { float y; asm(\"tanh.approx.f32 %0, %1;\" : \"=f\"(y) : "
                       "\"f\"(u)); return y; }(sc[x] * cap.inv);")],
    },
    "ssd": {
        "no_split": [("constexpr bool SPLIT_XD = true;", "constexpr bool SPLIT_XD = false;")],
        "no_fast_decay": [("constexpr bool FAST_DECAY = true;", "constexpr bool FAST_DECAY = false;")],
        "no_state_bf16": [("constexpr bool STATE_BF16 = true;", "constexpr bool STATE_BF16 = false;")],
        "whole_chunk_p1": [("constexpr int P1_ROWS = 64;", "constexpr int P1_ROWS = MAX_Q;")],
        "p1_registers_uncapped": [("constexpr int P1_BLOCKS = 4;", "constexpr int P1_BLOCKS = 1;")],
        "two_warpgroups_p3": [("constexpr int OUT_WARPGROUPS = 3;", "constexpr int OUT_WARPGROUPS = 2;")],
        "one_head_p3": [("constexpr int HEADS_PER_BLOCK = 2;", "constexpr int HEADS_PER_BLOCK = 1;")],
    },
    "ssd_bwd": {
        "no_split": [("constexpr bool SPLIT_DE = true;", "constexpr bool SPLIT_DE = false;")],
        "no_fast_decay": [("constexpr bool FAST_DECAY = true;", "constexpr bool FAST_DECAY = false;")],
        "heads_1": [("constexpr int HEADS_PER_BLOCK = 40;", "constexpr int HEADS_PER_BLOCK = 1;")],
        "heads_10": [("constexpr int HEADS_PER_BLOCK = 40;", "constexpr int HEADS_PER_BLOCK = 10;")],
        "heads_20": [("constexpr int HEADS_PER_BLOCK = 40;", "constexpr int HEADS_PER_BLOCK = 20;")],
        "ahead_1": [("constexpr int AHEAD = 8;", "constexpr int AHEAD = 1;")],
        "terms_registers_uncapped": [("constexpr int TERMS_BLOCKS = 2;", "constexpr int TERMS_BLOCKS = 1;")],
        "no_stagger": [("constexpr bool STAGGER = true;", "constexpr bool STAGGER = false;")],
    },
    "rglru": {
        "no_prefetch": [("constexpr bool PREFETCH = true;", "constexpr bool PREFETCH = false;")],
        "no_fast_exp": [("constexpr bool FAST_EXP = true;", "constexpr bool FAST_EXP = false;")],
        "no_fast_sqrt": [("constexpr bool FAST_SQRT = true;", "constexpr bool FAST_SQRT = false;")],
        "warps_8": [("constexpr int WARPS = 16;", "constexpr int WARPS = 8;")],
        "warps_32_steps_8": [("constexpr int WARPS = 16;", "constexpr int WARPS = 32;"),
                             ("constexpr int STEPS = 16;", "constexpr int STEPS = 8;")],
    },
    "rglru_bwd": {
        "no_prefetch": [("constexpr bool PREFETCH = true;", "constexpr bool PREFETCH = false;")],
        "no_fast_exp": [("constexpr bool FAST_EXP = true;", "constexpr bool FAST_EXP = false;")],
        "no_fast_sqrt": [("constexpr bool FAST_SQRT = true;", "constexpr bool FAST_SQRT = false;")],
        "warps_8": [("constexpr int WARPS = 16;", "constexpr int WARPS = 8;")],
        "steps_16": [("constexpr int STEPS = 8;", "constexpr int STEPS = 16;")],
    },
    "adamw8bit": {
        "copy_only": [("constexpr bool ABLATE_ARITH = false;", "constexpr bool ABLATE_ARITH = true;")],
        "loads_once": [("constexpr bool ABLATE_LOADS = false;", "constexpr bool ABLATE_LOADS = true;")],
        "one_shot": [("constexpr bool PERSISTENT = true;", "constexpr bool PERSISTENT = false;")],
        "min_blocks_2": [("constexpr int MIN_BLOCKS = 4;", "constexpr int MIN_BLOCKS = 2;")],
        "min_blocks_3": [("constexpr int MIN_BLOCKS = 4;", "constexpr int MIN_BLOCKS = 3;")],
    },
}
TIMES = ("ms", "graph_ms", "flushed_ms", "library_ms", "library_graph_ms", "optimizer_ms")
FLAGS = ("bit_identical", "max_abs_err", "rel_err_dq_dk_dv", "matched", "digest")
ERRORS = ("el_err_state", "kernel_vs_f64_el_err", "kernel_el_err")


def k1_calls():
    calls = [(f"yi-6b (1,{s},32/4,128)", (1, s, 32, 4, 128, None)) for s in cs.PROMPT_LENS]
    b, s = cs.WAVE_REQUESTS, cs.RG_PROMPT_LEN
    calls.append((f"recurrentgemma-9b ({b},{s},16/1,256) window 2048", (b, s, 16, 1, 256, 2048)))
    return calls


def time_graph_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA graph."""
    import torch

    fn()  # warm-up: builds and loads outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_flushed_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, each timed alone by
    CUDA events after 256 MB are written, which evicts the L2 and keeps
    the device busy while the host enqueues the call."""
    import torch

    flush = torch.empty(2**26, dtype=torch.float32, device="cuda")
    fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def kernel_us(fn, iters: int) -> dict:
    """Mean device microseconds a call of each CUDA kernel that ``fn``
    launches, from torch.profiler over ``iters`` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].split()[-1]
            out[name] = e.device_time_total / iters
    return out


def bwd_calls():
    """K1 backward's calls: yi-6b's training path's, phase_kernels_bwd's head-dim 64 row, then
    recurrentgemma-9b's training path's without and with a softcap, then gemma2-2b's with its softcap
    and without; each (b, s, h, kv, d, window, softcap), bf16, causal."""
    b, s, h, kv, d = cs.TRAIN_ATTN
    rb, rs, rh, rkv, rd = cs.RG_TRAIN_ATTN
    gb, gs, gh, gkv, gd = cs.GEMMA2_TRAIN_ATTN
    rg = f"recurrentgemma-9b training ({rb},{rs},{rh}/{rkv},{rd}) bf16 causal window {cs.RG_WINDOW}"
    g2 = f"gemma2-2b training ({gb},{gs},{gh}/{gkv},{gd}) bf16 causal"
    cap = cs.GEMMA2_CAP
    return [(f"yi-6b training ({b},{s},{h}/{kv},{d}) bf16 causal", (b, s, h, kv, d, None, None)),
            ("(2,777,8/2,64) bf16 causal", (2, 777, 8, 2, 64, None, None)),
            (rg, (rb, rs, rh, rkv, rd, cs.RG_WINDOW, None)),
            (f"{rg} softcap {cap:g}", (rb, rs, rh, rkv, rd, cs.RG_WINDOW, cap)),
            (f"{g2} softcap {cap:g}", (gb, gs, gh, gkv, gd, None, cap)),
            (g2, (gb, gs, gh, gkv, gd, None, None))]


def bwd_digest(fa, b, s, h, kv, d, window, cap) -> str:
    """A hash of dq, dk and dv of one call on an input drawn from a seed of
    the call's own (the same in every process and checkout)."""
    import hashlib

    import torch

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 31)
    q, do = (torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16().transpose(1, 2) for _ in "qo")
    k, v = (torch.randn((b, s, kv, d), generator=gen, device="cuda").bfloat16().transpose(1, 2) for _ in "kv")
    kw = {"softcap": cap} if cap is not None else {}
    o, lse = fa.flash_attention(q, k, v, causal=True, window=window, return_lse=True, **kw)
    grads = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=True, window=window, **kw)
    h_ = hashlib.sha256()
    for g in grads:
        h_.update(g.contiguous().view(torch.int16).cpu().numpy().tobytes())
    return h_.hexdigest()[:16]


def measure_attention_bwd(root: Path, label: str) -> dict:
    """Check and time one checkout's K1 backward (this process imports its ``src``)."""
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa

    assert Path(fa.__file__).resolve().is_relative_to(root.resolve()), fa.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.get("flash_attention_bwd", "").splitlines()
             if any(w in ln.lower() for w in ("registers", "spill", "warning", "function properties"))]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 4)
    out: dict = {"label": label, "root": str(root), "ptxas": ptxas, "calls": {}}
    for key, (b, s, h, kv, d, window, cap) in bwd_calls():
        # a checkout whose backward lacks this head dim, or the softcap at it
        if d not in getattr(fa, "_BWD_HEAD_DIMS", ()) or (
                cap is not None and d not in getattr(fa, "_BWD_SOFTCAP_HEAD_DIMS", ())):
            bound, by = cs.attention_bwd_bound(b, h, kv, s, d, "bfloat16", True, window)
            out["calls"][key] = {"ms": None, "bound_ms": bound, "bound_by": by}
            continue
        row = cs.check_attention_bwd(label, fa, ref, b, s, h, kv, d, "bfloat16", True, window, gen, True, cap=cap)
        row["digest"] = bwd_digest(fa, b, s, h, kv, d, window, cap)
        q, do = (torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16().transpose(1, 2) for _ in "qo")
        k, v = (torch.randn((b, s, kv, d), generator=gen, device="cuda").bfloat16().transpose(1, 2) for _ in "kv")
        kw = {"softcap": cap} if cap is not None else {}
        o, lse = fa.flash_attention(q, k, v, causal=True, window=window, return_lse=True, **kw)

        def call():
            return fa.flash_attention_bwd(q, k, v, o, do, lse, causal=True, window=window, **kw)

        first, second = call(), call()
        row["bit_identical"] = all(torch.equal(x, y) for x, y in zip(first, second))
        row["graph_ms"] = time_graph_ms(call, 20)
        row["kernel_us"] = kernel_us(call, 10)
        out["calls"][key] = row
    return out


def ssd_calls():
    """K2's calls that chip_smoke.py checks: its path's, then its sweep;
    each (b, s, h, p, n, g, chunk, dtype, initial state, model decays)."""
    b, s = cs.WAVE_REQUESTS, cs.SSM_PROMPT_LEN
    calls = [
        (f"mamba2-2.7b serving ({b},{s},80/1,64) N 128 bf16", (b, s, 80, 64, 128, 1, 256, "bfloat16", "zero", True)),
        (f"mamba2-2.7b forward (1,{s + 15},80/1,64) N 128 bf16", (1, s + 15, 80, 64, 128, 1, 256, "bfloat16", None, True)),
        (f"mamba2-2.7b serving ({b},{s},80/1,64) N 128 f32", (b, s, 80, 64, 128, 1, 256, "float32", "zero", True)),
    ]
    for shape in cs.SSD_SWEEP:
        for dtype in ("bfloat16", "float32"):
            bb, ss, h, p, n, g, chunk = shape
            calls.append((f"sweep ({bb},{ss},{h}/{g},{p}) N {n} chunk {chunk} {'bf16' if dtype == 'bfloat16' else 'f32'}",
                          (*shape, dtype, "random", False)))
    return calls


def measure_ssd(root: Path, label: str) -> dict:
    """Check and time one checkout's K2 (this process imports its ``src``)."""
    sys.path.insert(0, str(root / "src"))
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.ops import ssd_op

    assert Path(ssd_scan.__file__).resolve().is_relative_to(root.resolve()), ssd_scan.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.get("ssd_scan", "").splitlines()
             if any(w in ln.lower() for w in ("registers", "spill", "potential", "warning"))]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    out: dict = {"label": label, "root": str(root), "ptxas": ptxas, "calls": {}}
    calls = ssd_calls()
    if label not in ("parent", "change"):  # a variant: the path's bf16 calls only
        calls = calls[:2]
    for key, (b, s, h, p, n, g, chunk, dtype, state, model) in calls:
        row = cs.check_ssd(label, ref, b, s, h, p, n, g, chunk, dtype, state, gen, True, model_decays=model)
        wdt = getattr(torch, dtype)
        x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(wdt)
        bm = torch.randn((b, s, g, n), generator=gen, device="cuda").to(wdt)
        cm = torch.randn((b, s, g, n), generator=gen, device="cuda").to(wdt)
        dt = F.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
        A = -torch.linspace(1.0, 16.0, h, device="cuda")
        st0 = {None: None, "zero": torch.zeros((b, h, n, p), device="cuda"),
               "random": torch.randn((b, h, n, p), generator=gen, device="cuda")}[state]
        row["graph_ms"] = time_graph_ms(lambda: ssd_op(x, dt, A, bm, cm, st0, chunk=chunk), 20)
        row["kernel_us"] = kernel_us(lambda: ssd_op(x, dt, A, bm, cm, st0, chunk=chunk), 10)
        out["calls"][key] = row
    return out


def ssd_bwd_calls():
    """K2 backward's calls that chip_smoke.py checks: the training path's,
    then the sweep; each (b, s, h, p, n, g, chunk, dtype, state, model decays)."""
    b, s, h, p, n, g, chunk = cs.SSD_TRAIN
    calls = [(f"mamba2-2.7b training ({b},{s},{h}/{g},{p}) N {n} bf16", (*cs.SSD_TRAIN, "bfloat16", False, True))]
    for shape in cs.SSD_SWEEP:
        for dtype in ("bfloat16", "float32"):
            bb, ss, h, p, n, g, chunk = shape
            calls.append((f"sweep ({bb},{ss},{h}/{g},{p}) N {n} chunk {chunk} {'bf16' if dtype == 'bfloat16' else 'f32'}",
                          (*shape, dtype, True, False)))
    return calls


def measure_ssd_bwd(root: Path, label: str) -> dict:
    """Check and time one checkout's K2 backward (this process imports its ``src``)."""
    sys.path.insert(0, str(root / "src"))
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssd_scan

    assert Path(ssd_scan.__file__).resolve().is_relative_to(root.resolve()), ssd_scan.__file__
    out: dict = {"label": label, "root": str(root), "ptxas": [], "calls": {}}
    calls = ssd_bwd_calls()
    if not hasattr(ssd_scan, "ssd_scan_bwd"):  # a checkout from before the backward kernel
        for key, (b, s, h, p, n, g, chunk, dtype, state, _) in calls:
            bound, by = cs.ssd_bwd_bound(b, h, g, s, p, n, chunk, dtype, state)
            out["calls"][key] = {"ms": None, "bound_ms": bound, "bound_by": by}
        return out
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    out["ptxas"] = [ln.strip() for ln in _build.BUILD_LOG.get("ssd_scan_bwd", "").splitlines()
                    if any(w in ln.lower() for w in ("registers", "spill", "warning"))]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for key, (b, s, h, p, n, g, chunk, dtype, state, model) in calls:
        row = cs.check_ssd_bwd(label, ssd_scan, ref, b, s, h, p, n, g, chunk, dtype, state, gen, True,
                               model_decays=model)
        wdt = getattr(torch, dtype)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")

        x, bm, cm, dy = randn(b, s, h, p).to(wdt), randn(b, s, g, n).to(wdt), randn(b, s, g, n).to(wdt), \
            randn(b, s, h, p).to(wdt)
        dt = F.softplus(randn(b, s, h))
        A = -torch.linspace(1.0, 16.0, h, device="cuda")
        st0, dsf = (randn(b, h, n, p), randn(b, h, n, p)) if state else (None, None)
        args = (x.transpose(1, 2), dt.transpose(1, 2), A, bm.transpose(1, 2), cm.transpose(1, 2), st0,
                dy.transpose(1, 2), dsf)
        row["graph_ms"] = time_graph_ms(lambda: ssd_scan.ssd_scan_bwd(*args, chunk=chunk), 10)
        row["kernel_us"] = kernel_us(lambda: ssd_scan.ssd_scan_bwd(*args, chunk=chunk), 5)
        out["calls"][key] = row
    return out


def rglru_calls():
    """K3's calls that chip_smoke.py checks: its path's, then its sweep and
    edges; each (b, s, c, h0, model decays)."""
    b, s = cs.WAVE_REQUESTS, cs.RG_PROMPT_LEN
    tb, ts, tc = cs.RGLRU_TRAIN
    calls = [
        (f"recurrentgemma-9b serving ({b},{s},4096) h0 random", (b, s, 4096, "random", True)),
        (f"recurrentgemma-9b forward (1,{s + cs.MAX_NEW - 1},4096) no h0", (1, s + cs.MAX_NEW - 1, 4096, None, True)),
        (f"recurrentgemma-9b serving ({b},{s},4096) h0 zero", (b, s, 4096, "zero", True)),
        (f"recurrentgemma-9b training ({tb},{ts},{tc}) no h0", (tb, ts, tc, None, True)),
    ]
    calls += [(f"sweep ({bb},{ss},{c})", (bb, ss, c, "random", False)) for bb, ss, c in cs.RGLRU_SWEEP + cs.RGLRU_EDGES]
    return calls


def measure_rglru(root: Path, label: str) -> dict:
    """Check and time one checkout's K3 (this process imports its ``src``)."""
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import rglru_scan
    from repro_torch.kernels.ops import rglru_op

    assert Path(rglru_scan.__file__).resolve().is_relative_to(root.resolve()), rglru_scan.__file__
    _build.load("rglru_scan")
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.get("rglru_scan", "").splitlines()
             if any(w in ln.lower() for w in ("registers", "spill", "warning"))]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    out: dict = {"label": label, "root": str(root), "ptxas": ptxas, "calls": {}}
    calls = rglru_calls()
    if label not in ("parent", "change"):  # a variant: the path's random-h0 and forward calls
        calls = calls[:2]
    for key, (b, s, c, h0, model) in calls:
        row = cs.check_rglru(label, ref, b, s, c, gen, h0, model, True)
        x, log_a, h_init = cs.rglru_inputs(b, s, c, gen, h0, model)
        row["graph_ms"] = time_graph_ms(lambda: rglru_op(x, log_a, h_init), 20)
        row["flushed_ms"] = time_flushed_ms(lambda: rglru_op(x, log_a, h_init), 20)
        out["calls"][key] = row
    return out


def rglru_bwd_calls():
    """K3 backward's calls that chip_smoke.py checks: the training path's
    (with no h0 and d(h_last), then with both), then the sweep and the
    edges; each (b, s, c, h0, d(h_last), model decays)."""
    b, s, c = cs.RGLRU_TRAIN
    calls = [(f"recurrentgemma-9b training ({b},{s},{c}) no h0", (b, s, c, None, False, True)),
             (f"recurrentgemma-9b training ({b},{s},{c}) h0 and d(h_last)", (b, s, c, "random", True, True))]
    calls += [(f"sweep ({bb},{ss},{cc})", (bb, ss, cc, "random", True, False)) for bb, ss, cc in cs.RGLRU_SWEEP]
    calls += [(f"edge ({bb},{ss},{cc}) h0 {h}", (bb, ss, cc, "random" if h else None, h, False))
              for bb, ss, cc, h in cs.RGLRU_BWD_EDGES]
    return calls


def measure_rglru_bwd(root: Path, label: str) -> dict:
    """Check and time one checkout's K3 backward (this process imports its ``src``)."""
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import rglru_scan

    assert Path(rglru_scan.__file__).resolve().is_relative_to(root.resolve()), rglru_scan.__file__
    out: dict = {"label": label, "root": str(root), "ptxas": [], "calls": {}}
    calls = rglru_bwd_calls()
    if not hasattr(rglru_scan, "rglru_scan_bwd"):  # a checkout from before the backward kernel
        for key, (b, s, c, h0, dl, _) in calls:
            bound, by = cs.rglru_bwd_bound(b, s, c, h0 is not None, dl)
            out["calls"][key] = {"ms": None, "bound_ms": bound, "bound_by": by}
        return out
    _build.load("rglru_scan")
    _build.load("rglru_scan_bwd")
    out["ptxas"] = [ln.strip() for ln in _build.BUILD_LOG.get("rglru_scan_bwd", "").splitlines()
                    if any(w in ln.lower() for w in ("registers", "spill", "warning"))]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    if label not in ("parent", "change"):  # a variant: the two training calls
        calls = calls[:2]
    for key, (b, s, c, h0, dl, model) in calls:
        row = cs.check_rglru_bwd(label, rglru_scan, ref, b, s, c, gen, h0, dl, model, True)
        row["kernel_el_err"] = max(v for k, v in row.items() if k.startswith("kernel_") and k.endswith("_el_err"))
        x, log_a, h_init = cs.rglru_inputs(b, s, c, gen, h0, model)
        with torch.no_grad():
            h, _ = rglru_scan.rglru_scan(x, log_a, h_init)
        dh = torch.randn((b, s, c), generator=gen, device="cuda")
        dlast = torch.randn((b, c), generator=gen, device="cuda") if dl else None

        def call():
            return rglru_scan.rglru_scan_bwd(x, log_a, h_init, h, dh, dlast)

        first, second = call(), call()
        row["bit_identical"] = all(p is q or torch.equal(p.view(torch.int32), q.view(torch.int32))
                                   for p, q in zip(first, second))
        row["graph_ms"] = time_graph_ms(call, 20)
        row["flushed_ms"] = time_flushed_ms(call, 20)
        out["calls"][key] = row
    return out


def sass_counts(lib: Path) -> dict:
    """Static SASS instructions of each CUDA kernel in a built library
    (``cuobjdump -sass``): ``all``, and ``main``, those up to the last EXIT
    before the first RET (IEEE division and square root branch to slow-path
    subroutines placed past the kernel's body), with ``main``'s opcodes."""
    import re

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib)], check=True, capture_output=True, text=True).stdout
    out, name, body = {}, None, []

    def close():
        if name is None:
            return
        ops = [ln.split()[0] if not ln.startswith("@") else ln.split()[1] for ln in body]
        first_ret = next((i for i, op in enumerate(ops) if op.startswith("RET")), len(ops))
        last_exit = max((i for i, op in enumerate(ops[:first_ret]) if op.startswith("EXIT")), default=len(ops) - 1)
        main = ops[:last_exit + 1]
        hist: dict = {}
        for op in main:
            base = op.split(".")[0]
            hist[base] = hist.get(base, 0) + 1
        out[name] = {"all": len(ops), "main": len(main),
                     "opcodes": dict(sorted(hist.items(), key=lambda kv: -kv[1]))}

    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            close()
            name, body = m.group(1), []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", ln)
        if m and name is not None:
            body.append(m.group(1))
    close()
    return out


def time_optimizer_phase(gen, iters: int = 5) -> dict:
    """Device time of one ``adamw8bit(...).update`` over the 32-layer tree
    (this process's checkout: its clip, and its kernel a leaf), grads with
    a global norm above 1, so the clip scales them."""
    import torch

    from repro_torch.train import adamw8bit

    names, params, grads, _, _ = cs.opt8_tree(gen)
    opt = adamw8bit(1e-3)
    state = opt.init(dict(zip(names, params)))
    pt, gt = dict(zip(names, params)), dict(zip(names, grads))
    ms = cs.time_ms(lambda: opt.update(gt, state, pt), iters)
    del names, params, grads, state, pt, gt
    torch.cuda.empty_cache()
    return {"optimizer_ms": ms}


def measure_adamw8bit(root: Path, label: str) -> dict:
    """Check and time one checkout's 8-bit update over the 32-layer tree,
    count its SASS, and time its optimizer phase (this process imports its
    ``src``)."""
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import adamw8bit as k8

    assert Path(k8.__file__).resolve().is_relative_to(root.resolve()), k8.__file__
    _build.build_all()
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.get("adamw8bit", "").splitlines()
             if any(w in ln.lower() for w in ("registers", "spill", "warning", "function properties"))]
    sass = sass_counts(_build.load("adamw8bit")._name)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 7)
    tree = cs.check_opt8_tree(label, k8, ref, gen)
    row = {key: tree[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
                                       "v_codes_apart_share", "leaves", "params", "bytes")}
    row["matched"] = tree["ok"]
    if label in ("parent", "change"):
        row.update(time_optimizer_phase(gen))
    key = f"yi-6b {cs.FULL_LAYERS}-layer tree, {tree['leaves']} leaves, bf16"
    return {"label": label, "root": str(root), "ptxas": ptxas, "sass": sass, "calls": {key: row}}


def measure(root: Path, label: str, kernel: str) -> dict:
    """Check and time one checkout's K1, K1's backward, K2, K3 or 8-bit update (this process imports its ``src``)."""
    if kernel == "adamw8bit":
        return measure_adamw8bit(root, label)
    if kernel == "ssd":
        return measure_ssd(root, label)
    if kernel == "ssd_bwd":
        return measure_ssd_bwd(root, label)
    if kernel == "attention_bwd":
        return measure_attention_bwd(root, label)
    if kernel == "rglru":
        return measure_rglru(root, label)
    if kernel == "rglru_bwd":
        return measure_rglru_bwd(root, label)
    sys.path.insert(0, str(root / "src"))
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa

    assert Path(fa.__file__).resolve().is_relative_to(root.resolve()), fa.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.get("flash_attention", "").splitlines()
             if any(w in ln.lower() for w in ("registers", "spill", "wgmma", "warning"))]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    out: dict = {"label": label, "root": str(root), "ptxas": ptxas, "calls": {}}
    for key, (b, s, h, kv, d, window) in k1_calls():
        row = cs.check_attention(label, fa, ref, b, s, h, kv, d, "bfloat16", True, window, None, gen, True)
        q = torch.randn((b, h, s, d), generator=gen, device="cuda").bfloat16()
        k = torch.randn((b, kv, s, d), generator=gen, device="cuda").bfloat16()
        v = torch.randn((b, kv, s, d), generator=gen, device="cuda").bfloat16()
        kr, vr = k.repeat_interleave(h // kv, 1), v.repeat_interleave(h // kv, 1)
        row["graph_ms"] = time_graph_ms(lambda: fa.flash_attention(q, k, v, causal=True, window=window), 20)
        if window is None:
            row["library_graph_ms"] = time_graph_ms(
                lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True), 20)
        else:
            pos = torch.arange(s, device="cuda")
            keep = (pos[None, :] > pos[:, None] - window) & (pos[None, :] <= pos[:, None])
            row["library_graph_ms"] = time_graph_ms(
                lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=keep), 20)
        out["calls"][key] = row
    return out


def make_variant(kernel: str, name: str) -> Path:
    """A copy of this checkout's ``src/`` under ``build/ab_variants/<name>``
    with VARIANTS[kernel][name] applied to the kernel's source."""
    root = ROOT / "build" / "ab_variants" / name
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(ROOT / "src", root / "src", ignore=shutil.ignore_patterns("__pycache__"))
    path = root / SOURCES[kernel]
    text = path.read_text()
    for old, new in VARIANTS[kernel][name]:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} occurs {text.count(old)} times in {SOURCES[kernel]}")
        text = text.replace(old, new)
    path.write_text(text)
    return root


def summarise(runs: list, labels: list) -> dict:
    def med(vals):
        vals = [v for v in vals if v is not None]
        return statistics.median(vals) if vals else None

    summary: dict = {}
    for key, row in runs[0]["calls"].items():
        entry = {"bound_ms": row["bound_ms"], "bound_by": row["bound_by"]}
        for label in labels:
            for t in TIMES + ERRORS:
                vals = [r["calls"].get(key, {}).get(t) for r in runs if r["label"] == label]
                entry[f"{label}_{t}"] = vals
                entry[f"{label}_{t}_median"] = med(vals)
            for f in FLAGS:
                entry[f"{label}_{f}"] = [r["calls"][key][f] for r in runs
                                         if r["label"] == label and f in r["calls"].get(key, {})]
            per_kernel = [r["calls"].get(key, {}).get("kernel_us", {}) for r in runs if r["label"] == label]
            entry[f"{label}_kernel_us_median"] = {
                name: med([d.get(name) for d in per_kernel]) for name in sorted({n for d in per_kernel for n in d})
            }
        digests = {label: set(entry[f"{label}_digest"]) for label in labels}
        if digests.get("parent") and digests.get("change"):
            entry["same_bits_as_parent"] = digests["parent"] == digests["change"] and len(digests["change"]) == 1
        for t in ("ms", "graph_ms"):
            lib = entry[f"change_library_{t}_median"]
            for label in labels:
                x = entry[f"{label}_{t}_median"]
                if x is None:
                    continue
                par = entry[f"parent_{t}_median"]
                entry[f"{label}_over_parent_{t}"] = x / par if par else None
                entry[f"{label}_over_library_{t}"] = x / lib if lib else None
                entry[f"bound_over_{label}_{t}"] = row["bound_ms"] / x
        summary[key] = entry
    return summary


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="another checkout, timed against this one")
    ap.add_argument("--kernel", choices=sorted(SOURCES), default="attention")
    ap.add_argument("--ablate", action="store_true", help="also time the kernel without each refinement")
    ap.add_argument("--variants", default="", help="a comma-separated subset of --ablate's variants")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--label", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure is not None:
        print(json.dumps(measure(args.measure, args.label, args.kernel)), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.parent is None or not (args.parent / "src" / "repro_torch").is_dir():
        print("torch_kernel_ab: --parent must be a checkout with src/repro_torch", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    sides = [("change", ROOT)]
    chosen = [v for v in args.variants.split(",") if v] or (list(VARIANTS[args.kernel]) if args.ablate else [])
    unknown = set(chosen) - set(VARIANTS[args.kernel])
    if unknown:
        print(f"torch_kernel_ab: no variants {sorted(unknown)} for {args.kernel}", file=sys.stderr)
        return 2
    sides += [(name, make_variant(args.kernel, name)) for name in chosen]
    order = [("parent", args.parent), *sides, *reversed(sides), ("parent", args.parent)]
    runs = []
    for rnd in range(args.rounds):
        for label, root in order:
            res = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--measure", str(root.resolve()), "--label", label,
                 "--kernel", args.kernel],
                capture_output=True, text=True,
            )
            if res.returncode != 0:
                print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
                raise SystemExit(f"torch_kernel_ab: {label} failed ({res.returncode})")
            row = json.loads(res.stdout.strip().splitlines()[-1])
            row["round"] = rnd
            runs.append(row)
            print(json.dumps(row), flush=True)

    labels = ["parent"] + [label for label, _ in sides]
    summary = {"card": card, "kernel": args.kernel, "rounds": args.rounds, "calls": summarise(runs, labels)}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    name = "kernel_ab.json" if args.kernel == "attention" else f"kernel_ab_{args.kernel}.json"
    (out_dir / name).write_text(json.dumps({"summary": summary, "runs": runs}, indent=1))
    for key, e in summary["calls"].items():
        present = [label for label in labels if e[f"{label}_ms_median"] is not None]
        if args.kernel == "adamw8bit":
            cols = "  ".join(f"{label} {e[f'{label}_ms_median']:.4f} (matched {all(e[f'{label}_matched'])}, "
                             f"max abs err {max(e[f'{label}_max_abs_err']):.3g})" for label in present)
            cols += "  optimizer phase " + " ".join(f"{label} {e[f'{label}_optimizer_ms_median']:.4f}"
                                                   for label in present if e[f"{label}_optimizer_ms_median"])
            print(f"[{card}] {key}: ms {cols}  bound {e['bound_ms']:.4f}", flush=True)
            continue
        cols = "  ".join(f"{label} {e[f'{label}_ms_median']:.4f} ({e[f'{label}_graph_ms_median']:.4f})"
                         for label in present)
        if args.kernel == "attention":
            cols += f"  SDPA {e['change_library_ms_median']:.4f} ({e['change_library_graph_ms_median']:.4f})"
        elif args.kernel == "attention_bwd":
            lib = e["change_library_ms_median"]
            cols += f"  library {lib:.4f}" if lib is not None else "  library refused"
            cols += "  kernel us " + " ".join(
                f"{label} " + "/".join(f"{n} {v:.1f}" for n, v in e[f"{label}_kernel_us_median"].items())
                for label in present)
            cols += "  bit-identical " + " ".join(f"{label} {all(e[f'{label}_bit_identical'])}" for label in present)
            if "same_bits_as_parent" in e:
                cols += f"  parent's bits {e['same_bits_as_parent']}"
        elif args.kernel == "ssd_bwd":
            cols += "  kernel us " + " ".join(
                f"{label} " + "/".join(f"{n} {v:.1f}" for n, v in e[f"{label}_kernel_us_median"].items())
                for label in present)
            cols += "  bit-identical " + " ".join(f"{label} {all(e[f'{label}_bit_identical'])}" for label in present)
        elif args.kernel in ("rglru", "rglru_bwd"):
            err = "kernel_vs_f64_el_err" if args.kernel == "rglru" else "kernel_el_err"
            cols += "  flushed " + " ".join(f"{label} {e[f'{label}_flushed_ms_median']:.4f}" for label in present)
            cols += "  el_err " + " ".join(f"{label} {e[f'{label}_{err}_median']:.3g}" for label in present)
            if args.kernel == "rglru_bwd":
                cols += "  bit-identical " + " ".join(f"{label} {all(e[f'{label}_bit_identical'])}"
                                                      for label in present)
        else:
            cols += "  el_err_state " + " ".join(f"{label} {e[f'{label}_el_err_state_median']:.3g}" for label in present)
            cols += "  kernel us " + " ".join(
                f"{label} " + "/".join(f"{v:.1f}" for v in e[f"{label}_kernel_us_median"].values()) for label in present)
        print(f"[{card}] {key}: ms (graph ms) {cols}  bound {e['bound_ms']:.4f}", flush=True)
    print(json.dumps(summary), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
