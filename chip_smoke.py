#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py            # from the repository root

Phases: (1) the card's name and power limit; (2) build every CUDA kernel
of the port from ``src/repro_torch/kernels/csrc`` with nvcc; (3) hold
each kernel against its plain PyTorch version on the card, at its paths'
shapes and a sweep of modes, and time kernel, plain version and (where
one exists) one library call: K1 (flash attention, head dims 64, 128 and
256), K1's backward (dq, dk, dv against autograd through the plain
version; head dims 64 and 128) and its forward's row log-sum-exp, then
K2 (SSD scan), then K3 (RG-LRU scan); (4) train full-width yi-6b (16 of
its 32 layers, d 4096, bf16 weights from a seed) from a stream:
a seeded Markov corpus ingested into a 4-partition topic and announced
on the control topic, ``TrainingJob(streaming=True)`` with AdamW for 8
steps of 4 x 1024 tokens and its streaming eval, checking finite,
falling losses and K1's launches forward and backward; then the
gradients of one full-width attention layer at the training shape,
through K1 forward + backward against the plain version; (5) serve four
requests of mixed prompt lengths from a stream topic
through full-width yi-6b (32 layers, random bf16 weights from a
seed) with ``ContinuousLMEngine`` and check what comes back; (6) serve
eight requests through the same model behind ``LMServingGroup`` (two
transactional workers on a three-broker cluster, request and response
topics of two partitions at replication factor 3, the response leader
killed after the first four) and check that each comes back exactly once
and greedy; (7) drop yi-6b and serve a topic of four 2000-token prompts
through full-width mamba2-2.7b (64 layers, d 2560, random bf16 weights
from a seed) with the wave engine ``LMEngine`` and check what comes
back, then serve it again
with the same weights and f32 activations, where every token is held to
the teacher-forced forward at the tight slack; (8) drop mamba2 and serve
a topic of four 3000-token prompts through full-width recurrentgemma-9b
(38 layers, d 4096: 26 RG-LRU layers on K3, 12 local-attention layers of
window 2048 on K1 at head dim 256; random bf16 weights from a seed) with
``LMEngine`` and check what comes back (its bf16 drift stays within the
tight slack, so every token is held there and no f32 twin is needed);
(9) print the ``kernels`` line (K1's times summed over its paths, and
each path's own under ``by_path``; K1's backward as its own entry);
(10) print the result line. Each path is driven with every kernel's
launch count set to 0 just before it and read just after.

It imports nothing of JAX or of the JAX package. With no CUDA device, or
run from a directory without the repository, it exits non-zero and
prints no result. Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
PROMPT_LENS = (512, 1000, 1536, 2000)  # the served requests' prompt lengths
MAX_NEW = 16
BLOCK = 16
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; f32 CUDA cores
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py
# K2: error relative to max(|want|.max(), 1), tests/test_kernels.py:66-74
SSD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
GREEDY_SLACK = 0.25  # logits: a served token may trail the forward's max by this much
# mamba2 with bf16 activations: decode (one-token recurrence) and the
# teacher-forced forward (chunked scan) round differently, and the random
# 64-layer stack amplifies that noise as decoding goes on (PERF.md, Findings;
# scripts/torch_ssm_drift.py measures it, worst decoded gap about 1); a
# lost, stale or misplaced decode state gives gaps above 4 there, so the
# slack sits about halfway between on a ratio scale
SSM_BF16_DRIFT_SLACK = 2.0
# yi-6b behind the serving group: two transactional workers on a request
# topic of two partitions (replication factor 3 on 3 brokers), PROMPT_LENS
# twice; the phase fails if the read_committed view lacks a request this
# long after the response leader's kill (the reference's chaos test allows
# 60 s for the reduced model)
GROUP_WORKERS = 2
GROUP_PARTITIONS = 2
GROUP_DEADLINE_S = 300.0
SSM_PROMPT_LEN = 2000  # mamba2 path: one wave of 4 fixed-length prompts
WAVE_REQUESTS = 4  # the wave paths' slots and requests
# recurrentgemma path: past the 2048 window, so the prefill's window mask,
# the rolled ring fill and the ring's wrap on decode all run; 3000 = 46 x
# 64 + 56 = 11 x 256 + 184 is ragged for K1's tiles and any time block
RG_PROMPT_LEN = 3000
# recurrentgemma with bf16 activations needs no more than GREEDY_SLACK:
# its served tokens trail the teacher-forced forward by one or two bf16
# steps of the logits (0.0625 and 0.125 on two prompt sets), and with f32
# activations by 0; faults planted in the decode cache give 0.625 (the
# window applied to ring slots) to 14.9 (the RG-LRU state zeroed), while
# zeroing the conv state (0.25) or writing the ring one slot off (0.0625)
# hides within bf16 rounding (scripts/torch_ssm_drift.py --model
# recurrentgemma and this script on an H100 80GB HBM3 at 700 W; PERF.md,
# Findings)
# K3 is held to a float64 run of its plain version: the f32 plain
# version's 1 - a * a cancels when a is near 1 and alone strays past 1e-5
# (PERF.md, Findings). At tests/test_kernels.py's shapes and decays the
# tolerance is that file's, |got - want| <= tol + tol |want| with tol
# 1e-5; at the path's shape, with the model's decays (a up to ~0.9995)
# over 3000 steps, 1e-4 (a lost carry or a wrong decay gives errors of
# the order of rms(h))
RGLRU_TOL = 1e-5
RGLRU_F64_TOL = 1e-4
# K3's checks beside its path's own calls, (b, s, c), with a random h0 and
# the tests' decays: tests/test_kernels.py:77-87's shapes, then ragged S
RGLRU_SWEEP = ((1, 128, 64), (2, 256, 128), (3, 64, 256), (2, 1000, 96), (1, 1000, 512))
# ... and at the edges of the kernel's tiles (csrc/rglru_scan.cu: 32
# channels a block, 16 steps a warp, time blocks of 256): S = 1, one
# warp's steps + 1, T - 1, T, T + 1 and a ragged S past 3 T; C below,
# above and off the channel tile; B 1 and 3
RGLRU_EDGES = ((1, 1, 64), (1, 17, 33), (3, 255, 100), (1, 256, 96), (3, 257, 40), (1, 845, 4096))
# K2's checks beside its path's own calls, (b, s, h, p, n, g, chunk), each
# in f32 and bf16 with a random initial state that the tests' slow decays
# carry a long way: tests/test_kernels.py:49-53's shapes (G = 1, 2 and H)
# and a ragged S
SSD_SWEEP = ((1, 128, 2, 32, 64, 1, 32), (2, 256, 4, 64, 128, 2, 64), (1, 64, 4, 16, 32, 4, 64),
             (2, 1000, 8, 64, 128, 1, 256))


# K1's backward against autograd through the plain version: the error of
# dq, dk and dv relative to each one's largest element. f32: the forward's
# 2e-5 (its FMAs in another order; measured 3e-6 at the training shape);
# bf16: the forward's 2e-2 (P and dS enter their products rounded to bf16)
BWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOG2E = 1.4426950408889634
LSE_TOL = 1e-4  # the base-2 log-sum-exp, absolute (values near log2(S) + a few)
# the training path: full-width yi-6b cut to 16 of its 32 layers (bf16
# params and grads and f32 AdamW moments are 12 bytes a parameter: 72.7 GB
# at 32 layers, 39.5 GB at 16), a seeded Markov corpus
# (examples/torch_train_lm.py) of 64 sequences of 1024 tokens, 8 steps of
# batch 4, streaming eval over the held-out eighth
TRAIN_LAYERS = 16
TRAIN_SEQS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_WARMUP = 64, 1024, 4, 8, 2
TRAIN_VAL_RATE = 0.125
TRAIN_ATTN = (TRAIN_BATCH, TRAIN_SEQ, 32, 4, 128)  # (B, S, H, Kv, D) of its attention calls
# the first loss: ln(64000) = 11.07 plus half the variance of random
# logits (unembed 1/sqrt(d) on a unit-RMS hidden state: about 0.5)
TRAIN_LOSS0_BAND = (10.5, 12.5)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def reset_counts(kernels: dict) -> None:
    """Every kernel's launch count to 0 (K1's backward included)."""
    for mod in kernels.values():
        mod.LAUNCHES = 0
    kernels["flash_attention"].BWD_LAUNCHES = 0


def read_counts(kernels: dict) -> dict:
    out = {name: mod.LAUNCHES for name, mod in kernels.items()}
    out["flash_attention_bwd"] = kernels["flash_attention"].BWD_LAUNCHES
    return out


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def mask_pairs(s: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the mask lets through: the work this input needs."""
    import numpy as np

    q = np.arange(s)
    hi = q if causal else np.full(s, s - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(s, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_bound(b, h, kv, s, d, dtype: str, causal, window) -> tuple[float, str]:
    """Least time for the function: max(bytes / HBM rate, flops / peak)."""
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = elem * b * s * d * (2 * h + 2 * kv)  # q, k, v read once; o written once
    flops = 4 * d * h * b * mask_pairs(s, causal, window)  # QK^T and PV
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_attention(card, fa, ref, b, s, h, kv, d, dtype, causal, window, cap, gen, timed):
    """Kernel vs plain version on one input; with ``timed`` also times both
    and the library call. Raises if they disagree."""
    import torch
    import torch.nn.functional as F

    dt = getattr(torch, dtype)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(dt)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rep = h // kv
    kr, vr = kt.repeat_interleave(rep, dim=1), vt.repeat_interleave(rep, dim=1)

    def kernel():
        return fa.flash_attention(qt, kt, vt, causal=causal, window=window, softcap=cap)

    def plain():
        return ref.mha(qt, kr, vr, causal=causal, window=window, softcap=cap)

    got, want = kernel().float(), plain().float()
    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = TOL[dtype]
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol + tol * want.abs()).all())
    row = {
        "b": b, "s": s, "h": h, "kv": kv, "d": d, "dtype": dtype, "causal": causal,
        "window": window, "softcap": cap, "max_abs_err": float(err.max()), "tol": tol, "ok": ok,
    }
    if timed:
        row["ms"] = time_ms(kernel, 20)
        row["plain_ms"] = time_ms(plain, 5)
        row["library_ms"] = None
        if window is None and cap is None:
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(qt, kr, vr, is_causal=causal), 20
            )
        elif cap is None:  # a boolean mask: not the flash backend, which takes no mask
            pos = torch.arange(s, device="cuda")
            keep = (pos[None, :] > pos[:, None] - window) & (pos[None, :] <= pos[:, None] if causal else True)
            row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=keep), 20)
        row["bound_ms"], row["bound_by"] = attention_bound(b, h, kv, s, d, dtype, causal, window)
    print(f"[{card}] flash_attention {json.dumps(row)}", flush=True)
    if not ok:
        raise AssertionError(f"flash_attention disagrees with its plain version: {row}")
    return row


def phase_kernels(card, fa, ref):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    # yi-6b's attention (32 heads over 4 kv heads, hd 128); 1000 is ragged
    for s in (512, 1000, 2048):
        for dtype in ("float32", "bfloat16"):
            rows.append(check_attention(card, fa, ref, 1, s, 32, 4, 128, dtype, True, None, None, gen, False))
    for causal, window, cap in ((False, None, None), (True, 128, None), (True, None, 50.0)):
        for dtype in ("float32", "bfloat16"):
            rows.append(check_attention(card, fa, ref, 1, 1000, 32, 4, 128, dtype, causal, window, cap, gen, False))
    for causal, window in ((True, None), (False, 128)):  # head_dim 64, batch 2, ragged
        for dtype in ("float32", "bfloat16"):
            rows.append(check_attention(card, fa, ref, 2, 777, 8, 2, 64, dtype, causal, window, None, gen, False))
    # recurrentgemma's local attention: 16 heads over 1 kv head, hd 256,
    # window 128 and its own 2048 (whose skipped key tiles matter past S
    # 2048), ragged S; and the f32-activation run's call at the path's shape
    for s, window in ((1000, 128), (2500, 2048)):
        for dtype in ("float32", "bfloat16"):
            rows.append(check_attention(card, fa, ref, 1, s, 16, 1, 256, dtype, True, window, None, gen, False))
    rows.append(check_attention(card, fa, ref, WAVE_REQUESTS, RG_PROMPT_LEN, 16, 1, 256, "float32", True, 2048,
                                None, gen, False))
    # the serving paths' own calls: yi-6b's one per layer per request, bf16,
    # causal; recurrentgemma's one per local layer for the wave, bf16, window 2048
    main = [
        check_attention(card, fa, ref, 1, s, 32, 4, 128, "bfloat16", True, None, None, gen, True)
        for s in PROMPT_LENS
    ]
    rg_main = check_attention(card, fa, ref, WAVE_REQUESTS, RG_PROMPT_LEN, 16, 1, 256, "bfloat16", True, 2048,
                              None, gen, True)
    return rows, main, rg_main


def attention_bwd_bound(b, h, kv, s, d, dtype: str, causal, window) -> tuple[float, str]:
    """Least time for K1's backward: max(bytes / HBM rate, operations /
    peak). Operations: five products of 2 D a (query, key) pair and head
    (S and dP again, dV, dQ, dK), 10 D H an unmasked pair. Bytes: q, k, v,
    o, do and lse read once, dq, dk and dv written once."""
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = elem * b * s * d * (3 * h + 2 * kv) + elem * b * s * d * (h + 2 * kv) + 4 * b * h * s
    flops = 10 * d * h * b * mask_pairs(s, causal, window)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_attention_bwd(card, fa, ref, b, s, h, kv, d, dtype, causal, window, gen, timed):
    """K1's backward kernel against autograd through the plain version on
    one input: dq, dk, dv (dk, dv summed over each kv group), each held to
    its largest element (BWD_TOL). With ``timed`` also times the kernel,
    the plain backward (autograd of ``ref.mha``, its graph built once) and
    SDPA's backward on pre-repeated K/V as a yardstick. Raises if they
    disagree."""
    import torch
    import torch.nn.functional as F

    dt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    q, k, v, do = randn(b, s, h, d), randn(b, s, kv, d), randn(b, s, kv, d), randn(b, s, h, d)
    qt, kt, vt, dot = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), do.transpose(1, 2)
    rep = h // kv
    out, lse = fa.flash_attention(qt, kt, vt, causal=causal, window=window, return_lse=True)

    def kernel():
        return fa.flash_attention_bwd(qt, kt, vt, out, dot, lse, causal=causal, window=window)

    leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
    plain_out = ref.mha(leaves[0], leaves[1].repeat_interleave(rep, 1), leaves[2].repeat_interleave(rep, 1),
                        causal=causal, window=window)

    def plain():
        return torch.autograd.grad(plain_out, leaves, dot, retain_graph=True)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    tol = BWD_TOL[dtype]
    rel = [float((g.float() - w.float()).abs().max() / w.float().abs().max()) for g, w in zip(got, want)]
    ok = all(bool(torch.isfinite(g).all()) for g in got) and max(rel) <= tol
    row = {
        "b": b, "s": s, "h": h, "kv": kv, "d": d, "dtype": dtype, "causal": causal, "window": window,
        "rel_err_dq_dk_dv": rel, "max_abs_err": max(float((g.float() - w.float()).abs().max())
                                                    for g, w in zip(got, want)),
        "tol": tol, "ok": ok,
    }
    if timed:
        row["ms"] = time_ms(kernel, 20)
        row["plain_ms"] = time_ms(plain, 3)
        row["library_ms"] = None
        if window is None:
            sq, sk, sv = (t.detach().requires_grad_(True)
                          for t in (qt, kt.repeat_interleave(rep, 1), vt.repeat_interleave(rep, 1)))
            s_out = F.scaled_dot_product_attention(sq, sk, sv, is_causal=causal)
            row["library_ms"] = time_ms(lambda: torch.autograd.grad(s_out, (sq, sk, sv), dot, retain_graph=True), 20)
        row["bound_ms"], row["bound_by"] = attention_bwd_bound(b, h, kv, s, d, dtype, causal, window)
    print(f"[{card}] flash_attention_bwd {json.dumps(row)}", flush=True)
    if not ok:
        raise AssertionError(f"flash_attention_bwd disagrees with its plain version: {row}")
    return row


def phase_kernels_bwd(card, fa, ref):
    """K1's backward and its forward's row log-sum-exp, beside the serving
    checks: the training shape in f32 and bf16, head dim 64, a ragged S,
    windows with and without the causal mask, GQA 1 / 2 / 8; the lse
    against torch.logsumexp of the plain scores; the forward's output with
    and without lse, to the bit. Then the training path's own forward and
    backward calls, timed."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    b, s, h, kv, d = TRAIN_ATTN
    rows = [check_attention_bwd(card, fa, ref, b, s, h, kv, d, "float32", True, None, gen, False)]
    for bb, ss, hh, kk, dd, causal, window in ((2, 777, 8, 2, 64, True, None), (1, 1000, 32, 4, 128, True, 128),
                                              (1, 300, 4, 4, 64, False, 50), (2, 513, 8, 1, 128, True, None)):
        for dtype in ("float32", "bfloat16"):
            rows.append(check_attention_bwd(card, fa, ref, bb, ss, hh, kk, dd, dtype, causal, window, gen, False))
    lse_rows = []
    for bb, ss, hh, kk, dd, dtype, window in ((b, s, h, kv, d, "bfloat16", None), (2, 777, 8, 2, 64, "float32", 100)):
        q, k, v = (torch.randn((bb, ss, n, dd), generator=gen, device="cuda").to(getattr(torch, dtype)).transpose(1, 2)
                   for n in (hh, kk, kk))
        out, lse = fa.flash_attention(q, k, v, causal=True, window=window, return_lse=True)
        same = torch.equal(out, fa.flash_attention(q, k, v, causal=True, window=window))
        sc = ref.scores(q, k.repeat_interleave(hh // kk, 1), causal=True, window=window)
        lse_err = float((lse - torch.logsumexp(sc, -1) * LOG2E).abs().max())
        lse_rows.append({"shape": [bb, ss, hh, kk, dd], "dtype": dtype, "window": window, "bit_identical": same,
                         "lse_max_abs_err": lse_err, "tol": LSE_TOL})
        print(f"[{card}] flash_attention lse {json.dumps(lse_rows[-1])}", flush=True)
        if not same or not lse_err <= LSE_TOL:
            raise AssertionError(f"K1's lse output is off: {lse_rows[-1]}")
    fwd_main = check_attention(card, fa, ref, b, s, h, kv, d, "bfloat16", True, None, None, gen, True)
    bwd_main = check_attention_bwd(card, fa, ref, b, s, h, kv, d, "bfloat16", True, None, gen, True)
    return rows, lse_rows, fwd_main, bwd_main


def load_example(name: str):
    """A module of examples/ (no package) by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_train(card, kernels: dict):
    """Train full-width yi-6b (TRAIN_LAYERS of its layers, bf16) from a
    stream: a seeded Markov corpus of TRAIN_SEQS x TRAIN_SEQ tokens
    ingested as RAW records into a 4-partition topic (validation_rate
    TRAIN_VAL_RATE) and announced for a registered model, configuration
    and deployment; ``TrainingJob(streaming=True)`` with AdamW on a
    warm-up + cosine schedule takes TRAIN_STEPS steps of TRAIN_BATCH and
    runs its streaming eval. Checks finite, falling losses, the first near
    ln(vocab), K1's launches forward and backward, and the registry's
    result. Returns the phase's numbers and the trained first layer's
    attention weights."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core import LogConfig, Registry, StreamLog
    from repro_torch.data import ingest
    from repro_torch.data.formats import RawCodec
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy
    from repro_torch.train import TrainingJob, adamw, cosine_schedule

    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get("yi-6b"), n_layers=TRAIN_LAYERS)
    model = StreamModel(cfg, Policy(), device="cuda", generator=None)
    log, reg = StreamLog(), Registry()
    spec = reg.register_model("yi-6b-train")
    dep = reg.deploy(reg.create_configuration([spec.model_id]).config_id, "train")
    corpus = load_example("torch_train_lm").synth_corpus(TRAIN_SEQS, cfg.vocab, seq=TRAIN_SEQ, seed=SEED)
    log.create_topic("corpus", LogConfig(num_partitions=4))
    msg = ingest(log, "corpus", RawCodec("int32", (TRAIN_SEQ,), "int32", ()),
                 {"data": corpus, "label": np.zeros(TRAIN_SEQS, np.int32)}, dep.deployment_id,
                 validation_rate=TRAIN_VAL_RATE)
    losses, stamps, eval_calls = [], [], [0]

    def loss_fn(p, batch):
        loss, metrics = model.loss(p, {"tokens": batch["data"]})
        if torch.is_grad_enabled():
            losses.append(metrics["loss"].detach())
            stamps.append(time.perf_counter())  # the step's start: the job syncs on each step's loss
        else:
            eval_calls[0] += 1
        return loss, metrics

    job = TrainingJob(log, reg, dep.deployment_id, spec.model_id, loss_fn=loss_fn, init_fn=model.init,
                      opt=adamw(cosine_schedule(3e-4, TRAIN_WARMUP, TRAIN_STEPS)), seed=SEED, device="cuda")
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    t_start = time.perf_counter()
    res = job.run(batch_size=TRAIN_BATCH, max_steps=TRAIN_STEPS, streaming=True)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()

    losses = [float(x) for x in losses]
    n_params = sum(p.numel() for p in model.parameters())
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]  # steps 1 .. n-1; step 0 builds
    steady = sorted(step_ms[1:]) if len(step_ms) > 1 else step_ms
    med_ms = steady[len(steady) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_eval = int(round(TRAIN_SEQS * TRAIN_VAL_RATE)) // min(TRAIN_BATCH, int(round(TRAIN_SEQS * TRAIN_VAL_RATE)))
    want = {
        "flash_attention": cfg.n_layers * (TRAIN_STEPS + n_eval),
        "flash_attention_bwd": cfg.n_layers * TRAIN_STEPS,
        "ssd_scan": 0, "rglru_scan": 0,
    }
    out = {
        "layers": cfg.n_layers, "params": n_params, "steps": res.steps, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "losses": losses, "eval_loss": res.eval_metrics.get("loss"), "eval_batches": eval_calls[0],
        "step_ms": step_ms, "median_step_ms": med_ms, "tokens_per_s": tokens / (med_ms / 1e3),
        "run_s": t_end - t_start, "setup_s": setup_s, "peak_bytes": peak, "launches": counts,
        "want_launches": want, "records": msg.total_msg, "loss_band": list(TRAIN_LOSS0_BAND),
    }
    print(f"[{card}] yi-6b training: {cfg.n_layers} of 32 layers, {n_params} params bf16, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, {res.steps} steps in {t_end - t_start:.3f} s", flush=True)
    print(f"[{card}] losses {['%.4f' % x for x in losses]}, eval {out['eval_loss']}", flush=True)
    print(f"[{card}] step ms {['%.1f' % x for x in step_ms]}, median {med_ms:.3f} ms, "
          f"{out['tokens_per_s']:.1f} tokens/s", flush=True)
    print(f"[{card}] peak device memory {peak} bytes; launches {json.dumps(counts)}", flush=True)
    assert len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), losses
    assert TRAIN_LOSS0_BAND[0] <= losses[0] <= TRAIN_LOSS0_BAND[1], (losses[0], TRAIN_LOSS0_BAND)
    assert losses[-1] < losses[0], f"the loss did not fall: {losses}"
    assert np.isfinite(out["eval_loss"]) and eval_calls[0] == n_eval, (out["eval_loss"], eval_calls[0])
    assert counts == want, f"launches {counts}, want {want}"
    results = reg.results_for(dep.deployment_id)
    assert len(results) == 1 and results[0].metrics["loss"] == res.metrics["loss"], results
    layer0 = {k: v[0].detach().clone() for k, v in model.tree["slots"]["s0"]["mixer"].items()}
    del job, res, model
    return out, layer0


def phase_train_grads(card, ref, mixer: dict):
    """The trained model's first attention layer (``mixer``: its wq, wk,
    wv, wo) at the training shape: the gradients of a fixed random
    projection of its output with respect to a random x and the four
    weights, through K1 forward + backward, against the same computation
    through the plain version on the card; each leaf's error relative to
    its largest element, within K1's bf16 tolerance."""
    import math

    import torch

    from repro_torch import configs
    from repro_torch.kernels.ops import attention_op
    from repro_torch.models import layers as L

    cfg = configs.get("yi-6b")
    ap = cfg.attn_params("attn")
    b, s, h, kv, hd = TRAIN_ATTN
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    d = cfg.d_model
    leaves = {"x": randn(b, s, d), **{k: mixer[k] for k in ("wq", "wk", "wv", "wo")}}
    proj = randn(b, s, d)
    positions = torch.arange(s, device="cuda")

    def grads(kernel: bool):
        t = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
        q, k, v = L._project_qkv(t, t["x"], ap, positions)
        if kernel:
            out = attention_op(q, k, v, causal=True)
        else:
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            out = ref.mha(qt, kt.repeat_interleave(h // kv, 1), vt.repeat_interleave(h // kv, 1)).transpose(1, 2)
        y = L._out_proj(out, t["wo"])
        g = torch.autograd.grad((y.float() * proj.float()).sum(), list(t.values()))
        return dict(zip(t, g))

    got, want = grads(True), grads(False)
    torch.cuda.synchronize()
    rel = {k: float((got[k].float() - want[k].float()).abs().max() / want[k].float().abs().max()) for k in got}
    row = {"shape": list(TRAIN_ATTN), "rel_err": rel, "tol": BWD_TOL["bfloat16"]}
    print(f"[{card}] yi-6b attention layer gradients, kernel vs plain {json.dumps(row)}", flush=True)
    assert all(math.isfinite(e) and e <= BWD_TOL["bfloat16"] for e in rel.values()), row
    return row


def ssd_bound(b, h, g, s, p, n, chunk, dtype: str, state: bool) -> tuple[float, str]:
    """Least time for the SSD scan: max(bytes / HBM rate, flops / peak).

    Bytes: x read and y written once (B S H P each, in the working
    dtype), B and C read once per group (B S G N each), dt read once
    (B S H f32), the initial state read (when given) and the final state
    written (B H N P f32 each). Flops per (batch, head): each causal pair
    (i, j) within a chunk costs 2N (C_i . B_j) + 2P (its share of y), and
    each chunk of length L costs 4 L N P (the carried state's share of y
    and the state update); the last chunk is ragged when chunk does not
    divide S. The rate is the card's peak for the working dtype."""
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = elem * b * s * (2 * h * p + 2 * g * n) + 4 * b * s * h
    nbytes += 4 * b * h * n * p * (2 if state else 1)
    q = min(chunk, s)
    lens = [min(q, s - c0) for c0 in range(0, s, q)]
    per_head = sum(ln * (ln + 1) // 2 * (2 * n + 2 * p) + 4 * ln * n * p for ln in lens)
    flops = b * h * per_head
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_ssd(card, ref, b, s, h, p, n, g, chunk, dtype, state, gen, timed, model_decays=False):
    """K2 vs its plain version on one input (model layout, grouped B/C);
    with ``timed`` also times both. Raises if they disagree.

    ``state`` is None (no initial state), "zero" (a zero f32 state, as the
    serving path's cache hands it) or "random". Both y and the final state
    are held to two criteria: the tests' error relative to
    max(|want|.max(), 1) below SSD_TOL, and, element by element,
    |got - want| <= SSD_TOL * (rms(want) + |want|), so that an error as
    large as a typical output fails wherever it lands. In bf16, dt is drawn
    on the bf16 grid: there the plain version's x * dt (dt rounded first,
    ``ref.py:62``) and the kernel's (the f32 product rounded once,
    ``ssd_scan.py:117``) are the same number, and what is left to differ is
    the kernel's own arithmetic and the rounding of y. Off the grid the two
    orders alone differ by about the tolerance."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ops import ssd_op

    wdt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x, bm, cm = randn(b, s, h, p).to(wdt), randn(b, s, g, n).to(wdt), randn(b, s, g, n).to(wdt)
    dt = F.softplus(randn(b, s, h)).to(wdt).float()
    # the model's decays (A_log = log(linspace(1, 16, H))), else the tests' draw
    A = -torch.linspace(1.0, 16.0, h, device="cuda") if model_decays else -torch.exp(randn(h))
    st0 = None
    if state == "zero":
        st0 = torch.zeros((b, h, n, p), device="cuda")
    elif state == "random":
        st0 = randn(b, h, n, p)
    rep = h // g
    br = bm.transpose(1, 2).repeat_interleave(rep, 1)
    cr = cm.transpose(1, 2).repeat_interleave(rep, 1)

    def kernel():
        return ssd_op(x, dt, A, bm, cm, st0, chunk=chunk)

    def plain():
        return ref.ssd(x.transpose(1, 2), dt.transpose(1, 2), A, br, cr, st0)

    y, st = kernel()
    yr, sr = plain()
    torch.cuda.synchronize()
    tol = SSD_TOL[dtype]
    row = {
        "b": b, "s": s, "h": h, "p": p, "n": n, "g": g, "chunk": chunk, "dtype": dtype,
        "init_state": state, "model_decays": model_decays, "tol": tol,
    }
    ok, errs = True, []
    for name, got, want in (("y", y.float(), yr.transpose(1, 2).float()), ("state", st, sr)):
        err = (got - want).abs()
        scale = float(want.square().mean().sqrt())
        errs.append(float(err.max()))
        row[f"rel_err_{name}"] = float(err.max()) / max(float(want.abs().max()), 1.0)
        row[f"scale_{name}"] = scale
        row[f"el_err_{name}"] = float((err / (scale + want.abs())).max())
        ok = ok and bool(torch.isfinite(got).all())
        ok = ok and row[f"rel_err_{name}"] < tol and row[f"el_err_{name}"] <= tol
    row["max_abs_err"], row["ok"] = max(errs), ok
    if timed:
        row["ms"] = time_ms(kernel, 20)
        row["plain_ms"] = time_ms(plain, 2)
        row["library_ms"] = None  # no single PyTorch call computes the SSD scan
        row["bound_ms"], row["bound_by"] = ssd_bound(b, h, g, s, p, n, chunk, dtype, st0 is not None)
    print(f"[{card}] ssd_scan {json.dumps(row)}", flush=True)
    if not ok:
        raise AssertionError(f"ssd_scan disagrees with its plain version: {row}")
    return row


def phase_ssd_kernel(card, ref):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    for b, s, h, p, n, g, chunk in SSD_SWEEP:
        for dtype in ("float32", "bfloat16"):
            rows.append(check_ssd(card, ref, b, s, h, p, n, g, chunk, dtype, "random", gen, False))
    # the teacher-forced forward's own shape
    rows.append(check_ssd(card, ref, 1, SSM_PROMPT_LEN + 15, 80, 64, 128, 1, 256, "bfloat16",
                          None, gen, False, model_decays=True))
    # the serving path's calls: one per layer, the wave's 4 prompts, the
    # model's decays, the zero initial state from the cache; in f32 as the
    # f32-activation run gives it, and in bf16, timed
    rows.append(check_ssd(card, ref, WAVE_REQUESTS, SSM_PROMPT_LEN, 80, 64, 128, 1, 256, "float32",
                          "zero", gen, False, model_decays=True))
    main = check_ssd(card, ref, WAVE_REQUESTS, SSM_PROMPT_LEN, 80, 64, 128, 1, 256, "bfloat16",
                     "zero", gen, True, model_decays=True)
    return rows, main


def serving_setup():
    """The served workload: full-width yi-6b with random bf16 weights from
    SEED behind a ContinuousLMEngine (4 slots, blocks of BLOCK), warmed up
    by one short request, and a request topic holding one request per
    PROMPT_LENS entry. Returns (cfg, model, engine, log, requests)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core.log import StreamLog
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy
    from repro_torch.serve.lm_engine import ContinuousLMEngine, Request, encode_request, tenant_key

    cfg = configs.get("yi-6b")
    model = StreamModel(cfg, Policy(), device="cuda", generator=SEED)
    max_blocks = -(-(max(PROMPT_LENS) + MAX_NEW - 1) // BLOCK)
    engine = ContinuousLMEngine(
        model, n_slots=4, n_blocks=4 * max_blocks + 1, block_size=BLOCK,
        max_blocks=max_blocks, device="cuda",
    )
    rng = np.random.default_rng(SEED)
    # warm-up request outside the measured run (library handles, allocator)
    engine.submit(Request(-1, rng.integers(0, cfg.vocab, 64).astype(np.int32), 2))
    engine.run_until_drained()
    engine.first_token_s.clear()

    log = StreamLog()
    log.create_topic("lm-requests")
    reqs = [
        Request(i, rng.integers(0, cfg.vocab, n).astype(np.int32), MAX_NEW, tenant=i % 2)
        for i, n in enumerate(PROMPT_LENS)
    ]
    for r in reqs:
        log.produce("lm-requests", encode_request(r), key=tenant_key(r.tenant))
    return cfg, model, engine, log, reqs


def phase_serve(card, kernels: dict):
    import torch

    from repro_torch.serve.lm_engine import decode_completion, serve_stream

    t0 = time.perf_counter()
    cfg, model, engine, log, reqs = serving_setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[{card}] yi-6b full width: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{n_params} params bf16, set-up and warm-up {setup_s:.3f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()

    reset_counts(kernels)
    t_start = time.perf_counter()
    served = serve_stream(engine, log, "lm-requests", "lm-completions")
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = kernels["flash_attention"].LAUNCHES
    others = {name: n for name, n in read_counts(kernels).items() if name != "flash_attention"}
    assert not any(others.values()), others

    peak = torch.cuda.max_memory_allocated()
    got = {}
    batch = log.read("lm-completions", 0, 0, 64)
    for buf in batch.values:
        rid, tenant, gen = decode_completion(buf)
        assert tenant == rid % 2, (rid, tenant)
        got[rid] = gen
    assert served == len(reqs) and sorted(got) == [r.req_id for r in reqs], (served, sorted(got))
    for r in reqs:
        g = got[r.req_id]
        assert len(g) == MAX_NEW and ((g >= 0) & (g < cfg.vocab_padded)).all(), (r.req_id, g)
    want_launches = cfg.n_layers * len(reqs)
    assert launches == want_launches, f"flash_attention launched {launches}, want {want_launches}"

    # each served token must be a greedy choice of the teacher-forced
    # forward, up to bf16 near-ties
    worst = greedy_worst_gap(model, reqs, got)
    assert worst <= GREEDY_SLACK, f"served tokens trail the forward's greedy choice by {worst}"

    firsts = [engine.first_token_s[r.req_id] for r in reqs]
    ttft = [(t - t_start) * 1e3 for t in firsts]
    prefill = [(b - a) * 1e3 for a, b in zip([t_start] + firsts[:-1], firsts)]
    decode_tokens = len(reqs) * (MAX_NEW - 1)
    decode_s = t_end - max(firsts)
    out = {
        "requests": len(reqs), "prompt_lens": list(PROMPT_LENS), "max_new": MAX_NEW,
        "prefill_ms": prefill, "ttft_ms": ttft, "decode_tokens": decode_tokens,
        "decode_s": decode_s, "decode_tokens_per_s": decode_tokens / decode_s,
        "total_s": t_end - t_start, "peak_bytes": peak, "launches": launches,
        "greedy_worst_gap": worst,
    }
    for i, r in enumerate(reqs):
        print(f"[{card}] request {r.req_id}: prompt {len(r.prompt)}, prefill {prefill[i]:.3f} ms, "
              f"TTFT {ttft[i]:.3f} ms", flush=True)
    print(f"[{card}] decode {decode_tokens} tokens in {decode_s:.4f} s: "
          f"{decode_tokens / decode_s:.3f} tokens/s", flush=True)
    print(f"[{card}] peak device memory {peak} bytes; flash_attention launches {launches}", flush=True)
    del engine  # the model stays for the serving group's phase
    return out, cfg, model


def greedy_worst_gap(model, reqs, got: dict) -> float:
    """How far the served tokens trail the greedy choice of the
    teacher-forced full-sequence forward (prefill attention through the
    kernel, against decode attention through the paged cache): the
    largest gap in logits over every token of every request."""
    import numpy as np
    import torch

    worst = 0.0
    for r in reqs:
        seq = np.concatenate([r.prompt, got[r.req_id][:-1]])
        logits = model(torch.from_numpy(seq[None].astype(np.int64)).cuda())[0, len(r.prompt) - 1:]
        assert bool(torch.isfinite(logits).all())
        served_tok = torch.from_numpy(got[r.req_id].astype(np.int64)).cuda()
        gap = logits.max(-1).values - logits.gather(-1, served_tok[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        del logits
    return worst


def group_setup(cfg, model):
    """The serving group's workload: a BrokerCluster(3) holding a request
    and a response topic of GROUP_PARTITIONS partitions each at
    replication factor 3, an LMServingGroup of GROUP_WORKERS
    transactional workers, each a ContinuousLMEngine over ``model`` sized
    as ``serving_setup``'s and warmed up by one short request outside the
    topic, and the requests: PROMPT_LENS twice, tenant ``i % 4``.
    Returns (cluster, group, requests)."""
    import numpy as np

    from repro_torch.core.cluster import BrokerCluster
    from repro_torch.core.log import LogConfig
    from repro_torch.serve.lm_engine import ContinuousLMEngine, LMServingGroup, Request

    max_blocks = -(-(max(PROMPT_LENS) + MAX_NEW - 1) // BLOCK)
    rng = np.random.default_rng(SEED + 4)
    engines = []
    for _ in range(GROUP_WORKERS):
        engine = ContinuousLMEngine(
            model, n_slots=4, n_blocks=4 * max_blocks + 1, block_size=BLOCK,
            max_blocks=max_blocks, device="cuda",
        )
        engine.submit(Request(-1, rng.integers(0, cfg.vocab, 64).astype(np.int32), 2))
        engine.run_until_drained()
        engine.first_token_s.clear()
        engines.append(engine)

    cluster = BrokerCluster(3, default_acks="all")
    for topic in ("lm-req", "lm-resp"):
        cluster.create_topic(topic, LogConfig(num_partitions=GROUP_PARTITIONS, replication_factor=3))
    group = LMServingGroup(cluster, engines, input_topic="lm-req", response_topic="lm-resp", transactional=True)
    reqs = [
        Request(i, rng.integers(0, cfg.vocab, n).astype(np.int32), MAX_NEW, tenant=i % 4)
        for i, n in enumerate(PROMPT_LENS * 2)
    ]
    return cluster, group, reqs


def committed_completions(cluster) -> tuple[dict, dict]:
    """Read-committed audit of the response topic: req_id -> (tenant,
    tokens), and how often each req_id appears. A partition whose leader
    is being elected reads as not there yet."""
    from repro_torch.core.cluster import ClusterError
    from repro_torch.serve.lm_engine import decode_completion

    got, counts = {}, {}
    for part in range(GROUP_PARTITIONS):
        try:
            end = cluster.end_offset("lm-resp", part)
        except ClusterError:
            continue
        off = 0
        while off < end:
            try:
                batch = cluster.read("lm-resp", part, off, 256, isolation="read_committed")
            except ClusterError:
                break
            for buf in batch.values:
                rid, tenant, gen = decode_completion(buf)
                got[rid] = (tenant, gen)
                counts[rid] = counts.get(rid, 0) + 1
            off = batch.next_offset
    return got, counts


def phase_serve_group(card, kernels: dict, cfg, model):
    """Serve ``group_setup``'s requests through the LMServingGroup across a
    broker failover, as tests/test_serving_chaos.py does: half of them,
    then the response partition 0's leader is killed while replication
    runs, and the rest are served under controller ticks until all are in
    the read_committed view. Every request must come back exactly once,
    each token a greedy choice of the forward within GREEDY_SLACK; K1
    launches once a layer per prefill, and a request re-served after an
    aborted transaction is prefilled again."""
    import torch

    from repro_torch.core.cluster import ClusterError
    from repro_torch.serve.lm_engine import encode_request, tenant_key

    t0 = time.perf_counter()
    cluster, group, reqs = group_setup(cfg, model)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"[{card}] yi-6b serving group: {GROUP_WORKERS} transactional workers, {GROUP_PARTITIONS} "
          f"partitions at replication factor 3 on 3 brokers, set-up and warm-up {setup_s:.3f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    half = len(reqs) // 2

    reset_counts(kernels)
    t_start = time.perf_counter()
    for r in reqs[:half]:
        cluster.produce("lm-req", encode_request(r), key=tenant_key(r.tenant))
    first_served = group.poll_all()
    torch.cuda.synchronize()
    t_kill = time.perf_counter()
    cluster.start_replication(interval_s=0.002, workers=2)
    try:
        killed = cluster.leader_for("lm-resp", 0)
        cluster.kill_broker(killed)
        for r in reqs[half:]:
            cluster.produce("lm-req", encode_request(r), key=tenant_key(r.tenant))
        deadline = time.monotonic() + GROUP_DEADLINE_S
        ticks = cluster_errors = 0
        while True:
            if time.monotonic() > deadline:
                raise AssertionError(f"the serving group did not serve all {len(reqs)} requests "
                                     f"within {GROUP_DEADLINE_S} s of the broker kill")
            ticks += 1
            cluster.controller_tick()
            try:
                group.poll_all()
            except ClusterError:
                cluster_errors += 1
                continue  # election window: abort and rewind, retry the tick
            got, counts = committed_completions(cluster)
            if len(got) == len(reqs):
                break
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        cluster.stop_replication()
    launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
    assert kernels["flash_attention"].BWD_LAUNCHES == 0, "serving launched the backward"
    peak = torch.cuda.max_memory_allocated()

    assert sorted(got) == [r.req_id for r in reqs], sorted(got)
    dups = {rid: n for rid, n in counts.items() if n != 1}
    assert not dups, f"completions published more than once: {dups}"
    for r in reqs:
        tenant, g = got[r.req_id]
        assert tenant == r.tenant, (r.req_id, tenant)
        assert len(g) == MAX_NEW and ((g >= 0) & (g < cfg.vocab_padded)).all(), (r.req_id, g)
    attn = launches.pop("flash_attention")
    assert not any(launches.values()), launches
    assert attn % cfg.n_layers == 0 and attn >= cfg.n_layers * len(reqs), (
        f"flash_attention launched {attn}, want a multiple of {cfg.n_layers} of at least "
        f"{cfg.n_layers * len(reqs)}")
    reserved = attn // cfg.n_layers - len(reqs)
    admissions = [w.engine.admissions - 1 for w in group.workers]  # less each warm-up
    assert sum(admissions) == attn // cfg.n_layers, (admissions, attn)
    worst = greedy_worst_gap(model, reqs, {rid: g for rid, (_, g) in got.items()})
    assert worst <= GREEDY_SLACK, f"served tokens trail the forward's greedy choice by {worst}"

    served = {w.worker_id: w.served for w in group.workers}
    out = {
        "requests": len(reqs), "prompt_lens": list(PROMPT_LENS) * 2, "max_new": MAX_NEW,
        "workers": GROUP_WORKERS, "partitions": GROUP_PARTITIONS, "brokers": 3, "killed_broker": killed,
        "first_half_s": t_kill - t_start, "second_half_s": t_end - t_kill, "total_s": t_end - t_start,
        "first_half_served": first_served, "served": served, "reserved": reserved, "ticks": ticks,
        "cluster_errors": cluster_errors, "admissions": admissions,
        "peak_bytes": peak, "launches": attn, "greedy_worst_gap": worst,
    }
    print(f"[{card}] yi-6b group first half: {half} requests, {first_served} served in "
          f"{t_kill - t_start:.4f} s", flush=True)
    print(f"[{card}] yi-6b group second half: broker {killed} (leader of lm-resp/0) killed, "
          f"{len(reqs) - half} more requests, all {len(reqs)} committed exactly once after "
          f"{t_end - t_kill:.4f} s, {ticks} ticks, {cluster_errors} cluster errors", flush=True)
    print(f"[{card}] yi-6b group completions per worker {served}; re-served requests {reserved}", flush=True)
    print(f"[{card}] yi-6b group peak device memory {peak} bytes; flash_attention launches {attn}; "
          f"greedy worst gap {worst:.4f} (slack {GREEDY_SLACK})", flush=True)
    return out


def rglru_bound(b, s, c, h0: bool) -> tuple[float, str]:
    """Least time for the RG-LRU scan: max(bytes / HBM rate, ops / peak).

    Bytes: x and log_a read and h written once (B S C f32 each), h0 read
    when given and h_last written (B C f32). Operations: 8 an element (two
    exps, the 1 - e, the max, the sqrt, the product with x, and the
    chain's multiply-add) at the CUDA cores' f32 rate."""
    nbytes = 4 * (3 * b * s * c + b * c * (2 if h0 else 1))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 8 * b * s * c / PEAK_FLOPS["float32"]
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def rglru_inputs(b, s, c, gen, h0: str | None, model_decays: bool):
    """x, log_a and h0 on the card for one K3 call: log a = -|N| * 0.3 (the
    tests' decays) or log(u) r / 2, u ~ U(0.81, 0.998) per channel and r a
    sigmoid gate (the model's); h0 None, "zero" (as the cache hands it) or
    "random"."""
    import torch

    x = torch.randn((b, s, c), generator=gen, device="cuda")
    if model_decays:
        u = torch.rand((c,), generator=gen, device="cuda") * (0.998 - 0.81) + 0.81
        r = torch.sigmoid(torch.randn((b, s, c), generator=gen, device="cuda"))
        log_a = torch.log(u) * r / 2
    else:
        log_a = -torch.randn((b, s, c), generator=gen, device="cuda").abs() * 0.3
    h_init = {None: None, "zero": torch.zeros((b, c), device="cuda"),
              "random": torch.randn((b, c), generator=gen, device="cuda")}[h0]
    return x, log_a, h_init


def check_rglru(card, ref, b, s, c, gen, h0: str | None, model_decays: bool, timed: bool):
    """K3 vs its plain version run in float64 on one input
    (``rglru_inputs``), element by element within |got - want| <= tol +
    tol |want| (tol RGLRU_TOL with the tests' decays, RGLRU_F64_TOL with
    the model's); the f32 plain version's own distance from the float64
    run is printed beside. With ``timed`` also times the kernel and both
    plain runs. Raises if the kernel disagrees."""
    import torch

    from repro_torch.kernels.ops import rglru_op

    x, log_a, h_init = rglru_inputs(b, s, c, gen, h0, model_decays)

    def kernel():
        return rglru_op(x, log_a, h_init)

    def plain():
        return ref.rglru(x, log_a, h_init)

    def plain64():
        return ref.rglru(x.double(), log_a.double(), None if h_init is None else h_init.double())

    (h, hl), (hr, _), (h64, hl64) = kernel(), plain(), plain64()
    torch.cuda.synchronize()
    tol = RGLRU_F64_TOL if model_decays else RGLRU_TOL
    row = {"b": b, "s": s, "c": c, "h0": h0, "model_decays": model_decays, "tol": tol,
           "rms_h": float(h64.square().mean().sqrt())}
    ok = bool(torch.isfinite(h).all()) and bool(torch.isfinite(hl).all())
    for name, got in (("kernel", h), ("plain_f32", hr)):
        err = (got.double() - h64).abs()
        row[f"{name}_vs_f64_max_abs_err"] = float(err.max())
        row[f"{name}_vs_f64_el_err"] = float((err / (tol + tol * h64.abs())).max())  # <= 1 passes
    row["max_abs_err"] = max(row["kernel_vs_f64_max_abs_err"], float((hl.double() - hl64).abs().max()))
    ok = ok and row["kernel_vs_f64_el_err"] <= 1.0
    ok = ok and bool(((hl.double() - hl64).abs() <= tol + tol * hl64.abs()).all())
    row["ok"] = ok
    if timed:
        row["ms"] = time_ms(kernel, 20)
        row["plain_ms"] = time_ms(plain, 2)
        row["plain_f64_ms"] = time_ms(plain64, 1)
        row["library_ms"] = None  # no single PyTorch call computes the RG-LRU recurrence
        row["bound_ms"], row["bound_by"] = rglru_bound(b, s, c, h0 is not None)
    print(f"[{card}] rglru_scan {json.dumps(row)}", flush=True)
    if not ok:
        raise AssertionError(f"rglru_scan disagrees with its plain version: {row}")
    return row


def phase_rglru_kernel(card, ref):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = [check_rglru(card, ref, b, s, c, gen, "random", False, False) for b, s, c in RGLRU_SWEEP]
    # the teacher-forced forward's call (B 1: a quarter of the path's
    # blocks), then the serving path's: one per RG-LRU layer of the wave,
    # the model's decays; the main row draws a random h0, the stricter
    # check of the carry, and the row beside it the zero h0 the cache
    # hands the path
    rows.append(check_rglru(card, ref, 1, RG_PROMPT_LEN + MAX_NEW - 1, 4096, gen, None, True, True))
    main = check_rglru(card, ref, WAVE_REQUESTS, RG_PROMPT_LEN, 4096, gen, "random", True, True)
    rows.append(check_rglru(card, ref, WAVE_REQUESTS, RG_PROMPT_LEN, 4096, gen, "zero", True, True))
    rows += [check_rglru(card, ref, b, s, c, gen, "random", False, False) for b, s, c in RGLRU_EDGES]
    return rows, main


def wave_setup(arch: str, compute_dtype: str, prompt_len: int):
    """A wave workload: full-width ``arch`` with random bf16 weights from
    SEED (the same for either activation dtype) behind a wave ``LMEngine``
    of WAVE_REQUESTS slots holding ``prompt_len + MAX_NEW`` cache slots,
    warmed up by one short wave (64 tokens: for a local layer, shorter than
    its window), and a topic of WAVE_REQUESTS fixed-length prompts in the
    JAX package's record format (int32[prompt_len] each)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core.log import StreamLog
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy
    from repro_torch.serve.lm_engine import LMEngine, Request

    cfg = configs.get(arch)
    model = StreamModel(cfg, Policy(compute_dtype=compute_dtype), device="cuda", generator=SEED)
    engine = LMEngine(model, n_slots=WAVE_REQUESTS, s_cache=prompt_len + MAX_NEW, device="cuda")
    rng = np.random.default_rng(SEED + 1)
    engine.submit(Request(-1, rng.integers(0, cfg.vocab, 64).astype(np.int32), 2))
    engine.run_until_drained()
    engine.first_token_s.clear()

    log = StreamLog()
    log.create_topic("lm-prompts")
    prompts = rng.integers(0, cfg.vocab, (WAVE_REQUESTS, prompt_len)).astype(np.int32)
    log.produce_batch("lm-prompts", [row.tobytes() for row in prompts])
    return cfg, model, engine, log, prompts


def phase_serve_wave(card, kernels: dict, arch: str, compute_dtype: str, prompt_len: int, slack: float):
    """Serve ``wave_setup``'s topic and check what comes back. ``kernels``
    maps each kernel's name to its module; the wave's prefill must launch
    K1 once an attention layer, K2 once an SSM layer and K3 once an RG-LRU
    layer, and nothing else (decode runs no kernel of the port)."""
    import numpy as np
    import torch

    from repro_torch.serve.lm_engine import serve_stream

    t0 = time.perf_counter()
    cfg, model, engine, log, prompts = wave_setup(arch, compute_dtype, prompt_len)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    tag = f"{arch} ({compute_dtype} activations)"
    print(f"[{card}] {arch} full width: {cfg.n_layers} layers, pattern {cfg.pattern}, d {cfg.d_model}, "
          f"{n_params} params bf16, {compute_dtype} activations, set-up and warm-up {setup_s:.3f} s",
          flush=True)
    torch.cuda.reset_peak_memory_stats()

    reset_counts(kernels)
    t_start = time.perf_counter()
    served = serve_stream(engine, log, "lm-prompts", "lm-completions", prompt_len, max_new=MAX_NEW)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
    assert kernels["flash_attention"].BWD_LAUNCHES == 0, "serving launched the backward"

    peak = torch.cuda.max_memory_allocated()
    got = {}
    for buf in log.read("lm-completions", 0, 0, 64).values:
        rec = np.frombuffer(buf, np.int32)
        got[int(rec[0])] = rec[1:].copy()
    assert served == WAVE_REQUESTS and sorted(got) == list(range(WAVE_REQUESTS)), (served, sorted(got))
    for rid, g in got.items():
        assert len(g) == MAX_NEW and ((g >= 0) & (g < cfg.vocab_padded)).all(), (rid, g)
    assert engine.waves == 2, engine.waves  # the warm-up wave and the served one
    kinds = [kind for kind, *_ in model._layer_params()]
    want = {  # the wave's prefill: one launch per layer of the kernel's kind
        "flash_attention": sum(k in ("attn", "local") for k in kinds),
        "ssd_scan": kinds.count("ssm"),
        "rglru_scan": kinds.count("rec"),
    }
    assert launches == want, f"{arch}: launches {launches}, want {want}"

    # each served token must be a greedy choice of the teacher-forced
    # full-sequence forward (the prefill's kernels over the whole sequence,
    # against decode through the recurrent states and caches): the first
    # token (the prefill's, the same kernels as the forward's) within
    # GREEDY_SLACK and the decoded ones within ``slack``
    gaps = []
    for rid in range(WAVE_REQUESTS):
        seq = np.concatenate([prompts[rid], got[rid][:-1]])
        logits = model(torch.from_numpy(seq[None].astype(np.int64)).cuda())[0, prompt_len - 1:]
        assert bool(torch.isfinite(logits).all())
        served_tok = torch.from_numpy(got[rid].astype(np.int64)).cuda()
        gap = logits.max(-1).values - logits.gather(-1, served_tok[:, None])[:, 0]
        gaps.append([round(float(x), 4) for x in gap])
        del logits
    first_gap = max(g[0] for g in gaps)
    worst = max(max(g[1:]) for g in gaps)
    assert first_gap <= GREEDY_SLACK, f"the first served tokens trail the forward's greedy choice by {first_gap}"
    assert worst <= slack, f"served tokens trail the forward's greedy choice by {worst} ({gaps})"

    first = max(engine.first_token_s[rid] for rid in range(WAVE_REQUESTS))
    ttft = (first - t_start) * 1e3
    decode_tokens = WAVE_REQUESTS * (MAX_NEW - 1)
    decode_s = t_end - first
    out = {
        "arch": arch, "requests": WAVE_REQUESTS, "prompt_len": prompt_len, "max_new": MAX_NEW,
        "prefill_ms": ttft, "ttft_ms": ttft, "decode_tokens": decode_tokens, "decode_s": decode_s,
        "decode_tokens_per_s": decode_tokens / decode_s, "total_s": t_end - t_start,
        "peak_bytes": peak, "launches": launches, "compute_dtype": compute_dtype,
        "greedy_first_gap": first_gap, "greedy_worst_decoded_gap": worst, "greedy_slack": slack,
        "greedy_gaps": gaps,
    }
    print(f"[{card}] {tag} wave of {WAVE_REQUESTS} x {prompt_len}: prefill (TTFT) {ttft:.3f} ms", flush=True)
    print(f"[{card}] {tag} decode {decode_tokens} tokens in {decode_s:.4f} s: "
          f"{decode_tokens / decode_s:.3f} tokens/s", flush=True)
    print(f"[{card}] {tag} peak device memory {peak} bytes; launches {launches}; "
          f"greedy gap first {first_gap:.4f}, worst decoded {worst:.4f} (slack {slack})", flush=True)
    del engine, model
    return out


def path_summary(launches: int, timed: list) -> dict:
    """One path's share of a kernel: its launches, and the sums of its
    timed calls' times with the ratios that say where the kernel stands."""
    out = {"launches": launches}
    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
        out[key] = sum(r[key] for r in timed)
    out["bound_by"] = max(timed, key=lambda r: r["bound_ms"])["bound_by"]
    out["ms_over_library_ms"] = out["ms"] / out["library_ms"]
    out["bound_ms_over_ms"] = out["bound_ms"] / out["ms"]
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention, rglru_scan, ssd_scan

    kernels = {"flash_attention": flash_attention, "ssd_scan": ssd_scan, "rglru_scan": rglru_scan}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)

    build_s = _build.build_all()
    print(f"build: {build_s:.3f} s", flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if any(w in line.lower() for w in ("registers", "spill", "compiling entry function", "wgmma", "warning")):
                print(f"  {name}: {line.strip()}", flush=True)

    rows, main_rows, rg_attn_main = phase_kernels(card, flash_attention, ref)
    bwd_rows, lse_rows, train_fwd_main, bwd_main = phase_kernels_bwd(card, flash_attention, ref)
    ssd_rows, ssd_main = phase_ssd_kernel(card, ref)
    rglru_rows, rglru_main = phase_rglru_kernel(card, ref)
    # training first: its ~60 GB are freed before the serving models load
    training, trained_layer = phase_train(card, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    train_grads = phase_train_grads(card, ref, trained_layer)
    del trained_layer
    gc.collect()
    torch.cuda.empty_cache()
    serving, yi_cfg, yi_model = phase_serve(card, kernels)
    serving_group = phase_serve_group(card, kernels, yi_cfg, yi_model)
    del yi_model
    # mamba2's bf16 drift needs a slack above GREEDY_SLACK, so an f32 twin
    # holds every token at it; recurrentgemma's does not
    paths = {}
    for arch, compute_dtype, prompt_len, slack in (
        ("mamba2-2.7b", "bfloat16", SSM_PROMPT_LEN, SSM_BF16_DRIFT_SLACK),
        ("mamba2-2.7b", "float32", SSM_PROMPT_LEN, GREEDY_SLACK),
        ("recurrentgemma-9b", "bfloat16", RG_PROMPT_LEN, GREEDY_SLACK),
    ):
        gc.collect()
        torch.cuda.empty_cache()  # each serving phase's peak memory is its own
        paths[arch, compute_dtype] = phase_serve_wave(card, kernels, arch, compute_dtype, prompt_len, slack)
    serving_ssm, serving_rg = paths["mamba2-2.7b", "bfloat16"], paths["recurrentgemma-9b", "bfloat16"]

    # K1 runs on three paths: yi-6b's serving calls (one per served prompt
    # length), yi-6b's training call (its forward, with lse) and
    # recurrentgemma's one (its wave), each timed once; the sums cover
    # all, by_path holds each path's own
    attn_main = main_rows + [train_fwd_main, rg_attn_main]
    train_fwd_launches = training["launches"]["flash_attention"]
    entry = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:34",
        "launches": serving["launches"] + serving_group["launches"] + train_fwd_launches
        + serving_rg["launches"]["flash_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in attn_main),
        "matched": all(r["ok"] for r in rows + attn_main),
        "shapes": "one call at each of yi-6b's prompt lengths (1,S,32,128) S=%s bf16 causal, yi-6b's "
        "training call (%d,%d,32,128) kv 4 bf16 causal, and recurrentgemma's (%d,%d,16,256) kv 1 bf16 "
        "causal window 2048, summed"
        % ("/".join(map(str, PROMPT_LENS)), TRAIN_BATCH, TRAIN_SEQ, WAVE_REQUESTS, RG_PROMPT_LEN),
        "by_path": {
            "yi-6b": path_summary(serving["launches"], main_rows),
            "yi-6b-group": path_summary(serving_group["launches"], main_rows),
            "yi-6b-train": path_summary(train_fwd_launches, [train_fwd_main]),
            "recurrentgemma-9b": path_summary(serving_rg["launches"]["flash_attention"], [rg_attn_main]),
        },
    }
    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
        entry[key] = sum(r[key] for r in attn_main)
    entry["bound_by"] = max(attn_main, key=lambda r: r["bound_ms"])["bound_by"]  # the largest term
    ssd_entry = {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:33",
        "launches": serving_ssm["launches"]["ssd_scan"],
        "max_abs_err": ssd_main["max_abs_err"],
        "matched": all(r["ok"] for r in ssd_rows + [ssd_main]),
        "shapes": "one call per layer of the wave (%d,%d,80,64) N128 G1 chunk 256 bf16"
        % (WAVE_REQUESTS, SSM_PROMPT_LEN),
    }
    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
        ssd_entry[key] = ssd_main[key]
    rglru_entry = {
        "name": "rglru_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:30",
        "launches": serving_rg["launches"]["rglru_scan"],
        "max_abs_err": rglru_main["max_abs_err"],
        "matched": all(r["ok"] for r in rglru_rows + [rglru_main]),
        "shapes": "one call per RG-LRU layer of the wave (%d,%d,4096) f32, the model's decays, "
        "against a float64 run" % (WAVE_REQUESTS, RG_PROMPT_LEN),
    }
    for key in ("ms", "plain_ms", "plain_f64_ms", "bound_ms", "bound_by", "library_ms"):
        rglru_entry[key] = rglru_main[key]
    bwd_entry = {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        # no TPU kernel: JAX differentiates its plain chunked attention
        "replaces": "none (JAX differentiates src/repro/models/layers.py:314)",
        "launches": training["launches"]["flash_attention_bwd"],
        "max_abs_err": bwd_main["max_abs_err"],
        "matched": all(r["ok"] for r in bwd_rows + [bwd_main]) and train_grads is not None,
        "shapes": "yi-6b's training call (%d,%d,32,128) kv 4 bf16 causal, one a layer a step"
        % (TRAIN_BATCH, TRAIN_SEQ),
        "by_path": {"yi-6b-train": path_summary(training["launches"]["flash_attention_bwd"], [bwd_main])},
    }
    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
        bwd_entry[key] = bwd_main[key]
    kernels_line = {"kernels": [entry, bwd_entry, ssd_entry, rglru_entry]}

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "torch": torch.__version__, "build_s": build_s, "checks": rows,
        "bwd_checks": bwd_rows, "lse_checks": lse_rows, "training": training, "training_grads": train_grads,
        "main_path_kernel": attn_main, "serving": serving, "serving_group": serving_group, "ssd_checks": ssd_rows,
        "ssd_main_path_kernel": ssd_main, "rglru_checks": rglru_rows, "rglru_main_path_kernel": rglru_main,
        "serving_waves": {f"{arch} {dt}": out for (arch, dt), out in paths.items()},
        "kernels": kernels_line["kernels"],
    }, indent=1))

    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
