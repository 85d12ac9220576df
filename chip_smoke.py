#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py            # from the repository root

Phases: (1) the card's name and power limit; (2) build every CUDA kernel
of the port from ``src/repro_torch/kernels/csrc`` with nvcc; (3) hold
each kernel against its plain PyTorch version on the card, at its
serving path's shapes and a sweep of modes, and time kernel, plain
version and (where one exists) one library call: K1 (flash attention),
then K2 (SSD scan); (4) serve four requests of mixed prompt lengths from
a stream topic through full-width yi-6b (32 layers, d 4096, random bf16
weights from a seed) with ``ContinuousLMEngine`` and check what comes
back; (5) drop yi-6b and serve a topic of four 2000-token prompts through
full-width mamba2-2.7b (64 layers, d 2560, random bf16 weights from a
seed) with the wave engine ``LMEngine`` and check what comes back, then
serve it again with the same weights and f32 activations, where every
token is held to the teacher-forced forward at the tight slack;
(6) print the ``kernels`` line; (7) print the result line. Each serving
path is driven with every kernel's launch count set to 0 just before it
and read just after.

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
SSM_PROMPT_LEN = 2000  # mamba2 path: one wave of 4 fixed-length prompts
SSM_REQUESTS = 4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


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
    # the serving path's own calls: one per layer per request, bf16, causal
    main = [
        check_attention(card, fa, ref, 1, s, 32, 4, 128, "bfloat16", True, None, None, gen, True)
        for s in PROMPT_LENS
    ]
    return rows, main


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
    # tests/test_kernels.py:49-53's shapes (G = 1, 2 and H), with an initial
    # state that the tests' slow decays carry a long way
    for b, h, s, p, n, g, chunk in ((1, 2, 128, 32, 64, 1, 32), (2, 4, 256, 64, 128, 2, 64),
                                    (1, 4, 64, 16, 32, 4, 64)):
        for dtype in ("float32", "bfloat16"):
            rows.append(check_ssd(card, ref, b, s, h, p, n, g, chunk, dtype, "random", gen, False))
    # ragged S with an initial state; the teacher-forced forward's own shape
    for dtype in ("float32", "bfloat16"):
        rows.append(check_ssd(card, ref, 2, 1000, 8, 64, 128, 1, 256, dtype, "random", gen, False))
    rows.append(check_ssd(card, ref, 1, SSM_PROMPT_LEN + 15, 80, 64, 128, 1, 256, "bfloat16",
                          None, gen, False, model_decays=True))
    # the serving path's calls: one per layer, the wave's 4 prompts, the
    # model's decays, the zero initial state from the cache; in f32 as the
    # f32-activation run gives it, and in bf16, timed
    rows.append(check_ssd(card, ref, SSM_REQUESTS, SSM_PROMPT_LEN, 80, 64, 128, 1, 256, "float32",
                          "zero", gen, False, model_decays=True))
    main = check_ssd(card, ref, SSM_REQUESTS, SSM_PROMPT_LEN, 80, 64, 128, 1, 256, "bfloat16",
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


def phase_serve(card, fa, k2):
    import numpy as np
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

    fa.LAUNCHES = k2.LAUNCHES = 0
    t_start = time.perf_counter()
    served = serve_stream(engine, log, "lm-requests", "lm-completions")
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = fa.LAUNCHES

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
    # full-sequence forward (prefill attention through the kernel, against
    # decode attention through the paged cache), up to bf16 near-ties
    worst = 0.0
    for r in reqs:
        seq = np.concatenate([r.prompt, got[r.req_id][:-1]])
        logits = model(torch.from_numpy(seq[None].astype(np.int64)).cuda())[0, len(r.prompt) - 1:]
        assert bool(torch.isfinite(logits).all())
        served_tok = torch.from_numpy(got[r.req_id].astype(np.int64)).cuda()
        gap = logits.max(-1).values - logits.gather(-1, served_tok[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
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
    del engine, model
    return out


def ssm_setup(compute_dtype: str):
    """The mamba2 workload: full-width mamba2-2.7b with random bf16 weights
    from SEED (the same for either activation dtype) behind a wave
    ``LMEngine`` of SSM_REQUESTS slots, warmed up by one short wave, and a
    topic of SSM_REQUESTS fixed-length prompts in the JAX package's record
    format (int32[prompt_len] each)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core.log import StreamLog
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy
    from repro_torch.serve.lm_engine import LMEngine, Request

    cfg = configs.get("mamba2-2.7b")
    model = StreamModel(cfg, Policy(compute_dtype=compute_dtype), device="cuda", generator=SEED)
    engine = LMEngine(model, n_slots=SSM_REQUESTS, device="cuda")
    rng = np.random.default_rng(SEED + 1)
    engine.submit(Request(-1, rng.integers(0, cfg.vocab, 64).astype(np.int32), 2))
    engine.run_until_drained()
    engine.first_token_s.clear()

    log = StreamLog()
    log.create_topic("lm-prompts")
    prompts = rng.integers(0, cfg.vocab, (SSM_REQUESTS, SSM_PROMPT_LEN)).astype(np.int32)
    log.produce_batch("lm-prompts", [row.tobytes() for row in prompts])
    return cfg, model, engine, log, prompts


def phase_serve_ssm(card, fa, k2, compute_dtype: str):
    import numpy as np
    import torch

    from repro_torch.serve.lm_engine import serve_stream

    t0 = time.perf_counter()
    cfg, model, engine, log, prompts = ssm_setup(compute_dtype)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    tag = f"mamba2 ({compute_dtype} activations)"
    print(f"[{card}] mamba2-2.7b full width: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"d_inner {cfg.ssm.d_inner}, {cfg.ssm.n_heads} heads x {cfg.ssm.head_dim}, N {cfg.ssm.state_dim}, "
          f"{n_params} params bf16, {compute_dtype} activations, set-up and warm-up {setup_s:.3f} s",
          flush=True)
    torch.cuda.reset_peak_memory_stats()

    fa.LAUNCHES = k2.LAUNCHES = 0
    t_start = time.perf_counter()
    served = serve_stream(engine, log, "lm-prompts", "lm-completions", SSM_PROMPT_LEN, max_new=MAX_NEW)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches, fa_launches = k2.LAUNCHES, fa.LAUNCHES

    peak = torch.cuda.max_memory_allocated()
    got = {}
    for buf in log.read("lm-completions", 0, 0, 64).values:
        rec = np.frombuffer(buf, np.int32)
        got[int(rec[0])] = rec[1:].copy()
    assert served == SSM_REQUESTS and sorted(got) == list(range(SSM_REQUESTS)), (served, sorted(got))
    for rid, g in got.items():
        assert len(g) == MAX_NEW and ((g >= 0) & (g < cfg.vocab_padded)).all(), (rid, g)
    assert engine.waves == 2, engine.waves  # the warm-up wave and the served one
    want_launches = cfg.n_layers  # the wave's prefill: one per layer
    assert launches == want_launches, f"ssd_scan launched {launches}, want {want_launches}"
    assert fa_launches == 0, fa_launches

    # each served token must be a greedy choice of the teacher-forced
    # full-sequence forward (the scan through the kernel, against decode
    # through the recurrent state): with f32 activations every token within
    # GREEDY_SLACK; with bf16 activations the first token (the prefill's,
    # the same scan as the forward's) within GREEDY_SLACK and the decoded
    # ones within SSM_BF16_DRIFT_SLACK
    gaps = []
    for rid in range(SSM_REQUESTS):
        seq = np.concatenate([prompts[rid], got[rid][:-1]])
        logits = model(torch.from_numpy(seq[None].astype(np.int64)).cuda())[0, SSM_PROMPT_LEN - 1:]
        assert bool(torch.isfinite(logits).all())
        served_tok = torch.from_numpy(got[rid].astype(np.int64)).cuda()
        gap = logits.max(-1).values - logits.gather(-1, served_tok[:, None])[:, 0]
        gaps.append([round(float(x), 4) for x in gap])
    first_gap = max(g[0] for g in gaps)
    worst = max(max(g) for g in gaps)
    drift_slack = GREEDY_SLACK if compute_dtype == "float32" else SSM_BF16_DRIFT_SLACK
    assert first_gap <= GREEDY_SLACK, f"the first served tokens trail the forward's greedy choice by {first_gap}"
    assert worst <= drift_slack, f"served tokens trail the forward's greedy choice by {worst} ({gaps})"

    first = max(engine.first_token_s[rid] for rid in range(SSM_REQUESTS))
    ttft = (first - t_start) * 1e3
    decode_tokens = SSM_REQUESTS * (MAX_NEW - 1)
    decode_s = t_end - first
    out = {
        "requests": SSM_REQUESTS, "prompt_len": SSM_PROMPT_LEN, "max_new": MAX_NEW,
        "prefill_ms": ttft, "ttft_ms": ttft, "decode_tokens": decode_tokens, "decode_s": decode_s,
        "decode_tokens_per_s": decode_tokens / decode_s, "total_s": t_end - t_start,
        "peak_bytes": peak, "launches": launches, "compute_dtype": compute_dtype,
        "greedy_first_gap": first_gap, "greedy_worst_gap": worst, "greedy_gaps": gaps,
    }
    print(f"[{card}] {tag} wave of {SSM_REQUESTS} x {SSM_PROMPT_LEN}: prefill (TTFT) {ttft:.3f} ms", flush=True)
    print(f"[{card}] {tag} decode {decode_tokens} tokens in {decode_s:.4f} s: "
          f"{decode_tokens / decode_s:.3f} tokens/s", flush=True)
    print(f"[{card}] {tag} peak device memory {peak} bytes; ssd_scan launches {launches}; "
          f"greedy gap first {first_gap:.4f}, worst {worst:.4f}", flush=True)
    del engine, model
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as k2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)

    build_s = _build.build_all()
    print(f"build: {build_s:.3f} s", flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    rows, main_rows = phase_kernels(card, fa, ref)
    ssd_rows, ssd_main = phase_ssd_kernel(card, ref)
    serving = phase_serve(card, fa, k2)
    gc.collect()
    torch.cuda.empty_cache()  # each serving phase's peak memory is its own
    serving_ssm = phase_serve_ssm(card, fa, k2, "bfloat16")
    gc.collect()
    torch.cuda.empty_cache()
    serving_ssm_f32 = phase_serve_ssm(card, fa, k2, "float32")

    entry = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:34",
        "launches": serving["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in main_rows),
        "matched": all(r["ok"] for r in rows + main_rows),
        "shapes": "one call at each served prompt length (1,S,32,128) S=%s bf16 causal, summed"
        % "/".join(map(str, PROMPT_LENS)),
    }
    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
        entry[key] = sum(r[key] for r in main_rows)
    entry["bound_by"] = max(main_rows, key=lambda r: r["bound_ms"])["bound_by"]  # the largest term
    ssd_entry = {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:33",
        "launches": serving_ssm["launches"],
        "max_abs_err": ssd_main["max_abs_err"],
        "matched": all(r["ok"] for r in ssd_rows + [ssd_main]),
        "shapes": "one call per layer of the wave (%d,%d,80,64) N128 G1 chunk 256 bf16"
        % (SSM_REQUESTS, SSM_PROMPT_LEN),
    }
    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
        ssd_entry[key] = ssd_main[key]
    kernels = {"kernels": [entry, ssd_entry]}

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "torch": torch.__version__, "build_s": build_s, "checks": rows,
        "main_path_kernel": main_rows, "serving": serving, "ssd_checks": ssd_rows,
        "ssd_main_path_kernel": ssd_main, "serving_ssm": serving_ssm,
        "serving_ssm_f32_activations": serving_ssm_f32, "kernels": kernels["kernels"],
    }, indent=1))

    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
