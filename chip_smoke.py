#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py            # from the repository root

Phases: (1) the card's name and power limit; (2) build every CUDA kernel
of the port from ``src/repro_torch/kernels/csrc`` with nvcc; (3) hold
each kernel against its plain PyTorch version on the card, at the serving
path's shapes and a sweep of modes, and time kernel, plain version and
one library call; (4) serve four requests of mixed prompt lengths from a
stream topic through full-width yi-6b (32 layers, d 4096, random bf16
weights from a seed) with ``ContinuousLMEngine`` and check what comes
back; (5) print the ``kernels`` line; (6) print the result line.

It imports nothing of JAX or of the JAX package. With no CUDA device, or
run from a directory without the repository, it exits non-zero and
prints no result. Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

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
GREEDY_SLACK = 0.25  # logits: a served token may trail the forward's max by this much


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


def phase_serve(card, fa):
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

    fa.LAUNCHES = 0
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
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa

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
    serving = phase_serve(card, fa)

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
    kernels = {"kernels": [entry]}

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "torch": torch.__version__, "build_s": build_s, "checks": rows,
        "main_path_kernel": main_rows, "serving": serving, "kernels": kernels["kernels"],
    }, indent=1))

    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
