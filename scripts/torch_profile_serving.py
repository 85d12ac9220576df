#!/usr/bin/env python3
"""Where the time goes when the PyTorch port serves an LM from a stream.

    python3 scripts/torch_profile_serving.py                        # yi-6b
    python3 scripts/torch_profile_serving.py --model mamba2          # mamba2-2.7b
    python3 scripts/torch_profile_serving.py --model recurrentgemma  # recurrentgemma-9b
    python3 scripts/torch_profile_serving.py --model qwen3-moe-30b-a3b --int8

On a machine with one CUDA card. Builds the kernels, then runs one of
chip_smoke.py's served workloads under ``torch.profiler``, with the
prefill and decode calls marked: yi-6b (``chip_smoke.serving_setup``:
full width, random bf16 weights from its seed, four requests of
512/1000/1536/2000 prompt tokens and 16 new tokens each, through
``serve_stream`` and ``ContinuousLMEngine``), or a wave path
(``chip_smoke.wave_setup``: full width, random bf16 weights, one wave of
four prompts and 16 new tokens each through ``LMEngine``): mamba2-2.7b
with 2000-token prompts, recurrentgemma-9b with 3000-token ones; or
qwen3-moe-30b-a3b at all 48 layers with int8 weights
(``chip_smoke.serving_setup`` with ``Policy(weights_int8=True)``, the
published capacity factor; its bf16 weights, 61 GB, are not built here),
where the device time is also split by where it was launched from: the
int8 dequantization (``model._dq_tree``), the MoE FFN (``moe_ffn``: the
router and aux loss) and inside it the experts (``moe._local_moe``:
batched matmuls are the expert products, the rest the dispatch and
combine), decode attention (``layers.decode_attention`` /
``paged_decode_attention``, their projections included) and K1.
Prints the device time by phase and by kernel class, the device's busy
and idle share of the wall time, and the top kernels; writes them and
the full table to ``chiprun_out/profile_serving[_<model>].*``. Times are
taken under the profiler, which slows the host. Exits non-zero with no
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0))


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "flash_attention" in n:
        return "flash_attention (this repo's kernel)"
    if any(t in n for t in ("ssd_scan", "ssd_chunk_states", "ssd_state_pass", "ssd_chunk_out")):
        return "ssd_scan (this repo's kernel)"  # f32: one kernel; bf16: its three phases
    if "rglru_scan" in n:
        return "rglru_scan (this repo's kernel)"
    if any(t in n for t in ("gemm", "cutlass", "sm90_xmma", "nvjet", "cublas")):
        return "matmul (cuBLAS)"
    if any(t in n for t in ("index", "gather", "scatter")):
        return "index / gather / scatter"
    if "reduce" in n or "softmax" in n:
        return "reductions / softmax"
    if "copy" in n or "cat" in n:
        return "copies / casts"
    return "elementwise and other"


# the functions that mark where a kernel was launched from (innermost first)
REGIONS = ("moe:experts", "int8:dequantize", "moe:ffn", "attention:decode")


def _mark_regions() -> None:
    """Wrap the functions of REGIONS in profiler ranges of their names."""
    from torch.profiler import record_function

    from repro_torch.models import layers, model, moe

    def marked(fn, name):
        def run(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return run

    moe._local_moe = marked(moe._local_moe, "moe:experts")
    model._dq_tree = marked(model._dq_tree, "int8:dequantize")
    model.moe_ffn = marked(model.moe_ffn, "moe:ffn")
    layers.decode_attention = marked(layers.decode_attention, "attention:decode")
    layers.paged_decode_attention = marked(layers.paged_decode_attention, "attention:decode")


def _by_region(prof) -> dict:
    """Device ms of every kernel, by the innermost REGIONS range its host
    op ran in ("other" outside them) and the kernel's class."""
    out: dict[str, dict[str, float]] = {}
    for evt in prof.events():
        kernels = getattr(evt, "kernels", None)
        if not kernels:
            continue
        region, parent = "other", evt
        while parent is not None:
            if parent.name in REGIONS:
                region = parent.name
                break
            parent = parent.cpu_parent
        cls = out.setdefault(region, {})
        for k in kernels:
            key = _kernel_class(k.name)
            cls[key] = cls.get(key, 0.0) + k.duration / 1e3
    return out


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("yi-6b", "mamba2", "recurrentgemma", chip_smoke.MOE), default="yi-6b")
    ap.add_argument("--int8", action="store_true", help="int8 weights (qwen3-moe-30b-a3b needs them)")
    args = ap.parse_args()
    if (args.model == chip_smoke.MOE) != args.int8:
        ap.error(f"--int8 goes with --model {chip_smoke.MOE} (its bf16 weights do not fit one card)")
    if not torch.cuda.is_available():
        print("torch_profile_serving: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.serve.lm_engine import serve_stream

    card = chip_smoke.card_line()
    _build.build_all()
    if args.model == chip_smoke.MOE:
        from repro_torch.models.policy import Policy

        _mark_regions()
        _, model, engine, log, reqs = chip_smoke.serving_setup(args.model, policy=Policy(weights_int8=True))
        n_reqs, suffix = len(reqs), f"_{args.model}_int8"

        def serve():
            return serve_stream(engine, log, "lm-requests", "lm-completions")
    elif args.model != "yi-6b":
        arch, prompt_len = {
            "mamba2": ("mamba2-2.7b", chip_smoke.SSM_PROMPT_LEN),
            "recurrentgemma": ("recurrentgemma-9b", chip_smoke.RG_PROMPT_LEN),
        }[args.model]
        _, model, engine, log, prompts = chip_smoke.wave_setup(arch, "bfloat16", prompt_len)
        n_reqs, suffix = len(prompts), f"_{args.model}"

        def serve():
            return serve_stream(engine, log, "lm-prompts", "lm-completions", prompt_len, max_new=chip_smoke.MAX_NEW)
    else:
        _, model, engine, log, reqs = chip_smoke.serving_setup()
        n_reqs, suffix = len(reqs), ""

        def serve():
            return serve_stream(engine, log, "lm-requests", "lm-completions")

    prefill, decode = model.prefill, model.decode_step

    def marked_prefill(*a, **k):
        with record_function("phase:prefill"):
            return prefill(*a, **k)

    def marked_decode(*a, **k):
        with record_function("phase:decode"):
            return decode(*a, **k)

    model.prefill, model.decode_step = marked_prefill, marked_decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        served = serve()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    if served != n_reqs:
        raise RuntimeError(f"served {served} of {n_reqs} requests")

    events = prof.key_averages()
    # device-side events only (kernels, memcpy, memset): the host ops that
    # launched them carry the same time again, and the phase markers'
    # device spans cover them
    kernels = [
        e for e in events
        if str(e.device_type).endswith("CUDA") and _device_us(e) > 0 and not e.key.startswith("phase:")
        and e.key not in REGIONS
    ]
    busy_us = sum(_device_us(e) for e in kernels)
    by_class: dict[str, float] = {}
    for e in kernels:
        by_class[_kernel_class(e.key)] = by_class.get(_kernel_class(e.key), 0.0) + _device_us(e)
    phases = {}
    for e in events:
        if e.key.startswith("phase:"):
            # the marker's span on the device timeline, first kernel to last, gaps included
            phases.setdefault(e.key, {"calls": 0, "device_span_ms": 0.0})
            phases[e.key]["calls"] = max(phases[e.key]["calls"], e.count)
            phases[e.key]["device_span_ms"] += _device_us(e) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:15]
    summary = {
        "card": card, "model": args.model, "wall_ms": wall_s * 1e3, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / (wall_s * 1e3),
        "phases": phases,
        "by_class_ms": {k: v / 1e3 for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])},
        "by_region_ms": _by_region(prof),
        "top_kernels": [
            {"name": e.key[:120], "calls": e.count, "device_ms": _device_us(e) / 1e3} for e in top
        ],
    }
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"profile_serving{suffix}.json").write_text(json.dumps(summary, indent=1))
    (out / f"profile_serving{suffix}.txt").write_text(
        events.table(
            sort_by="self_device_time_total" if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total",
            row_limit=60, max_name_column_width=100,
        )
    )
    print(f"[{card}]")
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
