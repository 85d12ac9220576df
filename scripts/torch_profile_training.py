#!/usr/bin/env python3
"""Where the time goes when the PyTorch port trains yi-6b.

    python3 scripts/torch_profile_training.py [--steps 3]

On a machine with one CUDA card. Builds the kernels, then takes
chip_smoke.py's training workload (full-width yi-6b cut to its 16
layers, bf16 weights from its seed, AdamW with f32 moments, batches of 4
x 1024 tokens of its seeded Markov corpus) through the calls a
``TrainingJob`` step makes: ``StreamModel.loss``, ``torch.autograd.grad``
over the parameter tree and the optimizer's ``update``, each marked as a
phase. Two warm-up steps, then ``--steps`` steps under
``torch.profiler``. Prints the host-clock step time, the device time by
phase and by kernel class, the device's busy and idle share of the wall
time and the top kernels; writes them and the full table to
``chiprun_out/profile_training.*``. Times under the profiler slow the
host. Exits non-zero with no CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
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
    if any(t in n for t in ("dkdv_", "dq_bf16", "dq_f32", "delta_kernel")):
        return "flash_attention_bwd (this repo's kernel)"
    if "flash_attention" in n:
        return "flash_attention (this repo's kernel)"
    if any(t in n for t in ("gemm", "cutlass", "sm90_xmma", "nvjet", "cublas")):
        return "matmul (cuBLAS)"
    if any(t in n for t in ("index", "gather", "scatter", "embedding")):
        return "index / gather / scatter"
    if "reduce" in n or "softmax" in n or "logsumexp" in n:
        return "reductions / softmax"
    if "copy" in n or "cat" in n:
        return "copies / casts"
    return "elementwise and other"


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_training: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy
    from repro_torch.train import adamw, cosine_schedule
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten

    card = chip_smoke.card_line()
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get("yi-6b"), n_layers=chip_smoke.TRAIN_LAYERS)
    model = StreamModel(cfg, Policy(), device="cuda", generator=chip_smoke.SEED)
    params = model.param_tree()
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt = adamw(cosine_schedule(3e-4, chip_smoke.TRAIN_WARMUP, chip_smoke.TRAIN_STEPS))
    state = opt.init(params)
    corpus = chip_smoke.load_example("torch_train_lm").synth_corpus(
        chip_smoke.TRAIN_SEQS, cfg.vocab, seq=chip_smoke.TRAIN_SEQ, seed=chip_smoke.SEED)
    b = chip_smoke.TRAIN_BATCH
    batches = [torch.from_numpy(np.ascontiguousarray(corpus[i * b:(i + 1) * b])).cuda()
               for i in range(2 + args.steps)]

    def step(tokens):
        with record_function("phase:forward"):
            loss, _ = model.loss(params, {"tokens": tokens})
        with record_function("phase:backward"):
            grads = tree_unflatten(params, torch.autograd.grad(loss, tree_leaves(params)))
        with record_function("phase:optimizer"):
            opt.update(grads, state, params)
        return float(loss.detach())

    for tokens in batches[:2]:
        step(tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        losses = [step(tokens) for tokens in batches[2:]]
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    events = prof.key_averages()
    kernels = [
        e for e in events
        if str(e.device_type).endswith("CUDA") and _device_us(e) > 0 and not e.key.startswith("phase:")
    ]
    busy_us = sum(_device_us(e) for e in kernels)
    by_class: dict[str, float] = {}
    for e in kernels:
        by_class[_kernel_class(e.key)] = by_class.get(_kernel_class(e.key), 0.0) + _device_us(e)
    phases = {}
    for e in events:
        if e.key.startswith("phase:"):
            phases.setdefault(e.key, {"calls": 0, "device_span_ms": 0.0})
            phases[e.key]["calls"] = max(phases[e.key]["calls"], e.count)
            phases[e.key]["device_span_ms"] += _device_us(e) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:20]
    summary = {
        "card": card, "layers": cfg.n_layers, "batch": b, "seq": chip_smoke.TRAIN_SEQ, "steps": args.steps,
        "losses": losses, "wall_ms": wall_s * 1e3, "step_ms": wall_s * 1e3 / args.steps,
        "device_busy_ms": busy_us / 1e3, "device_idle_share": 1.0 - busy_us / 1e3 / (wall_s * 1e3),
        "peak_bytes": peak, "phases": phases,
        "by_class_ms": {k: v / 1e3 for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])},
        "top_kernels": [
            {"name": e.key[:120], "calls": e.count, "device_ms": _device_us(e) / 1e3} for e in top
        ],
    }
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_training.json").write_text(json.dumps(summary, indent=1))
    (out / "profile_training.txt").write_text(
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
