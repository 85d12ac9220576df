#!/usr/bin/env python3
"""Where the time goes when the PyTorch port trains an LM of the zoo.

    python3 scripts/torch_profile_training.py
        [--arch yi-6b|mamba2-2.7b|recurrentgemma-9b|gemma2-2b|qwen2-7b|qwen3-moe-30b-a3b|pixtral-12b|
                whisper-tiny]
        [--steps 3] [--layers 16] [--opt adamw|adamw8bit] [--remat none|block|full[,...]]

On a machine with one CUDA card. Builds the kernels, then takes
chip_smoke.py's training workload (full-width ``--arch``, yi-6b by
default, cut to ``--layers`` layers, 16 by default (qwen3-moe-30b-a3b's
and pixtral-12b's: chip_smoke.py's depths below): yi-6b has 32,
mamba2-2.7b 64, recurrentgemma-9b 38, of which chip_smoke.py trains
``RG_TRAIN_LAYERS``, gemma2-2b 26, qwen2-7b 28, qwen3-moe-30b-a3b 48, of
which it trains ``MOE_TRAIN_LAYERS``, pixtral-12b 40, of which it
trains ``PIXTRAL_TRAIN_LAYERS``, and whisper-tiny 4 (its full depth, the
default); bf16 weights from its seed, AdamW with f32 moments or
``adamw8bit``, batches of 4 x 1024 tokens of its seeded Markov corpus,
pixtral's each behind 4 x 1024 seeded patch embeddings, whisper's of 4 x
448 tokens each behind 4 x 1500 seeded frame embeddings)
through the calls a
``TrainingJob`` step makes: ``StreamModel.loss``, ``torch.autograd.grad``
over the parameter tree and the optimizer's ``update``, each marked as a
phase. Two warm-up steps, then ``--steps`` steps under
``torch.profiler`` for each ``--remat`` mode (``Policy.remat``; a comma
list runs in turns, none,full as none, full, full, none, each window
after one step of its own mode, each with its own peak memory, and
``by_remat`` gathers each mode's windows). Prints the host-clock step time, the device time by
phase and by kernel class, the device's busy and idle share of the wall
time and the top kernels, and for an MoE ``by_region_ms``: the device
time by where a kernel was launched from, the MoE's router
(``moe._router``: the router product, softmax and aux loss), dispatch
(``moe._dispatch``: the gather of each slot's token), experts
(``moe._experts``: the three batched products) and combine
(``moe._combine``), each in the forward and, by the autograd node of
the forward op behind it, in the backward (``<region>:backward``); the
top-k, ranks and slots that ``moe._local_moe`` computes between them
fall under "other". Writes them and the full table to
``chiprun_out/profile_training.*`` (``profile_training_<layers>_<opt>.*``
for other than the defaults, ``profile_training_<arch>_<layers>_<opt>.*``
for an arch other than yi-6b; ``_remat-<modes>`` after it for other
than ``none``). Times under the profiler slow the
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
    if "adamw8bit" in n:
        return "adamw8bit (this repo's kernel)"
    if "rglru_scan_bwd" in n:
        return "rglru_scan_bwd (this repo's kernel)"
    if "rglru_scan" in n:
        return "rglru_scan (this repo's kernel)"
    if "ssd_bwd" in n:
        return "ssd_scan_bwd (this repo's kernel)"
    if "ssd_" in n:
        return "ssd_scan (this repo's kernel)"
    if "sumsq_kernel" in n or "finish_kernel" in n:
        return "grad_norm (this repo's kernel)"
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


# the MoE's functions whose kernels are attributed to a region
REGIONS = {"_router": "moe:router", "_dispatch": "moe:dispatch", "_experts": "moe:experts", "_combine": "moe:combine"}


def _mark_regions() -> None:
    """Wrap the MoE functions of REGIONS in profiler ranges of their names."""
    from torch.profiler import record_function

    from repro_torch.models import moe

    def marked(fn, name):
        def run(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return run

    for fn_name, region in REGIONS.items():
        setattr(moe, fn_name, marked(getattr(moe, fn_name), region))


def _by_region(prof) -> dict:
    """Device ms of every kernel by the innermost REGIONS range its host op
    ran in, or, for a backward op, by the range of the forward op whose
    autograd node (the same sequence number) it runs ("<region>:backward";
    "other" outside them), and by the kernel's class."""
    names = set(REGIONS.values())
    events = prof.events()

    def region_of(evt):
        while evt is not None:
            if evt.name in names:
                return evt.name
            evt = evt.cpu_parent
        return None

    seq_region = {}
    for evt in events:
        seq = getattr(evt, "sequence_nr", -1)
        if seq is not None and seq >= 0 and "Backward" not in evt.name:
            region = region_of(evt)
            if region is not None:
                seq_region.setdefault(seq, region)
    out: dict[str, dict[str, float]] = {}
    for evt in events:
        kernels = getattr(evt, "kernels", None)
        if not kernels:
            continue
        region, parent = region_of(evt), evt
        while region is None and parent is not None:
            seq = getattr(parent, "sequence_nr", -1)
            if "Backward" in parent.name and seq is not None and seq in seq_region:
                region = seq_region[seq] + ":backward"
            parent = parent.cpu_parent
        cls = out.setdefault(region or "other", {})
        for k in kernels:
            key = _kernel_class(k.name)
            cls[key] = cls.get(key, 0.0) + k.duration / 1e3
    return out


ARCHS = ("yi-6b", "mamba2-2.7b", "recurrentgemma-9b", "gemma2-2b", "qwen2-7b", "qwen3-moe-30b-a3b", "pixtral-12b",
         "whisper-tiny")
REMAT = ("none", "block", "full")


def _remat_modes(text: str) -> list[str]:
    modes = text.split(",")
    if not modes or any(m not in REMAT for m in modes):
        raise argparse.ArgumentTypeError(f"--remat takes a comma list of {REMAT}, got {text!r}")
    return modes


def _summary(prof, wall_s: float, steps: int, moe: bool) -> dict:
    """One profiled window: the host-clock step time, the device time by
    phase and by kernel class, the busy and idle share and the top kernels
    (and an MoE's ``by_region_ms``)."""
    events = prof.key_averages()
    kernels = [
        e for e in events
        if str(e.device_type).endswith("CUDA") and _device_us(e) > 0 and not e.key.startswith("phase:")
        and e.key not in REGIONS.values()
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
    out = {
        "wall_ms": wall_s * 1e3, "step_ms": wall_s * 1e3 / steps,
        "device_busy_ms": busy_us / 1e3, "device_idle_share": 1.0 - busy_us / 1e3 / (wall_s * 1e3),
        "phases": phases,
        "by_class_ms": {k: v / 1e3 for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])},
        "top_kernels": [
            {"name": e.key[:120], "calls": e.count, "device_ms": _device_us(e) / 1e3} for e in top
        ],
    }
    if moe:
        out["by_region_ms"] = _by_region(prof)
    return out


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="yi-6b")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--opt", choices=("adamw", "adamw8bit"), default="adamw")
    ap.add_argument("--remat", type=_remat_modes, default=["none"])
    args = ap.parse_args()
    if args.layers is None:
        args.layers = {chip_smoke.MOE: chip_smoke.MOE_TRAIN_LAYERS, chip_smoke.PIXTRAL: chip_smoke.PIXTRAL_TRAIN_LAYERS,
                       chip_smoke.WHISPER: chip_smoke.WHISPER_LAYERS}.get(args.arch, chip_smoke.TRAIN_LAYERS)
    if not torch.cuda.is_available():
        print("torch_profile_training: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy
    from repro_torch.train import adamw, adamw8bit, cosine_schedule
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten

    card = chip_smoke.card_line()
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get(args.arch), n_layers=args.layers)
    model = StreamModel(cfg, Policy(), device="cuda", generator=chip_smoke.SEED)
    params = model.param_tree()
    for p in tree_leaves(params):
        p.requires_grad_(True)
    make_opt = {"adamw": adamw, "adamw8bit": adamw8bit}[args.opt]
    opt = make_opt(cosine_schedule(3e-4, chip_smoke.TRAIN_WARMUP, chip_smoke.TRAIN_STEPS))
    state = opt.init(params)
    seq = chip_smoke.WHISPER_CTX if cfg.enc_dec else chip_smoke.TRAIN_SEQ
    # in turns (none, full, full, none for two modes): each mode's windows
    # spread over the run alike
    turns = args.remat + args.remat[::-1] if len(args.remat) > 1 else args.remat
    n_batches = 2 + len(turns) * (1 + args.steps)
    corpus = chip_smoke.load_example("torch_train_lm").synth_corpus(
        max(chip_smoke.TRAIN_SEQS, n_batches * chip_smoke.TRAIN_BATCH), cfg.vocab, seq=seq, seed=chip_smoke.SEED)
    b = chip_smoke.TRAIN_BATCH
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 9)
    batches = []
    for i in range(n_batches):
        batch = {"tokens": torch.from_numpy(np.ascontiguousarray(corpus[i * b:(i + 1) * b])).cuda()}
        if cfg.frontend == "patches":  # chip_smoke.phase_train's seeded patch embeddings
            batch["patch_embeds"] = torch.randn((b, cfg.frontend_len, cfg.d_model), generator=gen,
                                                device="cuda").to(torch.bfloat16)
        if cfg.enc_dec:  # and its seeded frame embeddings
            batch["frames"] = torch.randn((b, cfg.enc_seq, cfg.d_model), generator=gen,
                                          device="cuda").to(torch.bfloat16)
        batches.append(batch)
    if cfg.moe is not None:
        _mark_regions()

    def step(batch):
        with record_function("phase:forward"):
            loss, _ = model.loss(params, batch)
        with record_function("phase:backward"):
            grads = tree_unflatten(params, torch.autograd.grad(loss, tree_leaves(params)))
        with record_function("phase:optimizer"):
            opt.update(grads, state, params)
        return float(loss.detach())

    it = iter(batches)
    for _ in range(2):
        step(next(it))
    windows = []
    for mode in turns:
        model.policy = dataclasses.replace(model.policy, remat=mode)
        step(next(it))  # one step of this mode before its window
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            losses = [step(next(it)) for _ in range(args.steps)]
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        window = {"remat": mode, "losses": losses, "peak_bytes": torch.cuda.max_memory_allocated(),
                  **_summary(prof, wall_s, args.steps, cfg.moe is not None)}
        windows.append(window)
        print(f"[{card}] remat {mode}: step {window['step_ms']:.3f} ms, busy {window['device_busy_ms']:.3f} ms, "
              f"peak {window['peak_bytes']} bytes, phases {json.dumps(window['phases'])}", flush=True)
    by_mode = {}
    for mode in args.remat:
        ws = [w for w in windows if w["remat"] == mode]
        by_mode[mode] = {
            "step_ms": [w["step_ms"] for w in ws], "device_busy_ms": [w["device_busy_ms"] for w in ws],
            "peak_bytes": max(w["peak_bytes"] for w in ws),
            "phase_device_ms": {k: [w["phases"][k]["device_span_ms"] for w in ws] for k in ws[0]["phases"]},
            # autograd runs the backward on its own thread, outside the
            # phase:backward range: its device time is the busy time less
            # the forward's and the optimizer's
            "backward_device_ms": [w["device_busy_ms"] - w["phases"]["phase:forward"]["device_span_ms"]
                                   - w["phases"]["phase:optimizer"]["device_span_ms"] for w in ws],
        }
    summary = {
        "card": card, "arch": args.arch, "layers": cfg.n_layers, "optimizer": args.opt, "batch": b, "seq": seq,
        "steps": args.steps, "turns": turns, "by_remat": by_mode,
        **(windows[0] if len(windows) == 1 else {"windows": windows}),
    }
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    default = (args.layers, args.opt) == (chip_smoke.TRAIN_LAYERS, "adamw")
    stem = "profile_training" if default else f"profile_training_{args.layers}_{args.opt}"
    if args.arch != "yi-6b":
        stem = f"profile_training_{args.arch}_{args.layers}_{args.opt}"
    if args.remat != ["none"]:
        stem += "_remat-" + "-".join(args.remat)
    (out / f"{stem}.json").write_text(json.dumps(summary, indent=1))
    events = prof.key_averages()  # the last window's table
    (out / f"{stem}.txt").write_text(
        events.table(
            sort_by="self_device_time_total" if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total",
            row_limit=60, max_name_column_width=100,
        )
    )
    print(f"[{card}]")
    print(json.dumps({k: v for k, v in summary.items() if k != "windows"}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
