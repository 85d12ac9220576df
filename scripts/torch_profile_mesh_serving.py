#!/usr/bin/env python3
"""Where a decode step's time goes when the port serves on a device mesh.

    python3 scripts/torch_profile_mesh_serving.py                       # gemma2-2b, (1, n)
    python3 scripts/torch_profile_mesh_serving.py --arch mistral-large-123b --layers 22

On a machine with n CUDA cards (n > 1): the kernels built first, then one NCCL rank a card, spawned
and meeting through a FileStore in a temporary directory, joined by a
deadline. Each rank builds the full-width model (cut to ``--layers``,
bf16, random weights from chip_smoke's seed) on a (1, n) mesh, prefills
one ``--prompt``-token prompt and then, for ``--steps`` decode steps
each: times the steps on the host clock (synchronised); counts the
operations that synchronise the host with the card inside a step
(``torch.cuda.set_sync_debug_mode``); times one all-reduce of a (1, 1,
d_model) bf16 tensor over the model axis, the size of a layer's
row-parallel sum in decode, launched back to back and each waited on;
and profiles the steps under ``torch.profiler`` (rank 0): the device's
busy and idle share of the wall time, the NCCL kernels' time and the
rest by kernel. Writes ``chiprun_out/profile_mesh_serving_<arch>.json``.
Exits non-zero with fewer than two cards.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import shutil
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)

DEADLINE_S = 900.0


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0))


def rank_main(rank: int, world: int, store: str, args: argparse.Namespace, out_dir: str) -> None:
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.launch import make_mesh
    from repro_torch.models import sharding as SH
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy

    torch.cuda.set_device(rank)
    dev = f"cuda:{rank}"
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store, "store"), world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=DEADLINE_S),
                            device_id=torch.device(dev))
    mesh = make_mesh((1, world), ("data", "model"), device=dev)
    cfg = configs.get(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = StreamModel(cfg, Policy.for_mesh(mesh, seq_axis=args.seq_axis), generator=chip_smoke.SEED, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 1)
    prompt = torch.randint(0, cfg.vocab, (1, args.prompt), generator=gen, device=dev)
    logits, cache = model.prefill(prompt, args.prompt + 3 * args.steps + 2)
    tok = logits.argmax(-1)[:, None]

    def steps(n):
        nonlocal tok, cache
        for _ in range(n):
            lg, cache = model.decode_step(cache, tok)
            tok = lg[:, 0].argmax(-1)[:, None]

    steps(2)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(args.steps)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        steps(1)
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message)[:200] for w in seen if "synchroniz" in str(w.message).lower()]

    x = torch.ones((1, 1, cfg.d_model), dtype=torch.bfloat16, device=dev)
    SH.all_reduce(x, mesh, "model")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        SH.all_reduce(x, mesh, "model")
    torch.cuda.synchronize()
    ar_back_to_back_ms = (time.perf_counter() - t0) * 10.0
    t0 = time.perf_counter()
    for _ in range(100):
        SH.all_reduce(x, mesh, "model")
        torch.cuda.synchronize()
    ar_waited_ms = (time.perf_counter() - t0) * 10.0

    out = {"rank": rank, "world": world, "arch": cfg.name, "layers": cfg.n_layers, "prompt": args.prompt,
           "seq_axis": args.seq_axis, "step_ms": step_ms, "syncs_in_a_step": len(syncs), "sync_examples": syncs[:5],
           "all_reduce_ms": {"back_to_back": ar_back_to_back_ms, "each_waited": ar_waited_ms}}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(args.steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if rank == 0:
        kernels = {}
        for evt in prof.key_averages():
            us = _device_us(evt)
            # "nccl:..." are NCCL's own annotations over its kernels: counted once, as kernels
            if us > 0 and str(evt.device_type).endswith("CUDA") and not evt.key.startswith("nccl:"):
                kernels[evt.key] = kernels.get(evt.key, 0.0) + us
        busy_us = sum(kernels.values())
        nccl_us = sum(v for k, v in kernels.items() if "nccl" in k.lower())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
        out["profile"] = {"steps": args.steps, "wall_ms": wall_ms, "busy_ms": busy_us / 1e3,
                          "idle_share": 1.0 - busy_us / 1e3 / wall_ms, "nccl_ms": nccl_us / 1e3,
                          "top_kernels_ms": [(k[:120], v / 1e3) for k, v in top]}
    dist.barrier()
    dist.destroy_process_group()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--layers", type=int, default=0, help="cut to this depth (0: the config's)")
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seq-axis", default=None)
    args = ap.parse_args()
    world = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world < 2:
        print("profile_mesh_serving: needs two or more CUDA cards", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    card = chip_smoke.card_line()
    print(f"card: {card} x {world}; build {_build.build_all():.1f} s", flush=True)
    store, out_dir = tempfile.mkdtemp(prefix="mesh_store_"), tempfile.mkdtemp(prefix="mesh_out_")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, world, store, args, out_dir)) for r in range(world)]
    try:
        for p in procs:
            p.start()
        end = time.monotonic() + DEADLINE_S
        for p in procs:
            p.join(max(end - time.monotonic(), 0.1))
        ranks = [json.loads((Path(out_dir) / f"rank{r}.json").read_text()) if (Path(out_dir) / f"rank{r}.json").exists()
                 else {"rank": r, "error": "no result"} for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store, ignore_errors=True)
        shutil.rmtree(out_dir, ignore_errors=True)
    for r in ranks:
        print(json.dumps(r), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / f"profile_mesh_serving_{args.arch}.json").write_text(
        json.dumps({"card": card, "ranks": ranks}, indent=1))
    return 0 if all("error" not in r for r in ranks) else 1


if __name__ == "__main__":
    sys.exit(main())
