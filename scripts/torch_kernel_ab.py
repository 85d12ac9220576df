#!/usr/bin/env python3
"""Time K1 (flash attention) of two checkouts on one card, in turns.

    mkdir -p build/ab_parent && git archive <parent commit> | tar -x -C build/ab_parent
    python3 scripts/torch_kernel_ab.py --parent build/ab_parent [--ablate] [--rounds N]

``--parent`` is another checkout of the repository, unpacked in a
directory that .gitignore lists. Each round runs the parent, this
checkout, this checkout again and the parent, each in a fresh process
that imports ``repro_torch`` from its own ``src/`` and builds its own
kernels, and hands that checkout's wrapper to this checkout's
``chip_smoke.check_attention``, which holds the kernel against its plain
version and times it, the plain version and the library call
(``F.scaled_dot_product_attention`` on pre-repeated K/V; with a boolean
mask where there is a window) with CUDA events (``chip_smoke.time_ms``:
20 calls back to back after a warm-up, so a call's time includes the
wrapper's host time wherever that is the longer). Each process also
times 20 calls replayed from one CUDA graph (``graph_ms``), the
kernel's device time without the host's share. The calls are K1's on
the serving paths, bf16:

- yi-6b's four prefills, (1, S, 32/4, 128) causal at
  ``chip_smoke.PROMPT_LENS``;
- recurrentgemma-9b's wave, (4, 3000, 16/1, 256) causal, window 2048.

``--ablate`` adds, in the same turns, this checkout's kernel built with
each of its refinements switched off (the named constants ``OVERLAP``
and ``PINGPONG`` in ``csrc/flash_attention.cu`` set to false in a copy
of ``src/`` under ``build/ab_variants/``), and with one consumer
warpgroup (64-row query tiles) instead of two.

Prints each process's rows, then a summary (per side, the median over
its processes, and the change over the parent, over SDPA and the bound
over the change) beside the card's name and power limit; writes both to
``chiprun_out/kernel_ab.json``. Needs a CUDA card.
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

SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
# each variant: the lines of SOURCE it changes, old -> new (each old line must occur once)
VARIANTS = {
    "no_overlap": [("constexpr bool OVERLAP = true;", "constexpr bool OVERLAP = false;")],
    "no_pingpong": [("constexpr bool PINGPONG = true;", "constexpr bool PINGPONG = false;")],
    "rows_64": [("static constexpr int CONSUMERS = 2;", "static constexpr int CONSUMERS = 1;")],
}
TIMES = ("ms", "graph_ms", "library_ms", "library_graph_ms")


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


def measure(root: Path, label: str) -> dict:
    """Check and time one checkout's K1 (this process imports its ``src``)."""
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
    out: dict = {"label": label, "root": str(root), "ptxas": ptxas, "k1": {}}
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
        out["k1"][key] = row
    return out


def make_variant(name: str) -> Path:
    """A copy of this checkout's ``src/`` under ``build/ab_variants/<name>``
    with VARIANTS[name] applied to K1's source."""
    root = ROOT / "build" / "ab_variants" / name
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(ROOT / "src", root / "src", ignore=shutil.ignore_patterns("__pycache__"))
    path = root / SOURCE
    text = path.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} occurs {text.count(old)} times in {SOURCE}")
        text = text.replace(old, new)
    path.write_text(text)
    return root


def summarise(runs: list, labels: list) -> dict:
    def med(vals):
        vals = [v for v in vals if v is not None]
        return statistics.median(vals) if vals else None

    summary: dict = {}
    for key, row in runs[0]["k1"].items():
        entry = {"bound_ms": row["bound_ms"], "bound_by": row["bound_by"]}
        for label in labels:
            for t in TIMES:
                vals = [r["k1"][key].get(t) for r in runs if r["label"] == label]
                entry[f"{label}_{t}"] = vals
                entry[f"{label}_{t}_median"] = med(vals)
        for t in ("ms", "graph_ms"):
            lib = entry[f"change_library_{t}_median"]
            for label in labels:
                x = entry[f"{label}_{t}_median"]
                entry[f"{label}_over_parent_{t}"] = x / entry[f"parent_{t}_median"]
                entry[f"{label}_over_library_{t}"] = x / lib
                entry[f"bound_over_{label}_{t}"] = row["bound_ms"] / x
        summary[key] = entry
    return summary


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="another checkout, timed against this one")
    ap.add_argument("--ablate", action="store_true", help="also time the kernel without each refinement")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--label", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure is not None:
        print(json.dumps(measure(args.measure, args.label)), flush=True)
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
    if args.ablate:
        sides += [(name, make_variant(name)) for name in VARIANTS]
    order = [("parent", args.parent), *sides, *reversed(sides), ("parent", args.parent)]
    runs = []
    for rnd in range(args.rounds):
        for label, root in order:
            res = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--measure", str(root.resolve()), "--label", label],
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
    summary = {"card": card, "rounds": args.rounds, "k1": summarise(runs, labels)}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "kernel_ab.json").write_text(json.dumps({"summary": summary, "runs": runs}, indent=1))
    for key, e in summary["k1"].items():
        cols = "  ".join(f"{label} {e[f'{label}_ms_median']:.4f} ({e[f'{label}_graph_ms_median']:.4f})"
                         for label in labels)
        print(f"[{card}] {key}: ms (graph ms) {cols}  SDPA {e['change_library_ms_median']:.4f} "
              f"({e['change_library_graph_ms_median']:.4f})  bound {e['bound_ms']:.4f}", flush=True)
    print(json.dumps(summary), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
