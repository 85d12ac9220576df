#!/usr/bin/env python3
"""Time K1 (flash attention), K2 (SSD scan) or K3 (RG-LRU scan) of two checkouts on one card, in turns.

    mkdir -p build/ab_parent && git archive <parent commit> | tar -x -C build/ab_parent
    python3 scripts/torch_kernel_ab.py --parent build/ab_parent [--kernel attention|ssd|rglru] [--ablate] [--rounds N]

``--parent`` is another checkout of the repository, unpacked in a
directory that .gitignore lists. Each round runs the parent, this
checkout, this checkout again and the parent, each in a fresh process
that imports ``repro_torch`` from its own ``src/`` and builds its own
kernels, and hands that checkout's wrapper to this checkout's
``chip_smoke.check_attention``, ``check_ssd`` or ``check_rglru``, which holds
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
- K3 (``--kernel rglru``, f32): recurrentgemma-9b's wave, (4, 3000, 4096)
  with the model's decays and a random h0 (the stricter check of the
  carry) and again with the zero h0 the cache hands it, and the
  teacher-forced forward's (1, 3015, 4096) with no h0; then
  ``chip_smoke.RGLRU_SWEEP``'s and ``RGLRU_EDGES``'s shapes with the
  tests' decays and a random h0: every K3 call that ``chip_smoke.py``
  checks (a variant of ``--ablate``: the path's random-h0 and forward
  calls). Each row also carries ``flushed_ms``, the mean of 20 calls each
  timed alone by CUDA events after 256 MB were written to evict the 50 MB
  L2 (at B 1 the inputs are 99 MB and a back-to-back call finds part of
  them in L2), and ``kernel_vs_f64_el_err``, the largest error against
  the float64 run relative to the check's tolerance.

``--ablate`` adds, in the same turns, this checkout's kernel built with
each of its refinements switched off (the named constants in the
kernel's source set to false in a copy of ``src/`` under
``build/ab_variants/``): for K1 ``OVERLAP`` and ``PINGPONG``, and one
consumer warpgroup (64-row query tiles) instead of two; for K2
``SPLIT_XD`` (the state update's decayed xdt as one bf16 operand instead
of hi + lo), ``FAST_DECAY``, ``STATE_BF16``, ``P1_ROWS`` (the whole
chunk at once), ``P1_BLOCKS`` (no register cap), ``OUT_WARPGROUPS`` (two)
and ``HEADS_PER_BLOCK`` (one); for K3 ``PREFETCH``, ``FAST_EXP`` and
``FAST_SQRT``, 8 warps a block (``WARPS``: time blocks of 128 steps, two
blocks an SM) and 32 warps of 8 steps (``STEPS``: 1024 threads a block).

Prints each process's rows, then a summary (per side, the median over
its processes, and the change over the parent, over SDPA and the bound
over the change) beside the card's name and power limit; writes both to
``kernel_ab.json`` in the output directory (``kernel_ab_ssd.json`` for
K2, ``kernel_ab_rglru.json`` for K3). Needs a CUDA card.
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
    "ssd": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "rglru": "src/repro_torch/kernels/csrc/rglru_scan.cu",
}
# each variant: the lines of the kernel's source it changes, old -> new (each old line must occur once)
VARIANTS = {
    "attention": {
        "no_overlap": [("constexpr bool OVERLAP = true;", "constexpr bool OVERLAP = false;")],
        "no_pingpong": [("constexpr bool PINGPONG = true;", "constexpr bool PINGPONG = false;")],
        "rows_64": [("static constexpr int CONSUMERS = 2;", "static constexpr int CONSUMERS = 1;")],
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
    "rglru": {
        "no_prefetch": [("constexpr bool PREFETCH = true;", "constexpr bool PREFETCH = false;")],
        "no_fast_exp": [("constexpr bool FAST_EXP = true;", "constexpr bool FAST_EXP = false;")],
        "no_fast_sqrt": [("constexpr bool FAST_SQRT = true;", "constexpr bool FAST_SQRT = false;")],
        "warps_8": [("constexpr int WARPS = 16;", "constexpr int WARPS = 8;")],
        "warps_32_steps_8": [("constexpr int WARPS = 16;", "constexpr int WARPS = 32;"),
                             ("constexpr int STEPS = 16;", "constexpr int STEPS = 8;")],
    },
}
TIMES = ("ms", "graph_ms", "flushed_ms", "library_ms", "library_graph_ms")
ERRORS = ("el_err_state", "kernel_vs_f64_el_err")


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


def rglru_calls():
    """K3's calls that chip_smoke.py checks: its path's, then its sweep and
    edges; each (b, s, c, h0, model decays)."""
    b, s = cs.WAVE_REQUESTS, cs.RG_PROMPT_LEN
    calls = [
        (f"recurrentgemma-9b serving ({b},{s},4096) h0 random", (b, s, 4096, "random", True)),
        (f"recurrentgemma-9b forward (1,{s + cs.MAX_NEW - 1},4096) no h0", (1, s + cs.MAX_NEW - 1, 4096, None, True)),
        (f"recurrentgemma-9b serving ({b},{s},4096) h0 zero", (b, s, 4096, "zero", True)),
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


def measure(root: Path, label: str, kernel: str) -> dict:
    """Check and time one checkout's K1, K2 or K3 (this process imports its ``src``)."""
    if kernel == "ssd":
        return measure_ssd(root, label)
    if kernel == "rglru":
        return measure_rglru(root, label)
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
            per_kernel = [r["calls"].get(key, {}).get("kernel_us", {}) for r in runs if r["label"] == label]
            entry[f"{label}_kernel_us_median"] = {
                name: med([d.get(name) for d in per_kernel]) for name in sorted({n for d in per_kernel for n in d})
            }
        for t in ("ms", "graph_ms"):
            lib = entry[f"change_library_{t}_median"]
            for label in labels:
                x = entry[f"{label}_{t}_median"]
                if x is None:
                    continue
                entry[f"{label}_over_parent_{t}"] = x / entry[f"parent_{t}_median"]
                entry[f"{label}_over_library_{t}"] = x / lib if lib else None
                entry[f"bound_over_{label}_{t}"] = row["bound_ms"] / x
        summary[key] = entry
    return summary


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="another checkout, timed against this one")
    ap.add_argument("--kernel", choices=sorted(SOURCES), default="attention")
    ap.add_argument("--ablate", action="store_true", help="also time the kernel without each refinement")
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
    if args.ablate:
        sides += [(name, make_variant(args.kernel, name)) for name in VARIANTS[args.kernel]]
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
        cols = "  ".join(f"{label} {e[f'{label}_ms_median']:.4f} ({e[f'{label}_graph_ms_median']:.4f})"
                         for label in present)
        if args.kernel == "attention":
            cols += f"  SDPA {e['change_library_ms_median']:.4f} ({e['change_library_graph_ms_median']:.4f})"
        elif args.kernel == "rglru":
            cols += "  flushed " + " ".join(f"{label} {e[f'{label}_flushed_ms_median']:.4f}" for label in present)
            cols += "  el_err " + " ".join(f"{label} {e[f'{label}_kernel_vs_f64_el_err_median']:.3g}" for label in present)
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
