"""Run one cell of the benchmark once:

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the chips the cell asks
for. It prints, last on standard output, one JSON line: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number the run compared beside its limit, which also close standard
error. Without a card, or with fewer than the cell asks for, or with
JAX or the JAX package loaded once the window has closed, it exits with
another code than 0 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up runs from the start of the process

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """Caches at fixed paths inside the checkout; no JAX pulled in by a library."""
    cache = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from bench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found {found}", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the program; fails here in a tree without it)

    out = harness.driver(cell).run(cell, args.seed, args.seconds, bool(args.trace), T0, device="cuda")
    held = harness.forbidden_modules()
    if held:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(held)}", file=sys.stderr)
        return 3

    breakdown = None
    if args.trace:
        ctx = out["ctx"]
        metrics = {}
        for m in cell.per_layer:
            value = harness.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tr = ctx.get("trace")
        if tr is None:  # nothing was traced (a serving window that left no request open at its close)
            print("no device trace was taken", file=sys.stderr)
            device_extra, breakdown = {"busy_s": 0.0, "window_s": 0.0}, {"device_ops": [], "idle_gaps": []}
        else:
            device_extra = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
            breakdown = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
        device_extra = {}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"], **device_extra}
    print(json.dumps({"readings": out["readings"]}), file=sys.stderr)
    for c in out["checks"]:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}){'' if c.ok else ' FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(correct=out["correct"], attempted=out["attempted"], failed=out["failed"],
                              metrics=metrics, device=device, checks=out["checks"], breakdown=breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
