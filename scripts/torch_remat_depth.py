#!/usr/bin/env python3
"""How deep a model of the zoo trains on one card under activation recomputation.

    python3 scripts/torch_remat_depth.py [--arch pixtral-12b] [--depths 34,35,36,37]
        [--remat full|block|none] [--expandable]

On a machine with one CUDA card. Builds the kernels, then runs
chip_smoke.py's training workload (``phase_train``: full-width ``--arch``
from a stream, ``adamw8bit``, 8 steps of 4 x 1024 tokens, its gates) at
each of ``--depths`` in turn, ascending, under ``Policy(remat=--remat)``,
and stops at the first depth that runs out of device memory. With
``--expandable`` the caching allocator takes expandable segments for the
whole run. Prints each depth's median step ms, tokens/s and peak
allocated and reserved bytes, or the out-of-memory message (what the
allocator held), and writes them to
``chiprun_out/remat_depth_<arch>_<remat>[_expandable].json``. Exits
non-zero with no CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=chip_smoke.PIXTRAL)
    ap.add_argument("--depths", default="34,35,36,37")
    ap.add_argument("--remat", choices=("none", "block", "full"), default="full")
    ap.add_argument("--expandable", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_remat_depth: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import adamw8bit, flash_attention, grad_norm, rglru_scan, ssd_scan

    kernels = {"flash_attention": flash_attention, "ssd_scan": ssd_scan, "rglru_scan": rglru_scan,
               "adamw8bit": adamw8bit, "grad_norm": grad_norm}
    card = chip_smoke.card_line()
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.expandable:
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    rows = []
    for depth in sorted(int(d) for d in args.depths.split(",")):
        try:
            out, _ = chip_smoke.phase_train(card, kernels, arch=args.arch, layers=depth, opt_name="adamw8bit",
                                            remat=args.remat)
            row = {"layers": depth, "ok": True, "median_step_ms": out["median_step_ms"],
                   "step_ms": out["step_ms"], "tokens_per_s": out["tokens_per_s"], "peak_bytes": out["peak_bytes"],
                   "peak_reserved_bytes": out["peak_reserved_bytes"], "losses": out["losses"]}
        except torch.OutOfMemoryError as e:
            row = {"layers": depth, "ok": False, "error": str(e).splitlines()[0]}
        rows.append(row)
        print(f"[{card}] {args.arch} remat {args.remat}{' expandable' if args.expandable else ''} "
              f"{json.dumps({k: v for k, v in row.items() if k not in ('step_ms', 'losses')})}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        if not row["ok"]:
            break
    summary = {"card": card, "arch": args.arch, "remat": args.remat, "expandable_segments": args.expandable,
               "rows": rows, "deepest": max((r["layers"] for r in rows if r["ok"]), default=None)}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    name = f"remat_depth_{args.arch}_{args.remat}{'_expandable' if args.expandable else ''}.json"
    (out_dir / name).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
