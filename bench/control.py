"""The control and the faults of a cell, read on the chip at the cell's
own size (not part of the benchmark's runs):

    python3 bench/control.py --workload <name> --seeds <n> [<n> ...] [--seconds <s>]

For each seed, one run of the cell's driver (a short window) and, on the
same weights and inputs, the stand-ins put in the program's place, each
compared with the plain reference by the cell's own checks:

* training: the reference computed with every product's operands in
  float8 e4m3 (the control, a precision below the configuration's bf16),
  and the reference over half of each step's rows (the fault "half of
  the batch left out, the mean taken over the rest"); a step that
  leaves the state unchanged reads 1 on ``change_gap`` by its measure
  and needs no run;
* serving: at each sampled position the token the reference in fp8 puts
  first (the control), and one served token of each sampled request
  altered (the fault "a token altered where it is produced").

It prints one JSON line a seed: the program's readings and each
stand-in's, beside the limits of ``bench/limits/<cell>.json``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness

    cell = harness.load_cell(args.workload)
    drv = harness.driver(cell)
    train = cell.traffic["driver"] != "serve_rate"
    for seed in args.seeds:
        t0 = time.perf_counter()
        variants = (("fp8", False), ("f32", True)) if train else ("fp8", "token")
        out = drv.run(cell, seed, args.seconds, False, t0, device=args.device, variants=variants)
        row = {"seed": seed, "correct": out["correct"],
               "program": {c.name: c.value for c in out["checks"]},
               "limits": {c.name: c.limit for c in out["checks"]}}
        r = out["readings"]
        if train and "reference" in r:
            for key, tag in (("fp8", "control_fp8"), ("f32_half", "fault_half_batch")):
                row[tag] = {c.name: c.value for c in drv.compare(cell, r[key], r["reference"])}
            row["fault_unchanged"] = {"change_gap": 1.0}
        elif not train:
            row["control_fp8"] = {"greedy_gap": r["gaps"]["fp8"]}
            row["fault_token"] = {"greedy_gap": r["gaps"]["token"]}
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
