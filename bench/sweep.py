"""The serving cell's knee: the open loop of a serving cell at each of a
few rates and seeds, one window each, a process each:

    python3 bench/sweep.py --workload <name> --rates <r> [<r> ...] --seeds <n> [<n> ...] --seconds <s>

For each rate and seed it prints one JSON line: the requests due, those
answered within the window, the time past the close until the last is
answered (``tail_s``), the latency's median and 95th percentile, and
the backlog (due and not yet answered) at every ``backlog_every_s`` of
the window, read from the due and answer times. The knee is the highest
rate whose backlog does not grow over the window on any seed; the
cell's traffic file keeps the rate chosen from it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def one(workload: str, rate: float, seconds: float, seed: int) -> dict:
    import time

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness

    t0 = time.perf_counter()
    cell = harness.load_cell(workload)
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "rate_per_s": rate, "sample": 1})
    out = harness.driver(cell).run(cell, seed, seconds, False, t0, device="cuda")
    return {"rate_per_s": rate, "seed": seed, **out["metrics"],
            **{k: v for k, v in out["readings"].items() if k != "gaps"}}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--one", type=float, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(one(args.workload, args.one, args.seconds, args.seeds[0])), flush=True)
        return 0
    for rate in args.rates:
        for seed in args.seeds:  # a process a run: each holds the card alone
            cmd = [sys.executable, __file__, "--workload", args.workload, "--rates", str(rate), "--seeds", str(seed),
                   "--seconds", str(args.seconds), "--one", str(rate)]
            res = subprocess.run(cmd, capture_output=True, text=True, check=False)
            lines = res.stdout.strip().splitlines()
            print(lines[-1] if res.returncode == 0 and lines else json.dumps(
                {"rate_per_s": rate, "seed": seed, "rc": res.returncode, "err": res.stderr[-800:]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
