"""The 95th percentile, over every request due in the window, of the
time from a request's due time to its first token (the engine's
``first_token_s``, ``time.perf_counter``), ms; a request with no first
token counts as infinitely late."""

import math

from bench.harness import percentile


def read(ctx: dict):
    ttft = ctx.get("ttft_s")
    if not ttft:
        return None
    p95 = percentile(ttft, 95)
    return p95 * 1e3 if math.isfinite(p95) else None
