"""The share of the traced training steps in which no operation ran on
the device, %, from the profiler's trace."""


def read(ctx: dict):
    tr = ctx.get("trace")
    if tr is None or "traced_steps" not in ctx or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
