"""The share of the traced engine ticks in which no operation ran on the
device, %, from the profiler's trace. The ticks are decode ticks of the
drain after the window's close (``bench/drivers/serve_rate.py``), not
the window's."""


def read(ctx: dict):
    tr = ctx.get("trace")
    if tr is None or "ttft_s" not in ctx or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
