"""The whole training step's share of the chip's peak, %: the model
operations of a step (the configuration module's ``step_flops`` from its
configuration's shapes, nothing recomputed) times the window's steps,
over the window's time, over 989 TFLOP/s (bf16 dense) a chip."""

from bench.work import PEAK_FLOPS


def read(ctx: dict):
    if "step_flops" not in ctx or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["step_flops"] * ctx["steps"] / ctx["window_s"] / (PEAK_FLOPS["bfloat16"] * ctx["chips"])
