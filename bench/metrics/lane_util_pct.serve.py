"""The engine's lane utilization over the window, %:
``ContinuousLMEngine``'s useful decode lanes over the lanes it ran
(``useful_steps / lane_steps``, their growth from the window's start to
its close)."""


def read(ctx: dict):
    lanes = ctx.get("lane_steps")
    return None if not lanes else 100.0 * ctx["useful_steps"] / lanes
