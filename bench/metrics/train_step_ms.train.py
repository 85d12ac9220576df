"""The mean time of a window's training step, ms, from the program's own
``train_step_seconds`` histogram (``TrainingJob.run``: the host clock
over the feed's wait, the step and the loss's sync), read from a
``MetricsRegistry`` on the log: its sum and count over the window's
steps. (The histogram's percentiles are bucket bounds a factor of 2
apart, so the mean is read.)"""


def read(ctx: dict):
    s = ctx.get("train_step_s")
    return None if s is None else s * 1e3
