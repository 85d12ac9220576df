"""The optimizer's share of its roofline on a training step, %: the
8-bit update's and the global norm's bound over every leaf (their bytes
at 3.35 TB/s, which bind), once a step, over the device time of
``adamw8bit.cu``'s and ``grad_norm.cu``'s kernels in the traced steps."""

from bench.work import bound_s, opt8_step_work

KERNELS = r"\b(adamw8bit_kernel|sumsq_kernel|finish_kernel)\b"


def read(ctx: dict):
    if "opt8_leaves" not in ctx or "trace" not in ctx:
        return None
    seconds, launches = ctx["trace"].time_of(KERNELS)
    if not launches:
        return None
    return 100.0 * bound_s(opt8_step_work(ctx["opt8_leaves"]), "float32") * ctx["traced_steps"] / seconds
