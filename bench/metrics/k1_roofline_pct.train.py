"""K1's share of its roofline on a training step, %: the forward's and
the backward's bound at each of the step's attention calls (the
configuration module's ``kernel_calls``), over the device time of K1's
kernels in the traced steps. K1's kernels are those of
``flash_attention.cu`` and ``flash_attention_bwd.cu``."""

from bench.work import attention_bwd_work, attention_work, calls_bound_s

KERNELS = (r"\b(flash_attention_bf16_kernel|flash_attention_f32_kernel|delta_kernel|dkdv_bf16_kernel"
           r"|dkdv_f32_kernel|dq_bf16_kernel|dq_f32_kernel|reduce_dkdv_kernel)\b")


def read(ctx: dict):
    calls = ctx.get("kernel_calls", {}).get("attention")
    if not calls or "trace" not in ctx:
        return None
    seconds, launches = ctx["trace"].time_of(KERNELS)
    if not launches:
        return None
    return 100.0 * calls_bound_s(calls, attention_work, attention_bwd_work) * ctx["traced_steps"] / seconds
