"""K2's share of its roofline on a training step, %: the SSD scan's
forward and backward bound at each of the step's calls (the
configuration module's ``kernel_calls``), over the device time of K2's
kernels in the traced steps. K2's kernels are those of ``ssd_scan.cu``
and ``ssd_scan_bwd.cu``."""

from bench.work import calls_bound_s, ssd_bwd_work, ssd_work

KERNELS = (r"\b(ssd_chunk_out_kernel|ssd_chunk_states_kernel|ssd_scan_f32_kernel|ssd_state_pass_kernel"
           r"|ssd_bwd_[a-z0-9_]*kernel)\b")


def read(ctx: dict):
    calls = ctx.get("kernel_calls", {}).get("ssd")
    if not calls or "trace" not in ctx:
        return None
    seconds, launches = ctx["trace"].time_of(KERNELS)
    if not launches:
        return None
    return 100.0 * calls_bound_s(calls, ssd_work, ssd_bwd_work) * ctx["traced_steps"] / seconds
