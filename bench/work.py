"""The yardstick's arithmetic: the card's peaks, the work of each kernel
at its call's shapes (a frozen copy of the formulas of
``src/repro_torch/kernels/cost.py``). A configuration's own module
(``bench/configs/<config>.py``) counts its step's model operations and
lists its kernels' calls with these.

Peaks are NVIDIA's data sheet for the H100 SXM, dense: 989 TFLOP/s in
bf16 on the tensor cores, 67 TFLOP/s in f32 on the CUDA cores, 3.35 TB/s
of HBM. A kernel's bound is max(bytes / HBM rate, operations / peak);
its roofline share is that bound over its measured time.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
OPT8_OPS = 39  # the 8-bit update's operations an element (cost.py's count)


class Work(NamedTuple):
    flops: int
    bytes: int


def bound_s(work: Work, dtype: str) -> float:
    """The least time the card could take for ``work``, in seconds."""
    return max(work.bytes / HBM_BYTES_PER_S, work.flops / PEAK_FLOPS[dtype])


def _elem(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def mask_pairs(s: int, causal: bool, window: int | None = None) -> int:
    """(query, key) pairs the mask lets through, s queries over s keys."""
    q = np.arange(s)
    hi = q if causal else np.full(s, s - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(s, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_work(b, h, kv, s, d, dtype: str, causal: bool = True, window: int | None = None) -> Work:
    """K1 forward: QK^T and PV, 4 D a pair and head; q, k, v read and o
    written once."""
    pairs = b * h * mask_pairs(s, causal, window)
    return Work(4 * d * pairs, _elem(dtype) * b * d * (2 * h * s + 2 * kv * s))


def attention_bwd_work(b, h, kv, s, d, dtype: str, causal: bool = True, window: int | None = None) -> Work:
    """K1 backward: 10 D a pair and head; q, k, v, o, do and lse read,
    dq, dk, dv written once."""
    e = _elem(dtype)
    pairs = b * h * mask_pairs(s, causal, window)
    nbytes = e * b * d * (3 * h * s + 2 * kv * s) + e * b * d * (h * s + 2 * kv * s) + 4 * b * h * s
    return Work(10 * d * pairs, nbytes)


def _chunk_lens(s: int, chunk: int) -> list[int]:
    q = min(chunk, s)
    return [min(q, s - c0) for c0 in range(0, s, q)]


def ssd_work(b, h, g, s, p, n, chunk, dtype: str, state: bool = False) -> Work:
    """K2 forward: per (batch, head) a causal pair within a chunk costs
    2N + 2P, a chunk of length L 4 L N P; x, B, C, dt read and y written
    once, the states when given."""
    nbytes = _elem(dtype) * b * s * (2 * h * p + 2 * g * n) + 4 * b * s * h + 4 * b * h * n * p * (2 if state else 1)
    per_head = sum(ln * (ln + 1) // 2 * (2 * n + 2 * p) + 4 * ln * n * p for ln in _chunk_lens(s, chunk))
    return Work(b * h * per_head, nbytes)


def ssd_bwd_work(b, h, g, s, p, n, chunk, dtype: str, state: bool = False) -> Work:
    """K2 backward: a causal pair within a chunk 6N + 4P, a chunk 10 L N
    P; x, dy read, dx written, B, C read and dB, dC written, dt read and
    ddt written, A read and dA written."""
    nbytes = _elem(dtype) * b * s * (3 * h * p + 4 * g * n) + 8 * b * s * h + 8 * h
    if state:
        nbytes += 12 * b * h * n * p
    per_head = sum(ln * (ln + 1) // 2 * (6 * n + 4 * p) + 10 * ln * n * p for ln in _chunk_lens(s, chunk))
    return Work(b * h * per_head, nbytes)


def opt8_bytes(numel: int, last: int, element_size: int) -> int:
    """The 8-bit update of a leaf: p read and written, g read, the m and v
    codes read and written, each 256-block's m scale and v pair read and
    written."""
    n_blocks = numel // last * (-(-last // 256))
    return numel * (3 * element_size + 4) + n_blocks * 2 * (4 + 8)


def opt8_step_work(leaves: list[tuple[tuple, int]]) -> Work:
    """One step of the 8-bit update and the global norm over ``leaves``
    ((shape, element size) each): the update's bytes and OPT8_OPS an
    element, the norm's gradient read once and 2 operations an element."""
    numel = [int(np.prod(s)) for s, _ in leaves]
    upd = sum(opt8_bytes(n, s[-1], e) for n, (s, e) in zip(numel, leaves))
    norm = sum(n * e for n, (_, e) in zip(numel, leaves))
    return Work(OPT8_OPS * sum(numel) + 2 * sum(numel), upd + norm)


def calls_bound_s(calls: list[tuple[int, dict]], fwd, bwd) -> float:
    """The least time of a step's ``calls`` of one kernel, forward
    (``fwd``'s work) and backward (``bwd``'s): (count, keyword arguments
    of the work functions) each, at the peak of the call's ``dtype``."""
    return sum(n * (bound_s(fwd(**kw), kw["dtype"]) + bound_s(bwd(**kw), kw["dtype"])) for n, kw in calls)
