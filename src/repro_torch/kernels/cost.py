"""The work of each kernel of the port: what its function must compute and
move, from its call's shapes alone.

Each ``*_work`` function returns a :class:`Work` (operations, bytes,
transcendentals) and each ``*_bound`` the least time the card could take
for it: max(bytes / the HBM rate, operations / the peak rate of their
type), in ms, with which of the two binds. ``chip_smoke.py`` prints these
bounds beside each kernel's time, and the kernels' meta-device branches
record the same work for the dry run (``launch/dryrun.py``), so the two
count the same thing.

Operations are the function's, not the kernel's: K1 counts 4 D a (query,
key) pair and head the mask lets through (QK^T and PV), its backward 10 D;
a recurrence counts its elementwise operations at the CUDA cores' f32 rate.
Bytes are each input read once and each output written once; scratch a
kernel writes and reads again is not the function's and is not counted.
Transcendentals are the exponentials, logarithms, tanh and square roots
the function evaluates, one an element they apply to.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = [
    "HBM_BYTES_PER_S", "OPT8_OPS", "PEAK_FLOPS", "Work", "attention_bound", "attention_bwd_bound",
    "attention_bwd_work", "attention_work", "bound", "dtype_name", "mask_pairs", "norm_bound", "norm_work", "opt8_bound",
    "opt8_bytes", "opt8_work", "record", "rglru_bound", "rglru_bwd_bound", "rglru_bwd_work", "rglru_work", "ssd_bound",
    "ssd_bwd_bound", "ssd_bwd_work", "ssd_work",
]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; f32 CUDA cores
# the 8-bit update's operations an element: dequantize m (1) and v (6: two
# adds, a product, exp2, a subtraction, a max), the m and v updates (3 + 4),
# u (7), p (2), requantize m (6) and v (10), each counted once
OPT8_OPS = 39


class Work(NamedTuple):
    flops: int
    bytes: int
    transcendentals: int = 0


def bound(work: Work, dtype: str) -> tuple[float, str]:
    """max(bytes / HBM rate, operations / the peak rate of ``dtype``) in
    ms, and "bytes" or "operations" for the one that binds."""
    t_bytes, t_ops = work.bytes / HBM_BYTES_PER_S, work.flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _elem(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def mask_pairs(s: int, causal: bool, window: int | None, sk: int | None = None, q_offset: int = 0) -> int:
    """(query, key) pairs the mask lets through, s queries at positions
    q_offset.. over ``sk`` keys (s where None; without a mask every query
    sees all sk): the work this input needs."""
    import numpy as np

    sk = s if sk is None else sk
    q = np.arange(s) + q_offset
    hi = np.minimum(q, sk - 1) if causal else np.full(s, sk - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(s, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


# ------------------------------------------------------------------ K1
def attention_work(b, h, kv, s, d, dtype: str, causal, window, sk: int | None = None, q_offset: int = 0,
                   softcap: bool = False) -> Work:
    """K1 forward: s queries (from position q_offset) over ``sk`` keys (s
    where None). Bytes: q, k, v read once, o written once. Operations:
    QK^T and PV, 4 D a pair the mask lets through and head. An exp a pair
    and head, and a tanh too under a softcap."""
    sk = s if sk is None else sk
    pairs = b * h * mask_pairs(s, causal, window, sk, q_offset)
    nbytes = _elem(dtype) * b * d * (2 * h * s + 2 * kv * sk)
    return Work(4 * d * pairs, nbytes, pairs * (2 if softcap else 1))


def attention_bound(b, h, kv, s, d, dtype: str, causal, window, sk: int | None = None,
                    q_offset: int = 0) -> tuple[float, str]:
    """Least time for the function: max(bytes / HBM rate, flops / peak);
    s queries (from position q_offset) over ``sk`` keys (s where None)."""
    return bound(attention_work(b, h, kv, s, d, dtype, causal, window, sk, q_offset), dtype)


def attention_bwd_work(b, h, kv, s, d, dtype: str, causal, window, sk: int | None = None, q_offset: int = 0,
                       softcap: bool = False) -> Work:
    """K1's backward. Operations: five products of 2 D a (query, key) pair
    and head (S and dP again, dV, dQ, dK), 10 D H an unmasked pair. Bytes:
    q, k, v, o, do and lse read once, dq, dk and dv written once; s
    queries over ``sk`` keys (s where None). P again: an exp a pair and
    head, and a tanh too under a softcap."""
    sk = s if sk is None else sk
    elem = _elem(dtype)
    pairs = b * h * mask_pairs(s, causal, window, sk, q_offset)
    nbytes = elem * b * d * (3 * h * s + 2 * kv * sk) + elem * b * d * (h * s + 2 * kv * sk) + 4 * b * h * s
    return Work(10 * d * pairs, nbytes, pairs * (2 if softcap else 1))


def attention_bwd_bound(b, h, kv, s, d, dtype: str, causal, window, sk: int | None = None,
                        q_offset: int = 0) -> tuple[float, str]:
    """Least time for K1's backward: max(bytes / HBM rate, operations /
    peak) of :func:`attention_bwd_work`."""
    return bound(attention_bwd_work(b, h, kv, s, d, dtype, causal, window, sk, q_offset), dtype)


# ------------------------------------------------------------------ K2
def _chunk_lens(s: int, chunk: int) -> list[int]:
    q = min(chunk, s)
    return [min(q, s - c0) for c0 in range(0, s, q)]


def ssd_work(b, h, g, s, p, n, chunk, dtype: str, state: bool) -> Work:
    """K2, the SSD scan. Bytes: x read and y written once (B S H P each, in
    the working dtype), B and C read once per group (B S G N each), dt
    read once (B S H f32), the initial state read (when given) and the
    final state written (B H N P f32 each). Operations per (batch, head):
    each causal pair (i, j) within a chunk costs 2N (C_i . B_j) + 2P (its
    share of y), and each chunk of length L costs 4 L N P (the carried
    state's share of y and the state update); the last chunk is ragged
    when chunk does not divide S. An exp a causal pair (the segment
    decay) and a position (its decay to the chunk's end)."""
    nbytes = _elem(dtype) * b * s * (2 * h * p + 2 * g * n) + 4 * b * s * h
    nbytes += 4 * b * h * n * p * (2 if state else 1)
    lens = _chunk_lens(s, chunk)
    per_head = sum(ln * (ln + 1) // 2 * (2 * n + 2 * p) + 4 * ln * n * p for ln in lens)
    exps = sum(ln * (ln + 1) // 2 + ln for ln in lens)
    return Work(b * h * per_head, nbytes, b * h * exps)


def ssd_bound(b, h, g, s, p, n, chunk, dtype: str, state: bool) -> tuple[float, str]:
    """Least time for the SSD scan at the card's peak for the working
    dtype (:func:`ssd_work`)."""
    return bound(ssd_work(b, h, g, s, p, n, chunk, dtype, state), dtype)


def ssd_bwd_work(b, h, g, s, p, n, chunk, dtype: str, state: bool) -> Work:
    """K2's backward. Bytes: x and dy read and dx written (B S H P each, in
    the working dtype), B and C read and dB and dC written (B S G N each),
    dt read and ddt written (B S H f32), A read and dA written; with a
    state, the initial state and d(final state) read and d(initial state)
    written (B H N P f32 each). Operations per (batch, head): each causal
    pair (i, j) within a chunk costs 6N + 4P (C_i . B_j, dy_i . u_j, and
    the pair's shares of dC, dB and du), each chunk of length L 10 L N P
    (its own state contribution and that of dy, and the state's shares of
    dC, du and dB). The forward's exps again."""
    nbytes = _elem(dtype) * b * s * (3 * h * p + 4 * g * n) + 8 * b * s * h + 8 * h
    if state:
        nbytes += 12 * b * h * n * p
    lens = _chunk_lens(s, chunk)
    per_head = sum(ln * (ln + 1) // 2 * (6 * n + 4 * p) + 10 * ln * n * p for ln in lens)
    exps = sum(ln * (ln + 1) // 2 + ln for ln in lens)
    return Work(b * h * per_head, nbytes, b * h * exps)


def ssd_bwd_bound(b, h, g, s, p, n, chunk, dtype: str, state: bool) -> tuple[float, str]:
    """Least time for K2's backward at the card's peak for the working
    dtype (:func:`ssd_bwd_work`)."""
    return bound(ssd_bwd_work(b, h, g, s, p, n, chunk, dtype, state), dtype)


# ------------------------------------------------------------------ K3
def rglru_work(b, s, c, h0: bool) -> Work:
    """K3, the RG-LRU scan. Bytes: x and log_a read and h written once (B S
    C f32 each), h0 read when given and h_last written (B C f32).
    Operations: 8 an element (two exps, the 1 - e, the max, the sqrt, the
    product with x, and the chain's multiply-add); of them 3
    transcendentals (two exps, the sqrt)."""
    return Work(8 * b * s * c, 4 * (3 * b * s * c + b * c * (2 if h0 else 1)), 3 * b * s * c)


def rglru_bound(b, s, c, h0: bool) -> tuple[float, str]:
    """Least time for the RG-LRU scan at the CUDA cores' f32 rate."""
    return bound(rglru_work(b, s, c, h0), "float32")


def rglru_bwd_work(b, s, c, h0: bool, dh_last: bool) -> Work:
    """K3's backward. Bytes: dh, x and log_a read, dx and dlog_a written (B
    S C f32 each), and h read as h_{t-1}: its first S - 1 rows, then h0
    when given; dh_last read and dh0 written when given (B C f32 each).
    Operations: 20 an element (two exps, the weight's expm1, clamp and
    sqrt, the chain's add and multiply twice, dx's product, dlog_a's five
    and its division); of them 4 transcendentals (two exps, the expm1,
    the sqrt)."""
    nbytes = 4 * b * c * (6 * s - 1 + (2 if h0 else 0) + (1 if dh_last else 0))
    return Work(20 * b * s * c, nbytes, 4 * b * s * c)


def rglru_bwd_bound(b, s, c, h0: bool, dh_last: bool) -> tuple[float, str]:
    """Least time for K3's backward at the CUDA cores' f32 rate."""
    return bound(rglru_bwd_work(b, s, c, h0, dh_last), "float32")


# ------------------------------------------------- the 8-bit update, the norm
def opt8_bytes(p) -> int:
    """Bytes the 8-bit update of leaf ``p`` must move: p read and written,
    g read, the m and v codes read and written, the m scale (4 bytes) and
    the v pair (8) of each 256-block read and written."""
    n_blocks = p.numel() // p.shape[-1] * (-(-p.shape[-1] // 256))
    return p.numel() * (3 * p.element_size() + 4) + n_blocks * 2 * (4 + 8)


def opt8_work(leaves: list) -> Work:
    """The 8-bit update of ``leaves`` (tensors, or anything with ``numel``,
    ``shape`` and ``element_size``): OPT8_OPS operations an element, the
    bytes of :func:`opt8_bytes`; v's log2 code and its exp2 back, and the
    square root of v, 3 transcendentals an element."""
    n = sum(p.numel() for p in leaves)
    return Work(OPT8_OPS * n, sum(opt8_bytes(p) for p in leaves), 3 * n)


def opt8_bound(leaves: list) -> tuple[float, str]:
    """Least time for the 8-bit update of ``leaves``: max(bytes / HBM rate,
    OPT8_OPS an element / the f32 rate)."""
    return bound(opt8_work(leaves), "float32")


def norm_work(grads: list) -> Work:
    """The global norm of ``grads``: each element read once, a product and
    a sum an element; one square root."""
    return Work(2 * sum(g.numel() for g in grads), sum(g.numel() * g.element_size() for g in grads), 1)


def norm_bound(grads: list) -> tuple[float, str]:
    """Least time for the global norm of ``grads``: max(each element read
    once / HBM rate, a product and a sum an element / the f32 rate)."""
    return bound(norm_work(grads), "float32")


# ------------------------------------------------- the dry run's meta calls
_SINKS: list = []  # the dry run's counting modes (launch/dryrun.py), innermost last


def record(kernel: str, work: Work) -> None:
    """A kernel wrapper's call on meta tensors: its ``work`` goes to the
    innermost active counting mode, if any (a meta call is no launch)."""
    if _SINKS:
        _SINKS[-1](kernel, work)


def dtype_name(dtype) -> str:
    """``"bfloat16"`` or ``"float32"``: the rate a kernel's call runs at."""
    return str(dtype).rsplit(".", 1)[-1]
