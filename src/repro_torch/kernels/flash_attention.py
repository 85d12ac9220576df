"""Flash attention forward: a CUDA kernel written by hand for Hopper.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``_attn_kernel``, l.34, and ``flash_attention``, l.115) and computes the
same function as ``ref.mha``: causal / sliding-window / softcap attention
with an online softmax in f32.

What bounds it on the H100: at the prefill shapes (S 512 to 3000, D 128
for yi-6b, 256 for recurrentgemma's windowed local attention) attention
does hundreds of flops for every byte it must move, far above the card's
ridge, so it is bound by the tensor cores' rate (989 TFLOP/s in bf16).
The bf16 kernel (``csrc/flash_attention.cu``), the serving path, keeps
them fed: per (128-query tile, head, batch) block, one producer thread
brings Q once and the K and V tiles through a two-slot TMA ring in shared
memory with mbarriers, and two consumer warpgroups run both products as
``wgmma`` (S = Q.K^T from shared memory; P rounded to bf16 in registers
times the V tile), each running one tile's softmax (base 2, the
per-element mask only on tiles at an edge) under its previous tile's PV
and taking turns with the other to issue. It skips the key tiles the mask
rules out entirely (halving causal work, as ``pl.when`` does on the TPU)
and reads the kv head of each query head from the unrepeated GQA tensors
by the tensor maps' coordinates. It replaces an Ampere-style
``mma.sync`` kernel with no load/compute overlap. ptxas: 168 registers a
thread at launch (then 40 for the producer, 232 for the consumers), no
spills, 83,016 / 164,936 / 197,704 bytes of shared memory at D 64 / 128 /
256. In f32 the products run as FMAs on the CUDA cores, since TF32 would
not hold the f32 tolerance.

The bf16 kernel reads through TMA, which takes a 16-byte aligned data
pointer and batch / sequence / head strides that are positive multiples
of 16 bytes (8 elements) where the extent is above 1;
:func:`check_layout` states what the kernel takes and the wrapper raises
on anything else. On a CPU tensor the wrapper computes the plain version
instead; on a CUDA tensor it launches the kernel or raises. On meta
tensors (the dry run, ``launch/dryrun.py``) it allocates what the card
path allocates and records the kernel's work (``kernels/cost.py``),
launching nothing and counting no launch.

The gradient. With ``return_lse=True`` the forward also returns each
row's base-2 log-sum-exp (``lse2``, f32 (B, H, S)), and
:func:`flash_attention_bwd` launches the backward kernel
(``csrc/flash_attention_bwd.cu``, no TPU counterpart: JAX differentiates
its plain ``_chunked_attention``) from the saved q, k, v, o and lse2: in
bf16 a dQ kernel (which also computes Di) and a dK/dV kernel, both on
``wgmma`` with TMA rings, and with a GQA split an ordered pass that adds
the f32 partial dK / dV sums, whose scratch the wrapper allocates.
:class:`FlashAttention` joins the two as a ``torch.autograd.Function``;
its plain version on the CPU is autograd through ``ref.mha``. The
backward takes head dims 64, 128 and 256 (at 256 the dK/dV kernel's two
warpgroups share a block's 64 keys, each holding one half of dK and dV,
and dQ takes 64-key tiles through a one-slot ring), and a softcap at head
dim 256 only (gemma2-2b's 50: P from the capped score, dS times 1 - t^2
with t = tanh(score / cap)); no config has a softcap at 64 or 128.

Queries and keys of different lengths (Sq over Sk; whisper-tiny's cross
attention, the decoder's tokens over the encoder's 1500 frames) are taken
by both kernels without a causal mask or a window, the function JAX's
``_chunked_attention`` computes for a ``cross`` ``AttnParams``. lse and
Di run over Sq, dk and dv come back over Sk.

A query offset (``q_offset``, context parallelism: a rank of the mesh's
model axis holds the S / tp queries from ``q_offset`` over all S keys)
places query i at position ``q_offset + i``: a causal mask keeps key j
where ``j <= q_offset + i``, a window where ``j > q_offset + i - window``.
Both kernels move their tile ranges and in-tile masks by it; with an
offset or a mask the queries must lie within the keys (``0 <= q_offset``,
``q_offset + Sq <= Sk``) and anything else raises. Keys no query sees
(those past the last query under a causal mask) get dk = dv = 0. Offset 0
with Sq == Sk is the call of before, to the bit.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, cost, ref

__all__ = [
    "BWD_LAUNCHES",
    "BWD_OFFSET_LAUNCHES",
    "FlashAttention",
    "LAUNCHES",
    "OFFSET_LAUNCHES",
    "check_bwd_layout",
    "check_layout",
    "flash_attention",
    "flash_attention_bwd",
]

# kernel launches since import (or since a caller last set it to 0)
LAUNCHES = 0
BWD_LAUNCHES = 0  # of the backward's C entry point (two to three CUDA kernels each)
# of those, the launches with a query offset above 0 (context parallelism)
OFFSET_LAUNCHES = 0
BWD_OFFSET_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
_BWD_HEAD_DIMS = (64, 128, 256)
_BWD_SOFTCAP_HEAD_DIMS = (256,)  # the head dims whose backward takes a softcap
_fn = None
_bwd_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("flash_attention")
        fn = lib.repro_flash_attention_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 7
            + [ctypes.c_int64] * 12
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.repro_cuda_error_string)
    return _fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int | None,
           q_offset: int = 0) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, Sq, D) and (B, Kv, Sk, D)")
    b, h, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} must be >= 0")
    if (causal or window is not None or q_offset) and q_offset + s > k.shape[2]:
        raise ValueError(
            f"queries ({s}) at offset {q_offset} and keys ({k.shape[2]}) of different lengths take a causal "
            "mask, a window or an offset only where the queries lie within the keys (q_offset + Sq <= Sk)"
        )
    if h % k.shape[1] != 0:
        raise ValueError(f"{h} query heads do not group over {k.shape[1]} kv heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")


def check_layout(name: str, shape, stride, data_ptr: int, dtype: torch.dtype) -> None:
    """Raise ValueError unless the CUDA kernel takes this (B, heads, S, D)
    view of ``shape`` and element ``stride`` starting at ``data_ptr``.

    Every dtype needs a head_dim of 64, 128 or 256, contiguous. bf16 reads
    through TMA tensor maps, which take a 16-byte aligned base and strides
    that are positive multiples of 16 bytes; a dimension of extent 1 is
    never stepped, so its stride does not matter.
    """
    if shape[3] not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {shape[3]} not in {_HEAD_DIMS}")
    if stride[3] != 1:
        raise ValueError(f"{name} must be contiguous along head_dim")
    if dtype != torch.bfloat16:
        return
    if data_ptr % 16:
        raise ValueError(f"bf16 {name} must start at a 16-byte aligned address for TMA")
    for axis, (n, st) in enumerate(zip(shape[:3], stride[:3])):
        if n > 1 and (st <= 0 or st % 8):
            raise ValueError(
                f"bf16 {name}: stride {st} of axis {axis} must be a positive multiple of 8 elements for TMA"
            )


def flash_attention(
    q: torch.Tensor,  # (B, H, Sq, D), any batch/head/seq strides
    k: torch.Tensor,  # (B, Kv, Sk, D), H % Kv == 0: query head h reads kv head h // (H / Kv)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    return_lse: bool = False,
    q_offset: int = 0,
):
    """Attention over (B, H, Sq, D) queries at positions q_offset ..
    q_offset + Sq - 1 and (B, Kv, Sk, D) keys and values (with a mask or an
    offset, q_offset + Sq <= Sk); returns (B, H, Sq, D) in q's dtype, and with ``return_lse`` also each row's base-2
    log-sum-exp of its scaled scores, ``log2(sum_k exp(s_k))``, as a
    contiguous (B, H, Sq) f32 tensor (what :func:`flash_attention_bwd`
    takes).

    The output is a (B, H, Sq, D) view of a contiguous (B, Sq, H, D)
    tensor, so the model's layout comes back without a copy.
    """
    global LAUNCHES, OFFSET_LAUNCHES
    _check(q, k, v, causal, window, q_offset)
    if q.device.type == "cpu":
        kr, vr = _repeat(q, k), _repeat(q, v)
        out = ref.mha(q, kr, vr, causal=causal, window=window, softcap=softcap, q_offset=q_offset)
        if not return_lse:
            return out
        sc = ref.scores(q, kr, causal=causal, window=window, softcap=softcap, q_offset=q_offset)
        return out, torch.logsumexp(sc, dim=-1) * _LOG2E
    if q.device.type == "meta":
        return _meta_forward(q, k, v, causal, window, softcap, return_lse, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    b, h, s, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_layout(name, t.shape, t.stride(), t.data_ptr(), t.dtype)
    if window is not None and window <= 0:
        raise ValueError("window must be positive")
    if softcap is not None and softcap <= 0:
        raise ValueError("softcap must be positive")
    dev = q.get_device()
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    fn, err_str = _kernel()
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        _DTYPES[q.dtype], b, h, k.shape[1], s, k.shape[2], d,
        q.stride(0), q.stride(2), q.stride(1),
        k.stride(0), k.stride(2), k.stride(1),
        v.stride(0), v.stride(2), v.stride(1),
        out.stride(0), out.stride(2), out.stride(1),
        1.0 / math.sqrt(d), int(causal), window or 0, int(q_offset), float(softcap or 0.0),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if dev == torch.cuda.current_device():  # the launch goes to the current card
        rc = fn(*args)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: {err_str(rc).decode()} ({rc})")
    LAUNCHES += 1
    OFFSET_LAUNCHES += q_offset > 0
    return (out, lse) if return_lse else out


_LOG2E = 1.0 / math.log(2.0)


def _meta_forward(q, k, v, causal, window, softcap, return_lse, q_offset):
    """The card path's outputs on meta tensors, for the dry run: the same
    (B, H, Sq, D) view of a (B, Sq, H, D) tensor and lse, and K1's work
    recorded (``cost.record``); no launch, no count. Head dims and TMA
    layouts are not checked: the dry run accounts for the call as the card
    would make it."""
    b, h, s, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    cost.record("flash_attention", cost.attention_work(
        b, h, k.shape[1], s, d, cost.dtype_name(q.dtype), causal, window, k.shape[2], q_offset, softcap is not None))
    return (out, lse) if return_lse else out


def _repeat(q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """(B, Kv, S, D) -> (B, H, S, D): kv head j serves query heads j*rep .. j*rep + rep - 1."""
    rep = q.shape[1] // kv.shape[1]
    return kv.repeat_interleave(rep, dim=1) if rep > 1 else kv


# ------------------------------------------------------------------ backward
def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        lib = _build.load("flash_attention_bwd")
        fn = lib.repro_flash_attention_bwd
        fn.argtypes = (
            [ctypes.c_void_p] * 10
            + [ctypes.c_int] * 7
            + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
               ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        scratch = lib.repro_flash_attention_bwd_scratch
        scratch.argtypes = [ctypes.c_int] * 7
        scratch.restype = ctypes.c_int64
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _bwd_fn = (fn, scratch, lib.repro_cuda_error_string)
    return _bwd_fn


def check_bwd_layout(name: str, shape, stride, data_ptr: int, dtype: torch.dtype) -> None:
    """Raise ValueError unless the backward kernel takes this (B, heads, S,
    D) view: a unit head_dim stride and, in bf16 (read 16 bytes at a
    time), a 16-byte aligned base and batch / sequence / head strides in
    multiples of 8 elements where the extent is above 1. Head dims other
    than 64, 128 and 256 raise NotImplementedError."""
    if shape[3] not in _BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"{name}: the flash-attention backward takes head_dim {_BWD_HEAD_DIMS}, not {shape[3]}"
        )
    if stride[3] != 1:
        raise ValueError(f"{name} must be contiguous along head_dim")
    if dtype != torch.bfloat16:
        return
    if data_ptr % 16:
        raise ValueError(f"bf16 {name} must start at a 16-byte aligned address")
    for axis, (n, st) in enumerate(zip(shape[:3], stride[:3])):
        if n > 1 and (st <= 0 or st % 8):
            raise ValueError(f"bf16 {name}: stride {st} of axis {axis} must be a positive multiple of 8 elements")


def _fits_bwd(t: torch.Tensor) -> bool:
    try:
        check_bwd_layout("t", t.shape, t.stride(), t.data_ptr(), t.dtype)
    except ValueError:
        return False
    return True


def flash_attention_bwd(
    q: torch.Tensor,  # (B, H, Sq, D), as given to the forward
    k: torch.Tensor,  # (B, Kv, Sk, D)
    v: torch.Tensor,
    o: torch.Tensor,  # (B, H, Sq, D), the forward's output
    do: torch.Tensor,  # (B, H, Sq, D), the output's gradient
    lse: torch.Tensor,  # (B, H, Sq) f32, the forward's base-2 log-sum-exp
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of :func:`flash_attention` (each in its input's dtype and
    shape; dk and dv summed over the query heads of each kv group; the
    queries at positions from ``q_offset``).

    On CPU tensors the plain version: autograd through ``ref.mha``. On
    CUDA tensors it launches the backward kernel or raises: head dims
    other than 64, 128 and 256, and a softcap at a head dim other than
    256, raise NotImplementedError.
    """
    global BWD_LAUNCHES, BWD_OFFSET_LAUNCHES
    _check(q, k, v, causal, window, q_offset)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse {tuple(lse.shape)} do not match q {tuple(q.shape)}")
    if q.device.type == "cpu":
        with torch.enable_grad():
            qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = ref.mha(qq, _repeat(qq, kk), _repeat(qq, vv), causal=causal, window=window, softcap=softcap,
                          q_offset=q_offset)
            return torch.autograd.grad(out, (qq, kk, vv), do)
    if q.device.type == "meta":
        return _meta_backward(q, k, v, do, lse, causal, window, softcap, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors, not {q.device}")
    if softcap is not None and q.shape[3] not in _BWD_SOFTCAP_HEAD_DIMS:
        raise NotImplementedError(
            f"the flash-attention backward takes a softcap at head_dim {_BWD_SOFTCAP_HEAD_DIMS} only, not "
            f"{q.shape[3]} (no config has one there)"
        )
    if window is not None and window <= 0:
        raise ValueError("window must be positive")
    if softcap is not None and softcap <= 0:
        raise ValueError("softcap must be positive")
    if do.dtype != q.dtype or o.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"o and do must be {q.dtype} and lse float32, got {o.dtype}, {do.dtype}, {lse.dtype}")
    if not _fits_bwd(do):  # autograd's gradient may come in any layout
        do = do.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        check_bwd_layout(name, t.shape, t.stride(), t.data_ptr(), t.dtype)
    lse = lse.contiguous()
    b, h, s, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((b, sk, kv, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((b, sk, kv, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_int64 * 24)(*(
        st for t in (q, k, v, o, do, dq, dk, dv) for st in (t.stride(0), t.stride(2), t.stride(1))
    ))
    fn, scratch, err_str = _bwd_kernel()
    # Di, then (bf16 with a GQA split) the f32 partial sums of dK and dV
    delta = torch.empty(scratch(_DTYPES[q.dtype], b, h, kv, s, sk, d), dtype=torch.float32, device=q.device)
    dev = q.get_device()
    with torch.cuda.device(dev):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPES[q.dtype], b, h, kv, s, sk, d, ctypes.cast(strides, ctypes.c_void_p),
            1.0 / math.sqrt(d), int(causal), window or 0, int(q_offset), float(softcap or 0.0),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: {err_str(rc).decode()} ({rc})")
    BWD_LAUNCHES += 1
    BWD_OFFSET_LAUNCHES += q_offset > 0
    return dq, dk, dv


def _bwd_scratch_floats(dtype: torch.dtype, b: int, h: int, kv: int, s: int, sk: int, d: int) -> int:
    """``repro_flash_attention_bwd_scratch`` (``csrc/flash_attention_bwd.cu``)
    in Python: Di (B H Sq, padded to 64 in bf16), then in bf16 with a GQA
    split of G > 1 blocks the f32 partial dK and dV, G x 2 x B x Sk x Kv x D.
    ``chip_smoke.py`` holds the two equal on the card."""
    if dtype != torch.bfloat16:
        return b * h * s
    di = (b * h * s + 63) // 64 * 64
    rep = h // kv
    g = min(4 if d == 256 else 2, rep)  # gqa_split: the largest divisor of rep up to the cap
    while rep % g:
        g -= 1
    return di + g * 2 * b * kv * sk * d if g > 1 else di


def _meta_backward(q, k, v, do, lse, causal, window, softcap, q_offset):
    """The card path's allocations on meta tensors, for the dry run: do
    copied where the kernel would not take its layout, lse made
    contiguous, dq / dk / dv as (B, heads, S, D) views of (B, S, heads, D)
    tensors, and the f32 scratch (Di and the GQA split's partials);
    K1's backward's work recorded; no launch, no count."""
    if q.shape[3] in _BWD_HEAD_DIMS and not _fits_bwd(do):
        do = do.contiguous()
    lse = lse.contiguous()
    b, h, s, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((b, sk, kv, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((b, sk, kv, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    delta = torch.empty(_bwd_scratch_floats(q.dtype, b, h, kv, s, sk, d), dtype=torch.float32, device=q.device)
    cost.record("flash_attention_bwd", cost.attention_bwd_work(
        b, h, kv, s, d, cost.dtype_name(q.dtype), causal, window, sk, q_offset, softcap is not None))
    del delta  # the kernel's scratch, live for its span
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K1 forward (with its row log-sum-exp) and the backward kernel as
    one differentiable op over (B, H, Sq, D) queries and (B, Kv, Sk, D)
    keys and values; on CPU tensors both sides are the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int | None, softcap: float | None, q_offset: int = 0):
        d = q.shape[3]
        if q.device.type == "cuda" and (
            d not in _BWD_HEAD_DIMS or (softcap is not None and d not in _BWD_SOFTCAP_HEAD_DIMS)
        ):
            raise NotImplementedError(
                f"no flash-attention backward for head_dim {d}"
                + (" with softcap" if softcap is not None else "")
                + f": it takes head_dim {_BWD_HEAD_DIMS}, and a softcap at {_BWD_SOFTCAP_HEAD_DIMS} only"
            )
        out, lse = flash_attention(q, k, v, causal=causal, window=window, softcap=softcap, return_lse=True,
                                   q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, softcap, q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap, q_offset = ctx.opts
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window, softcap=softcap,
                                         q_offset=q_offset)
        return dq, dk, dv, None, None, None, None
