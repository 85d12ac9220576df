"""Plain PyTorch pieces of the configurations' references: float32
operations with TF32 off, no kernel, cache or batching of the program.

It imports nothing of the program. It takes the benchmark's weights
(the tensors the benchmark made from the seed, by the program's leaf
paths) and tokens, and works everything else out itself.

``prec`` selects the arithmetic of every product of two operands:
``"f32"`` (the reference) or ``"fp8"`` (the control: each operand
rounded to float8 e4m3 with a per-tensor scale before an f32 product,
the precision a later change might be tempted to serve in).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class _RoundFp8(torch.autograd.Function):
    """x rounded to e4m3 on a per-tensor scale; the gradient passes
    through unchanged."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = E4M3_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        return g


def operand(x: torch.Tensor, prec: str) -> torch.Tensor:
    return _RoundFp8.apply(x) if prec == "fp8" else x


def mm(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """x (..., k) @ w (k, n) in f32, the operands in ``prec``."""
    return operand(x, prec) @ operand(w, prec)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, D) at positions 0..S-1, pairing
    dims (2i, 2i+1) with frequency theta^(-i / (D/2))."""
    b, s, h, d = x.shape
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang).float()[None, :, None], torch.sin(ang).float()[None, :, None]
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1).reshape(b, s, h, d)


def causal_attention(q, k, v, prec: str) -> torch.Tensor:
    """softmax(q k^T / sqrt(D), causal) v with query head i reading kv
    head i // (H / KV); q (B, S, H, D), k and v (B, S, KV, D)."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", operand(q, prec), operand(k, prec)) / math.sqrt(d)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", operand(p, prec), operand(v, prec))


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence, no bias: x (B, S, C), w (W, C)."""
    wd = w.shape[0]
    xp = F.pad(x, (0, 0, wd - 1, 0))
    return sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(wd))


def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., L, L): out[..., i, j] = x[j+1] + ... + x[i] for
    j <= i, -inf above the diagonal; each entry a direct sum, so no
    difference of large cumulative sums loses digits."""
    n = x.shape[-1]
    xr = x[..., None].expand(*x.shape, n)
    xr = xr.masked_fill(~torch.ones(n, n, dtype=torch.bool, device=x.device).tril(-1), 0.0)
    out = torch.cumsum(xr, dim=-2)
    return out.masked_fill(~torch.ones(n, n, dtype=torch.bool, device=x.device).tril(), float("-inf"))


def ssd(x, dt, a, bm, cm, prec: str) -> torch.Tensor:
    """The SSD recurrence S_t = exp(dt_t A) S_{t-1} + B_t (dt_t x_t)^T,
    y_t = C_t . S_t, from a zero state, in its quadratic form over the
    whole sequence: y_t = sum_{s<=t} (C_t . B_s) exp(sum_{r=s+1..t} dt_r A) dt_s x_s.
    x (B, S, H, P), dt (B, S, H), a (H,), bm and cm (B, S, G, N)."""
    b, s, h, p = x.shape
    rep = h // bm.shape[2]
    cb = torch.einsum("bign,bjgn->bgij", operand(cm, prec), operand(bm, prec)).repeat_interleave(rep, dim=1)
    decay = torch.exp(segsum((dt * a).transpose(1, 2)))  # (B, H, S, S)
    xdt = x * dt[..., None]
    return torch.einsum("bhij,bjhp->bihp", operand(cb * decay, prec), operand(xdt, prec))


def nll_sum(h: torch.Tensor, labels: torch.Tensor, w_out: torch.Tensor, prec: str) -> torch.Tensor:
    """Summed next-token negative log-likelihood of hidden states h (B,
    S, d) (already through the final norm) against labels (B, S), the
    log-sum-exp over every column of w_out (d, V)."""
    logits = mm(h, w_out, prec)
    return (torch.logsumexp(logits, -1) - logits.gather(-1, labels[..., None])[..., 0]).sum()


# ------------------------------------------------------ the 8-bit AdamW
QBLOCK = 256
V_FLOOR = 1e-16


def _blocks(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    npad = -(-n // QBLOCK) * QBLOCK
    return F.pad(x, (0, npad - n)).reshape(*x.shape[:-1], npad // QBLOCK, QBLOCK)


def _unblock(b: torch.Tensor, n: int) -> torch.Tensor:
    return b.reshape(*b.shape[:-2], -1)[..., :n]


def q_linear(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """m on its int8 absmax grid (256-blocks of the trailing dim,
    zero-padded): (codes, scale a block)."""
    b = _blocks(m)
    scale = b.abs().amax(-1, keepdim=True) / 127.0
    codes = torch.clamp(torch.round(b / torch.where(scale == 0, 1.0, scale)), -127, 127)
    return codes.to(torch.int8), scale


def dq_linear(codes: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    return _unblock(codes.float() * scale, n)


def q_log(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """v (non-negative) on its int8 log2 grid per 256-block: lo and hi of
    log2(v + 1e-16), 254 steps between them (at least 1e-8). Returns
    (codes, lo, step)."""
    b = torch.log2(_blocks(v) + V_FLOOR)
    lo, hi = b.amin(-1, keepdim=True), b.amax(-1, keepdim=True)
    step = torch.clamp_min((hi - lo) / 254.0, 1e-8)
    codes = torch.clamp(torch.round((b - lo) / step) - 127, -127, 127)
    return codes.to(torch.int8), lo, step


def dq_log(codes: torch.Tensor, lo: torch.Tensor, step: torch.Tensor, n: int) -> torch.Tensor:
    return _unblock(torch.clamp_min(torch.exp2(lo + (codes.float() + 127) * step) - V_FLOOR, 0.0), n)


def cosine_lr(step: int, opt: dict) -> float:
    """Linear warm-up to ``lr``, then a cosine to a tenth of it."""
    peak, warm, total = opt["lr"], opt["warmup_steps"], opt["schedule_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def slices(t: torch.Tensor) -> list[torch.Tensor]:
    """A stacked leaf (3 dims or more, the layers first) as its layers,
    any other whole: the grids block the trailing dim alone, so the
    update of a slice is the slice of the update."""
    return list(t.unbind(0)) if t.dim() >= 3 else [t]


def norm(t: torch.Tensor, minus: torch.Tensor | None = None) -> float:
    """The 2-norm of t (of t - minus), summed in f64 a layer at a time."""
    parts = zip(slices(t), slices(minus)) if minus is not None else ((s, None) for s in slices(t))
    return math.sqrt(sum(float((a.float() if b is None else a.float() - b.float()).square().sum(dtype=torch.float64))
                         for a, b in parts))


class AdamW8bit:
    """AdamW whose m and v live on 8-bit grids between steps, clipped to a
    global norm, each parameter kept in the dtype its leaf was given in
    (``dtypes``), computed in f32, a layer at a time."""

    def __init__(self, params: dict, dtypes: dict, opt: dict):
        self.opt, self.dtypes, self.step_n = opt, dtypes, 0
        self.m = {k: [q_linear(torch.zeros_like(s)) for s in slices(p)] for k, p in params.items()}
        self.v = {k: [q_log(torch.zeros_like(s)) for s in slices(p)] for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> float:
        """One update in place; returns the gradients' global norm."""
        o = self.opt
        self.step_n += 1
        t = self.step_n
        gnorm = math.sqrt(sum(norm(g) ** 2 for g in grads.values()))
        clip = min(1.0, o["max_grad_norm"] / (gnorm + 1e-9))
        lr, bc1, bc2 = cosine_lr(t, o), 1 - o["b1"] ** t, 1 - o["b2"] ** t
        for k, p in params.items():
            for i, (ps, gs) in enumerate(zip(slices(p), slices(grads[k]))):
                n = ps.shape[-1]
                g = gs * clip
                m = o["b1"] * dq_linear(*self.m[k][i], n) + (1 - o["b1"]) * g
                v = o["b2"] * dq_log(*self.v[k][i], n) + (1 - o["b2"]) * g * g
                u = (m / bc1) / (torch.sqrt(v / bc2) + o["eps"]) + o["weight_decay"] * ps
                ps.copy_((ps - lr * u).to(self.dtypes[k]).float())
                self.m[k][i], self.v[k][i] = q_linear(m), q_log(v)
        return gnorm


# ------------------------------------------------ a decoder, layer by layer
class Decoder:
    """A decoder of identical layers over a token embedding, in f32.

    ``leaves`` maps the program's leaf paths to the benchmark's weights
    (any dtype; held here in f32): ``embed`` (V, d), ``final_norm/w`` (1,
    d), the layers' stacked leaves under ``slots/s0/`` (L, ...), and
    ``unembed`` (d, V) unless ``tied``. ``layer(p, x, prec)`` is one
    layer on x (B, S, d), p its slices by the key after ``slots/s0/``.
    Layer inputs are kept and each layer's forward runs again under
    autograd in the backward, so only one layer's activations live at a
    time."""

    def __init__(self, leaves: dict, layer, eps: float, tied: bool, prec: str = "f32"):
        self.p = {k: v.float() for k, v in leaves.items()}
        self.layer, self.eps, self.tied, self.prec = layer, eps, tied, prec
        self.keys = sorted(k[len("slots/s0/"):] for k in self.p if k.startswith("slots/s0/"))
        self.n_layers = self.p["slots/s0/" + self.keys[0]].shape[0]

    def _w_out(self) -> torch.Tensor:
        return self.p["embed"].T if self.tied else self.p["unembed"]

    def _layer_params(self, i: int) -> dict:
        return {k: self.p["slots/s0/" + k][i] for k in self.keys}

    @torch.no_grad()
    def hidden(self, tokens: torch.Tensor, keep: bool = False):
        """The final hidden states (before the final norm) of tokens (B,
        S); with ``keep``, also each layer's input."""
        x = self.p["embed"][tokens]
        inputs = []
        for i in range(self.n_layers):
            if keep:
                inputs.append(x)
            x = self.layer(self._layer_params(i), x, self.prec)
        return (x, inputs) if keep else x

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, first: int) -> torch.Tensor:
        """f32 logits (S - first, V) of one sequence (S,) from position ``first`` on."""
        x = self.hidden(tokens[None])[0, first:]
        return mm(rms_norm(x, self.p["final_norm/w"][0], self.eps), self._w_out(), self.prec)

    def loss_and_grads(self, tokens: torch.Tensor, chunk: int = 256) -> tuple[float, dict]:
        """The mean next-token loss of tokens (B, S) and its gradient
        with respect to every leaf (f32, by path)."""
        b, s = tokens.shape
        x, inputs = self.hidden(tokens, keep=True)
        grads = {k: torch.zeros_like(v) for k, v in self.p.items()}
        count = b * (s - 1)
        wn = self.p["final_norm/w"].detach().requires_grad_(True)
        w_out = (self.p["embed"] if self.tied else self.p["unembed"]).detach().requires_grad_(True)
        gx = torch.zeros_like(x)
        total = 0.0
        for c0 in range(0, s - 1, chunk):
            c1 = min(c0 + chunk, s - 1)
            with torch.enable_grad():
                xc = x[:, c0:c1].detach().requires_grad_(True)
                h = rms_norm(xc, wn[0], self.eps)
                nll = nll_sum(h, tokens[:, c0 + 1:c1 + 1], w_out.T if self.tied else w_out, self.prec) / count
                gxc, gwn, gw = torch.autograd.grad(nll, [xc, wn, w_out])
            total += float(nll.detach())
            gx[:, c0:c1] = gxc
            grads["final_norm/w"] += gwn
            grads["embed" if self.tied else "unembed"] += gw
        del x
        for i in reversed(range(self.n_layers)):
            with torch.enable_grad():
                xi = inputs.pop().requires_grad_(True)
                p = {k: v.detach().requires_grad_(True) for k, v in self._layer_params(i).items()}
                y = self.layer(p, xi, self.prec)
                out = torch.autograd.grad(y, [xi] + [p[k] for k in self.keys], gx)
            gx = out[0]
            for k, g in zip(self.keys, out[1:]):
                grads["slots/s0/" + k][i] += g
        grads["embed"].index_add_(0, tokens.reshape(-1), gx.reshape(-1, gx.shape[-1]))
        return total, grads


def train(decoder: Decoder, dtypes: dict, batches: list[torch.Tensor], opt: dict, p0, against: dict | None = None,
          keep: bool = False) -> dict:
    """``len(batches)`` steps of the 8-bit AdamW from the decoder's
    weights: each step's loss, the first step's gradient norm of each
    leaf (before the clip), and each leaf's change after the last step
    (``p0(path)`` gives a leaf's first weights again). With ``against``
    (another first gradient, by path, anywhere), also each leaf's norm
    of the difference from it; with ``keep``, a bf16 copy of the first
    gradient on the host."""
    adam = AdamW8bit(decoder.p, dtypes, opt)
    out: dict = {"losses": []}
    for tokens in batches:
        loss, grads = decoder.loss_and_grads(tokens)
        out["losses"].append(loss)
        if "grad_norms" not in out:
            out["grad_norms"] = {k: norm(g) for k, g in grads.items()}
            if against is not None:
                out["grad_diff_norms"] = {k: norm(g, against[k].to(g.device)) for k, g in grads.items()}
            if keep:
                out["grads"] = {k: g.to(torch.bfloat16).cpu() for k, g in grads.items()}
        adam.step(decoder.p, grads)
        del grads
    out["change_norms"] = {k: norm(v, p0(k)) for k, v in decoder.p.items()}
    return out
