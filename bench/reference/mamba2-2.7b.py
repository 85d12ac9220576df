"""The plain reference of mamba2-2.7b (Mamba-2, arXiv:2405.21060): each
layer RMSNorm, then the Mamba-2 mixer (the z, x, B, C and dt
projections, a causal depthwise conv and SiLU on x and on B and C, dt
through softplus with its bias, A = -exp(A_log), the SSD recurrence from
a zero state in its quadratic form, the D skip, the gated RMSNorm of y *
silu(z), the out projection) added to the residual; the final norm and
the unembed tied to the embedding; in f32 (bench/reference/common.py).

Departures from mamba_ssm, as the port defines the model: the conv has
no bias, and the residual is added after the mixer in the activations'
dtype (here f32).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch
import torch.nn.functional as F

_spec = importlib.util.spec_from_file_location("bench_reference_common", Path(__file__).with_name("common.py"))
C = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(C)


def sizes(cfg: dict) -> dict:
    m = {"d_state": 128, "d_conv": 4, "expand": 2, "headdim": 64, "ngroups": 1, "chunk_size": 256,
         "norm_epsilon": 1e-5, **{k: v for k, v in cfg["ssm_cfg"].items() if k != "layer"}}
    m["d_inner"] = m["expand"] * cfg["d_model"]
    m["n_heads"] = m["d_inner"] // m["headdim"]
    return m


def make_layer(cfg: dict):
    m = sizes(cfg)
    di, hp, n, g, eps = m["d_inner"], m["headdim"], m["d_state"], m["ngroups"], float(m["norm_epsilon"])
    h, gn = m["n_heads"], m["ngroups"] * m["d_state"]

    def layer(p: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
        b, s, _ = x.shape
        a = C.rms_norm(x, p["norm1/w"], eps)
        z = C.mm(a, p["mixer/w_z"], prec)
        xh = F.silu(C.causal_conv(C.mm(a, p["mixer/w_x"], prec), p["mixer/conv_x"]))
        bc = torch.cat([C.mm(a, p["mixer/w_B"], prec), C.mm(a, p["mixer/w_C"], prec)], dim=-1)
        bc = F.silu(C.causal_conv(bc, p["mixer/conv_bc"]))
        dt = F.softplus(C.mm(a, p["mixer/w_dt"], prec) + p["mixer/dt_bias"])
        xh = xh.reshape(b, s, h, hp)
        y = C.ssd(xh, dt, -torch.exp(p["mixer/A_log"]), bc[..., :gn].reshape(b, s, g, n),
                  bc[..., gn:].reshape(b, s, g, n), prec)
        y = (y + xh * p["mixer/D"][None, None, :, None]).reshape(b, s, di)
        y = C.rms_norm(y * F.silu(z), p["mixer/norm_w"], eps)
        return x + C.mm(y, p["mixer/w_out"], prec)

    return layer


def decoder(cfg: dict, leaves: dict, prec: str = "f32") -> C.Decoder:
    C.no_tf32()
    return C.Decoder(leaves, make_layer(cfg), float(sizes(cfg)["norm_epsilon"]), bool(cfg["tie_embeddings"]), prec)
