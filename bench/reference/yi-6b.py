"""The plain reference of yi-6b (a Llama decoder with grouped-query
attention; arXiv:2403.04652): RMSNorm, attention with rotary positions
and 4 kv heads for 32 query heads, a SiLU-gated MLP, the final norm and
an untied unembed, in f32 (bench/reference/common.py).

Departures from Hugging Face's Llama, as the port defines the model:
rotary pairs (2i, 2i+1) (the JAX package's convention, a fixed
permutation of each head's dims away from Hugging Face's), and the MLP
names its up projection ``w_in`` and its gate ``w_gate``.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch
import torch.nn.functional as F

_spec = importlib.util.spec_from_file_location("bench_reference_common", Path(__file__).with_name("common.py"))
C = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(C)


def make_layer(cfg: dict):
    d, h, kv = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, eps, theta = d // h, float(cfg["rms_norm_eps"]), float(cfg["rope_theta"])

    def layer(p: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
        b, s, _ = x.shape
        a = C.rms_norm(x, p["norm1/w"], eps)
        q = C.mm(a, p["mixer/wq"].reshape(d, h * hd), prec).reshape(b, s, h, hd)
        k = C.mm(a, p["mixer/wk"].reshape(d, kv * hd), prec).reshape(b, s, kv, hd)
        v = C.mm(a, p["mixer/wv"].reshape(d, kv * hd), prec).reshape(b, s, kv, hd)
        o = C.causal_attention(C.rope(q, theta), C.rope(k, theta), v, prec).reshape(b, s, h * hd)
        x = x + C.mm(o, p["mixer/wo"].reshape(h * hd, d), prec)
        a = C.rms_norm(x, p["norm2/w"], eps)
        up, gate = C.mm(a, p["mlp/w_in"], prec), C.mm(a, p["mlp/w_gate"], prec)
        return x + C.mm(F.silu(gate) * up, p["mlp/w_out"], prec)

    return layer


def decoder(cfg: dict, leaves: dict, prec: str = "f32") -> C.Decoder:
    C.no_tf32()
    return C.Decoder(leaves, make_layer(cfg), float(cfg["rms_norm_eps"]), bool(cfg.get("tie_word_embeddings")), prec)
