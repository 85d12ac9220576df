"""mamba2-2.7b's configuration file (``mamba2-2.7b.json``, Mamba-2)
read for the harness: the program's ``ArchConfig``, the weights of the
mixer's leaves that are not drawn by fan in, a training step's model
operations, and the kernels a training step calls."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

from bench.work import ssd_work

_spec = importlib.util.spec_from_file_location(
    "bench_reference_mamba2_sizes", Path(__file__).parents[1] / "reference" / "mamba2-2.7b.py")
_ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ref)
mixer = _ref.sizes  # mamba_ssm's Mamba2 defaults where ``ssm_cfg`` does not give them


def padded_vocab(cfg: dict) -> int:
    """The embedding's rows: the vocabulary rounded up to ``pad_vocab_size_multiple``."""
    mult = int(cfg.get("pad_vocab_size_multiple", 1))
    return -(-int(cfg["vocab_size"]) // mult) * mult


def arch_config(cfg: dict):
    """The program's ``ArchConfig`` of the configuration."""
    from repro_torch.models.model import ArchConfig
    from repro_torch.models.ssm import SSMParams

    m = mixer(cfg)
    return ArchConfig(
        name=cfg["name"], d_model=cfg["d_model"], n_layers=cfg["n_layer"], n_heads=0, n_kv_heads=0, d_ff=0,
        vocab=padded_vocab(cfg), pattern=("ssm",), mlp_kind="none",
        ssm=SSMParams(d_inner=m["d_inner"], head_dim=m["headdim"], state_dim=m["d_state"], n_groups=m["ngroups"],
                      conv_width=m["d_conv"], chunk=m["chunk_size"]),
        tie_embeddings=bool(cfg["tie_embeddings"]), norm_eps=m["norm_epsilon"],
    )


def fill(path: str, leaf: torch.Tensor, draw):
    """The mixer's leaves at the port's fixed values (D and the gated
    norm ones, dt_bias zeros, A_log log(linspace(1, 16, heads))), its
    conv weights normal * 0.5; None for every other leaf."""
    if path.endswith(("mixer/norm_w", "mixer/D")):
        return leaf.fill_(1.0)
    if path.endswith("mixer/dt_bias"):
        return leaf.zero_()
    if path.endswith("mixer/A_log"):
        a = torch.log(torch.linspace(1.0, 16.0, leaf.shape[-1], dtype=torch.float32, device=leaf.device))
        return leaf.copy_(a.expand(leaf.shape))
    if path.endswith(("mixer/conv_x", "mixer/conv_bc")):
        return draw(0.5)
    return None


def kernel_calls(cfg: dict, batch: int, seq: int) -> dict:
    """K2's calls in a training step, (count, shape) each: one a layer,
    bf16, no initial state, forward and backward."""
    m = mixer(cfg)
    shape = {"b": batch, "h": m["n_heads"], "g": m["ngroups"], "s": seq, "p": m["headdim"], "n": m["d_state"],
             "chunk": m["chunk_size"], "dtype": "bfloat16"}
    return {"ssd": [(cfg["n_layer"], shape)]}


def step_flops(cfg: dict, batch: int, seq: int, vocab_rows: int) -> int:
    """A training step's model operations: three times the forward's
    (the backward twice it), nothing recomputed. The forward: 2 an
    operand of every product of a weight with a token, the causal conv 2
    an operand, the SSD scan by K2's count (its chunked form), and the
    loss's unembed over the ``seq - 1`` predicted positions and
    ``vocab_rows`` columns."""
    m = mixer(cfg)
    d, gn = cfg["d_model"], m["ngroups"] * m["d_state"]
    per_token = d * (2 * m["d_inner"] + 2 * gn + m["n_heads"]) + m["d_inner"] * d
    per_token += m["d_conv"] * (m["d_inner"] + 2 * gn)
    fwd = 2 * batch * seq * per_token * cfg["n_layer"]
    fwd += sum(n * ssd_work(**kw).flops for n, kw in kernel_calls(cfg, batch, seq)["ssd"])
    fwd += 2 * batch * (seq - 1) * d * vocab_rows
    return 3 * fwd
