"""yi-6b's configuration file (``yi-6b.json``, a Llama decoder with
grouped-query attention) read for the harness: the program's
``ArchConfig``, a training step's model operations, and the kernels a
training step calls."""

from __future__ import annotations

from bench.work import attention_work


def arch_config(cfg: dict):
    """The program's ``ArchConfig`` of the configuration."""
    from repro_torch.models.model import ArchConfig

    return ArchConfig(
        name=cfg["name"], d_model=cfg["hidden_size"], n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab=cfg["vocab_size"], rope_theta=float(cfg["rope_theta"]), norm_eps=float(cfg["rms_norm_eps"]),
        tie_embeddings=bool(cfg.get("tie_word_embeddings", False)),
    )


def kernel_calls(cfg: dict, batch: int, seq: int) -> dict:
    """K1's calls in a training step, (count, shape) each: one a layer,
    bf16 and causal, forward and backward."""
    h = cfg["num_attention_heads"]
    shape = {"b": batch, "h": h, "kv": cfg["num_key_value_heads"], "s": seq, "d": cfg["hidden_size"] // h,
             "dtype": "bfloat16"}
    return {"attention": [(cfg["num_hidden_layers"], shape)]}


def step_flops(cfg: dict, batch: int, seq: int, vocab_rows: int) -> int:
    """A training step's model operations: three times the forward's
    (the backward twice it), nothing recomputed. The forward: 2 an
    operand of every product of a weight with a token, attention's QK^T
    and PV at 4 D a causal pair and head, and the loss's unembed over
    the ``seq - 1`` predicted positions and ``vocab_rows`` columns."""
    d, h, kv = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, ff, layers = d // h, cfg["intermediate_size"], cfg["num_hidden_layers"]
    per_token = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * ff
    fwd = 2 * batch * seq * per_token * layers
    fwd += sum(n * attention_work(**kw).flops for n, kw in kernel_calls(cfg, batch, seq)["attention"])
    fwd += 2 * batch * (seq - 1) * d * vocab_rows
    return 3 * fwd
