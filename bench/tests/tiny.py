"""Cells of the benchmark cut to a size the CPU runs in seconds: a
configuration's and a traffic's own files, with the configuration's
widths and depth, the batch and the open loop's sizes made small. Only
the harness's own tests use them."""

from __future__ import annotations

import json

from bench import harness

TINY_CONFIG = {
    "yi-6b": {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4, "num_key_value_heads": 2,
              "num_hidden_layers": 2, "vocab_size": 256},
    "mamba2-2.7b": {"d_model": 64, "n_layer": 2, "vocab_size": 250,
                    "ssm_cfg": {"layer": "Mamba2", "d_state": 16, "headdim": 16, "chunk_size": 16}},
}
TINY_TRAFFIC = {
    "train_stream": {"batch": 2, "seq": 32, "rows": 64, "markov_states": 8, "trace_steps": 2},
    "serve_rate": {"n_slots": 4, "block_size": 4, "max_blocks": 12, "n_blocks": 64, "rate_per_s": 8.0,
                   "prompt_median": 16, "prompt_min": 4, "prompt_max": 40, "max_new": 4, "sample": 3,
                   "backlog_every_s": 0.5, "wait_s": 30, "trace_steps": 4},
}
# a tiny model's readings are not the cell's (two layers of width 64 round
# differently): its limits, well below what the faults read here
TINY_LIMITS = {"train_stream": {"loss_gap": {"limit": 0.02}, "grad_gap": {"limit": 0.05},
                                "grad_diff": {"limit": 0.1}, "change_gap": {"limit": 0.02}}}
CELLS = {  # cell name -> (configuration, traffic)
    "yi6b.train_stream": ("yi-6b", "train_stream"),
    "yi6b.serve_rate": ("yi-6b", "serve_rate"),
    "mamba2.train_stream": ("mamba2-2.7b", "train_stream"),
}


def tiny(name: str, limits: dict | None = None) -> harness.Cell:
    """The cell ``name`` at the tiny sizes above, with the tiny limits of
    its driver, else its limits file's (or ``limits``)."""
    config_name, traffic_name = CELLS[name]
    config = json.loads((harness.BENCH / "configs" / f"{config_name}.json").read_text())
    traffic = json.loads((harness.BENCH / "traffic" / f"{traffic_name}.json").read_text())
    if limits is None:
        limits = TINY_LIMITS.get(traffic["driver"]) or json.loads(
            (harness.BENCH / "limits" / f"{name}.json").read_text())
    return harness.Cell(name=name, config_name=config_name, traffic_name=traffic_name, chips=1,
                        config={**config, **TINY_CONFIG[config_name]},
                        traffic={**traffic, **TINY_TRAFFIC[traffic["driver"]]}, limits=limits,
                        end_to_end=[], per_layer=[])
