"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``
(port of ``repro.launch.serve``).

Spins up an InferenceDeployment (paper Algorithm 2) for a (reduced)
architecture: N replicas on a consumer group, prompts streamed through the
input topic, greedy completions to the output topic. The flags and the
flow are the JAX launcher's; ``--device`` (the card by default, ``cpu`` on
request) places the model, and ``--full`` serves the full-width config
(the flash-attention kernel on the card takes head dims 64, 128 and 256,
which the reduced attention configs' are not).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch.configs as configs
import repro_torch.core as core
from repro_torch.models.model import StreamModel
from repro_torch.models.policy import Policy
from repro_torch.serve import InferenceDeployment


def main(argv: list[str] | None = None) -> dict:
    """Run the deployment; returns what it printed as numbers: the prompts
    served, each replica's count and the completions on the output topic."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.names())
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--prompts", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch) if args.full else configs.get_reduced(args.arch)
    if cfg.enc_dec or cfg.frontend != "none":
        raise SystemExit(f"{args.arch}: serve launcher supports text decoders; "
                         "see examples/torch_serve_lm.py for a decoder of its own")
    model = StreamModel(cfg, Policy(), device=args.device, generator=0)
    s_cache = args.prompt_len + args.gen

    def generate(d):
        toks = torch.tensor(d["data"].astype(np.int32), device=model.device)
        logits, cache = model.prefill(toks, s_cache)
        tok = torch.argmax(logits, -1)[:, None]
        outs = [tok]
        for _ in range(args.gen - 1):
            lg, cache = model.decode_step(cache, tok)
            tok = torch.argmax(lg[:, 0], -1)[:, None]
            outs.append(tok)
        return torch.cat(outs, 1).to(torch.int32)

    log, registry = core.StreamLog(), core.Registry()
    spec = registry.register_model(args.arch)
    c = registry.create_configuration([spec.model_id])
    dep = registry.deploy(c.config_id, "train")
    res = registry.upload_result(
        dep.deployment_id, spec.model_id, {"loss": 0.0},
        input_format="RAW",
        input_config={"data_type": "int32", "data_reshape": [args.prompt_len],
                      "label_type": "int32", "label_reshape": []},
    )
    log.create_topic("prompts", core.LogConfig(num_partitions=args.replicas * 2))
    infer = InferenceDeployment(
        log, registry, res.result_id, predict_fn=generate,
        input_topic="prompts", output_topic="completions",
        replicas=args.replicas,
    )
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.prompts, args.prompt_len)).astype(np.int32)
    per = max(args.prompts // (args.replicas * 2), 1)
    for p in range(args.replicas * 2):
        chunk = prompts[p * per : (p + 1) * per]
        if len(chunk):
            log.produce_batch("prompts", [r.tobytes() for r in chunk], partition=p)
    try:
        served = infer.drain()
    finally:
        infer.close()
    counts = {r.replica_id: r.stats.processed for r in infer.replicas}
    print(f"served {served} prompts across { counts }")
    print(f"{log.end_offset('completions', 0)} completions on the output topic")
    n = log.end_offset("completions", 0)
    return {"served": served, "replicas": counts, "completions": n,
            "records": [bytes(v) for v in log.read("completions", 0, 0, max(n, 1)).values]}


if __name__ == "__main__":
    main()
