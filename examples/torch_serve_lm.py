"""Serve a small LM with batched streaming requests through the PyTorch
port (paper Algorithm 2; the twin of examples/serve_lm.py).

Requests (token prompts) arrive on an input topic across partitions; N
replicas in one consumer group pick them up, run prefill + greedy decode
with a KV cache (``build_prefill_step`` / ``build_serve_step``), and
stream completions (int32 tokens, the JAX example's record layout) to the
output topic. Killing a replica mid-stream demonstrates consumer-group
failover.

The LM is the JAX example's tiny decoder but for its heads: 4 over 2 kv
heads of dim 64 (the JAX example has 8 over 4 of dim 32), since the
port's flash-attention kernel takes head dims 64, 128 and 256. Random
weights from a seed; bf16 on the CUDA card (the default), f32 with
``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""

import argparse

import numpy as np
import torch

import repro_torch.core as core
from repro_torch.models.model import ArchConfig, StreamModel
from repro_torch.models.policy import Policy
from repro_torch.serve import InferenceDeployment, build_prefill_step, build_serve_step

PROMPT, GEN = 24, 8


def tiny_lm() -> ArchConfig:
    return ArchConfig(
        name="lm-tiny", d_model=256, n_layers=4, n_heads=4, n_kv_heads=2,
        d_ff=768, vocab=4096, q_block=64,
    )


def make_generate(model: StreamModel, prompt_len: int = PROMPT, gen: int = GEN):
    """The replicas' predict function: greedy decode of ``gen`` tokens
    after a batch of ``prompt_len``-token prompts, as the JAX example's
    ``generate`` does (a prefill, then ``gen`` decode steps, the last of
    which feeds no output). Returns (B, gen) int32 tokens on the model's
    device; the replica copies them to the host after every predict of
    its poll is launched."""
    prefill = build_prefill_step(model, prompt_len + gen)
    decode = build_serve_step(model)

    def generate(d: dict) -> torch.Tensor:
        logits, cache = prefill({"tokens": d["prompt"]})
        out = []
        tok = torch.argmax(logits, -1)[:, None]
        for i in range(gen):
            out.append(tok)
            lg, cache = decode(cache, tok, prompt_len + i)
            tok = torch.argmax(lg[:, 0], -1)[:, None]
        return torch.cat(out, dim=1).to(torch.int32)

    return generate


def main(device: str = "cuda"):
    cfg = tiny_lm()
    policy = Policy("float32", "float32", "float32") if device == "cpu" else Policy()
    model = StreamModel(cfg, policy, device=device, generator=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serving {cfg.name} ({n_params/1e6:.1f}M params) on {model.device}, "
          f"prompt={PROMPT} gen={GEN}")
    generate = make_generate(model)

    log, registry = core.StreamLog(), core.Registry()
    spec = registry.register_model("lm-tiny")
    config = registry.create_configuration([spec.model_id])
    dep = registry.deploy(config.config_id, "train")
    result = registry.upload_result(
        dep.deployment_id, spec.model_id, {"loss": 0.0},
        input_format="RAW",
        input_config={"data_type": "int32", "data_reshape": [PROMPT],
                      "label_type": "int32", "label_reshape": []},
    )

    log.create_topic("prompts", core.LogConfig(num_partitions=4))
    t = [0.0]  # controllable clock: we advance it to trigger failover
    infer = InferenceDeployment(
        log, registry, result.result_id,
        predict_fn=lambda d: generate({"prompt": d["data"]}),
        input_topic="prompts", output_topic="completions", replicas=2,
        session_timeout_s=30.0, clock=lambda: t[0],
    )

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (32, PROMPT)).astype(np.int32)
    for part in range(4):
        chunk = prompts[part * 8 : (part + 1) * 8]
        log.produce_batch("prompts", [r.tobytes() for r in chunk], partition=part)
    served = infer.drain()
    before = {r.replica_id: r.stats.processed for r in infer.replicas}
    print(f"served {served} prompts; per-replica:", before)

    # failover: kill replica 0, stream more prompts, replica 1 takes over
    infer.kill_replica(0)
    t[0] += 60.0  # session timeout elapses; replica-1 heartbeats on poll
    for part in range(4):
        chunk = prompts[part * 8 : (part + 1) * 8]
        log.produce_batch("prompts", [r.tobytes() for r in chunk], partition=part)
    served2 = infer.drain()
    infer.close()
    after = {r.replica_id: r.stats.processed for r in infer.replicas}
    print(f"after killing replica-0: served {served2} more; per-replica:", after)

    n_out = log.end_offset("completions", 0)
    comp = log.read("completions", 0, 0, 4).to_matrix().view(np.int32)
    print(f"{n_out} completions on output topic; first: {comp[0].tolist()}")
    assert served == served2 == len(prompts) == n_out // 2, (served, served2, n_out)
    assert after["replica-0"] == before["replica-0"], (before, after)
    assert after["replica-1"] == before["replica-1"] + served2, (before, after)


if __name__ == "__main__":
    # smoke-step watchdog (the shape of examples/quickstart.py's): a hang
    # must become a fast, loud failure. SERVE_LM_TIMEOUT_S overrides.
    import os
    import threading

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    timeout_s = float(os.environ.get("SERVE_LM_TIMEOUT_S", "300"))

    def _watchdog():
        print(f"torch_serve_lm: exceeded {timeout_s:.0f}s watchdog — aborting",
              flush=True)
        os._exit(124)  # hard-exit: a hung thread can't block the failure

    timer = threading.Timer(timeout_s, _watchdog)
    timer.daemon = True
    timer.start()
    main(args.device)
    timer.cancel()
