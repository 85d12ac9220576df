"""Train an LM from a stream through the PyTorch port, with checkpoint/restart
fault tolerance (the twin of examples/train_lm.py).

Token sequences from a seeded Markov corpus are streamed into the log as
RAW records; a registered model, configuration and deployment announce
them on the control topic, and the port's ``TrainingJob`` reads them
through that control message, trains with AdamW on a warm-up + cosine
schedule, checkpoints (step + stream offsets) as it goes, and uploads its
result to the registry.

On a CUDA card (the default) the model is the JAX example's 12-layer /
d=768 llama-style decoder (lm-100m, head dim 64, bf16), whose attention
runs the port's flash-attention kernel forward and backward. On the CPU
(``--device cpu``) it is a two-layer d=64 decoder in f32 over 32-token
sequences, small enough for a test.

Run:
    PYTHONPATH=src python examples/torch_train_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --steps 200 --kill-at 80
        # trains 80 steps, "crashes", restarts from the checkpoint, finishes
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 12 --kill-at 5
"""

import argparse
import os
import tempfile

import numpy as np

import repro_torch.core as core
import repro_torch.data as data
from repro_torch.data.formats import RawCodec
from repro_torch.models.model import ArchConfig, StreamModel
from repro_torch.models.policy import Policy
from repro_torch.train import TrainingJob, adamw, cosine_schedule

SEQ = 256


def lm_100m() -> ArchConfig:
    return ArchConfig(
        name="lm-100m",
        d_model=768,
        n_layers=12,
        n_heads=12,
        n_kv_heads=4,
        d_ff=3072,
        vocab=8192,
        rope_theta=10000.0,
        q_block=128,
    )


def lm_tiny() -> ArchConfig:
    return ArchConfig(
        name="lm-tiny", d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    )


def synth_corpus(n_seqs: int, vocab: int, seq: int = SEQ, seed=0) -> np.ndarray:
    """Markov-chain token streams — learnable structure, no dataset files
    (examples/train_lm.py's generator, with the sequence length a
    parameter)."""
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.full(64, 0.1), size=64)
    states = np.zeros((n_seqs, seq), np.int32)
    s = rng.integers(0, 64, n_seqs)
    for t in range(seq):
        states[:, t] = s
        u = rng.random(n_seqs)
        s = (trans[s].cumsum(1) > u[:, None]).argmax(1)
    return (states * (vocab // 64) + rng.integers(0, 4, states.shape)).astype(np.int32)


def main(device: str = "cuda", steps: int = 200, batch: int = 16, kill_at: int | None = None,
         ckpt_dir: str | None = None):
    if device == "cpu":
        cfg, policy, seq, n_seqs = lm_tiny(), Policy("float32", "float32", "float32"), 32, 128
    else:
        cfg, policy, seq, n_seqs = lm_100m(), Policy(), SEQ, 2048
    model = StreamModel(cfg, policy, device=device, generator=None)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.name}, {n_params / 1e6:.1f}M params on {model.device}")

    log, registry = core.StreamLog(), core.Registry()
    spec = registry.register_model(cfg.name)
    config = registry.create_configuration([spec.model_id])
    dep = registry.deploy(config.config_id, "train")

    # stream the corpus into the log (RAW int32 sequences)
    corpus = synth_corpus(n_seqs, cfg.vocab, seq=seq)
    codec = RawCodec("int32", (seq,), "int32", ())
    log.create_topic("corpus", core.LogConfig(num_partitions=4))
    msg = data.ingest(
        log, "corpus", codec,
        {"data": corpus, "label": np.zeros(len(corpus), np.int32)},
        dep.deployment_id, validation_rate=0.125,
    )
    print(f"corpus in log: {msg.total_msg} seqs, ranges {[str(r) for r in msg.ranges]}")

    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(), "torch_train_lm_ckpt")
    opt = adamw(cosine_schedule(3e-4 if device != "cpu" else 3e-3, warmup_steps=min(20, steps // 4),
                                total_steps=steps))

    def make_job():
        return TrainingJob(
            log, registry, dep.deployment_id, spec.model_id,
            loss_fn=lambda p, b: model.loss(p, {"tokens": b["data"]}, loss_chunk=seq),
            init_fn=model.init, opt=opt, ckpt_dir=ckpt_dir, ckpt_every=max(steps // 5, 1), seed=0,
            device=device,
        )

    if kill_at:
        try:
            make_job().run(batch_size=batch, max_steps=steps, crash_after=kill_at, streaming=True)
        except RuntimeError as e:
            print(f"!! {e} — restarting from checkpoint")
        res = make_job().run(batch_size=batch, max_steps=steps, resume=True, streaming=True)
    else:
        res = make_job().run(batch_size=batch, max_steps=steps, streaming=True)
    print(f"done at step {res.steps}: {res.metrics}, eval {res.eval_metrics}")
    for r in registry.results_for(dep.deployment_id):
        print(f"registry result {r.result_id}: loss={r.metrics.get('loss'):.4f}")
    return res


if __name__ == "__main__":
    # smoke-step watchdog (same shape as examples/torch_serve_continuous.py):
    # a hang must become a fast, loud failure. TRAIN_TIMEOUT_S overrides.
    import threading

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--kill-at", type=int, default=None)
    parser.add_argument("--ckpt-dir", default=None)
    args = parser.parse_args()
    timeout_s = float(os.environ.get("TRAIN_TIMEOUT_S", "600"))

    def _watchdog():
        print(f"torch_train_lm: exceeded {timeout_s:.0f}s watchdog — aborting", flush=True)
        os._exit(124)  # hard-exit: a hung thread can't block the failure

    timer = threading.Timer(timeout_s, _watchdog)
    timer.daemon = True
    timer.start()
    main(args.device, args.steps, args.batch, args.kill_at, args.ckpt_dir)
    timer.cancel()
