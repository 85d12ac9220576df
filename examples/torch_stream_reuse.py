"""Stream reuse through the PyTorch port — the paper's §V contribution,
Fig. 8 re-enacted (the twin of examples/stream_reuse.py).

One dataset is streamed into the distributed log ONCE. Three deployed
configurations train from it; the second and third receive only a
control message (~250 bytes) pointing at [topic:partition:offset:length].
Then the retention policy expires the stream and a fourth deployment's
replay correctly fails with OffsetOutOfRange.

Training runs on the CUDA card (the default) or, with ``--device cpu``,
on the CPU.

Run:  PYTHONPATH=src python examples/torch_stream_reuse.py [--device cpu]
"""

import argparse

import numpy as np

import repro_torch.core as core
import repro_torch.data as data
from repro_torch.configs import copd_mlp
from repro_torch.data.formats import AvroCodec, FieldSpec
from repro_torch.train import TrainingJob, adamw


def main(device: str = "cuda"):
    log, registry = core.StreamLog(), core.Registry()
    log.create_topic("shared", core.LogConfig(retention_bytes=65_536,
                                              segment_bytes=8_192))
    codec = AvroCodec(
        [FieldSpec("data", "float32", (copd_mlp.N_FEATURES,))],
        [FieldSpec("label", "int32", ())],
    )
    dataset = copd_mlp.synth_dataset()

    def new_deployment():
        spec = registry.register_model("copd-mlp")
        cfg = registry.create_configuration([spec.model_id])
        dep = registry.deploy(cfg.config_id, "train")
        return spec, dep

    def job(spec, dep):
        return TrainingJob(log, registry, dep.deployment_id, spec.model_id,
                           loss_fn=copd_mlp.loss_fn, init_fn=copd_mlp.init,
                           opt=adamw(1e-2), device=device)

    # ---- D1: full ingestion (the green stream entering the log, Fig. 8)
    spec1, d1 = new_deployment()
    msg = data.ingest(log, "shared", codec, dataset, d1.deployment_id,
                      validation_rate=0.2)
    stream_bytes = log.size_bytes("shared")
    print(f"D1: ingested {msg.total_msg} records "
          f"({stream_bytes} bytes in the log) as {[str(r) for r in msg.ranges]}")
    r1 = job(spec1, d1).run(batch_size=10, epochs=10)
    print(f"D1 trained: loss {r1.metrics['loss']:.4f}")

    # ---- D2, D3: reuse via control messages only (tens of bytes)
    logger = core.ControlLogger(log)
    for name in ("D2", "D3"):
        spec_n, dn = new_deployment()
        replayed = logger.replay(msg, dn.deployment_id)
        sent = len(replayed.to_bytes())
        assert log.size_bytes("shared") == stream_bytes  # nothing re-streamed
        rn = job(spec_n, dn).run(batch_size=10, epochs=10)
        print(f"{name}: reused stream with a {sent}-byte control message "
              f"(vs {stream_bytes} bytes of data); loss {rn.metrics['loss']:.4f}")

    # ---- expiry: flood the topic so retention evicts the original stream
    filler = {"data": np.zeros((4000, copd_mlp.N_FEATURES), np.float32),
              "label": np.zeros((4000,), np.int32)}
    data.ingest(log, "shared", codec, filler, "filler-dep")
    print(f"log start offset now {log.start_offset('shared', 0)} "
          f"(original stream evicted by retention)")
    spec4, d4 = new_deployment()
    logger.replay(msg, d4.deployment_id)
    try:
        job(spec4, d4).run(batch_size=10, epochs=1)
        raise AssertionError("should have failed")
    except core.OffsetOutOfRange as e:
        print(f"D4: replay after expiry correctly fails: {e}")


if __name__ == "__main__":
    # smoke-step watchdog (the shape of examples/quickstart.py's): a hang
    # must become a fast, loud failure. STREAM_REUSE_TIMEOUT_S overrides.
    import os
    import threading

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    timeout_s = float(os.environ.get("STREAM_REUSE_TIMEOUT_S", "120"))

    def _watchdog():
        print(f"torch_stream_reuse: exceeded {timeout_s:.0f}s watchdog — aborting",
              flush=True)
        os._exit(124)  # hard-exit: a hung thread can't block the failure

    timer = threading.Timer(timeout_s, _watchdog)
    timer.daemon = True
    timer.start()
    main(args.device)
    timer.cancel()
