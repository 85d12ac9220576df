"""Quickstart through the PyTorch port — the paper's own validation (§VI)
end to end (the twin of examples/quickstart.py).

Define a model -> create a configuration -> deploy for training -> stream
the (synthetic) HCOPD dataset through a replicated 3-broker cluster with
exactly-once idempotent producers -> train -> deploy the trained model ->
stream inference requests -> read predictions.

Training and prediction run on the CUDA card (the default) or, with
``--device cpu``, on the CPU. The predictions on the topic are f32
softmax probabilities, byte for byte the JAX example's layout.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np

import repro_torch.core as core
import repro_torch.data as data
from repro_torch.configs import copd_mlp
from repro_torch.data.formats import AvroCodec, FieldSpec
from repro_torch.serve import InferenceDeployment
from repro_torch.train import TrainingJob, adamw


def main(device: str = "cuda"):
    # a replicated cluster (rf=3, acks=all) — the same StreamBackend
    # surface as a bare StreamLog, with broker failover underneath
    log, registry = core.BrokerCluster(3), core.Registry()
    # background reporter: snapshots of the whole registry flow onto the
    # replicated __metrics topic while the pipeline runs (DESIGN §9)
    reporter = log.start_metrics_reporter(interval_s=0.25)

    # A) define the ML model (paper Listing 1/2: just the model definition)
    spec = registry.register_model("copd-mlp", description="HCOPD classifier")
    # B) a configuration = models trained from the same stream
    config = registry.create_configuration([spec.model_id])
    # C) deploy it for training
    deployment = registry.deploy(config.config_id, "train",
                                 training_kwargs={"batch_size": 10, "epochs": 25})

    # D) ingest the training stream (AVRO multi-input schema, §III-D)
    codec = AvroCodec(
        [FieldSpec("data", "float32", (copd_mlp.N_FEATURES,))],
        [FieldSpec("label", "int32", ())],
    )
    log.create_topic("copd", core.LogConfig(num_partitions=2))
    dataset = copd_mlp.synth_dataset()
    # two idempotent producer threads, one per partition: client retries
    # after a lost ack can never duplicate a training record (DESIGN §7)
    msg = data.ingest(log, "copd", codec, dataset, deployment.deployment_id,
                      validation_rate=0.2, num_threads=2, idempotent=True)
    print(f"streamed {msg.total_msg} records as {[str(r) for r in msg.ranges]}")

    # the training Job (paper Algorithm 1)
    job = TrainingJob(log, registry, deployment.deployment_id, spec.model_id,
                      loss_fn=copd_mlp.loss_fn, init_fn=copd_mlp.init,
                      opt=adamw(1e-2), device=device)
    result = job.run(batch_size=10, epochs=25)
    print(f"trained on {job.device}: {result.metrics}  eval: {result.eval_metrics}")

    # E) deploy the trained model for inference (2 replicas, Algorithm 2);
    # copd_mlp.predict runs without grad on the replicas' pool threads
    trained = registry.results_for(deployment.deployment_id)[0]
    params = job._final_state["params"]
    log.create_topic("requests", core.LogConfig(num_partitions=2))
    infer = InferenceDeployment(
        log, registry, trained.result_id,
        predict_fn=lambda d: copd_mlp.predict(params, d["data"]),
        input_topic="requests", output_topic="predictions", replicas=2,
    )

    # F) stream data for inference
    reqs = dataset["data"][:16]
    log.produce_batch("requests", [r.tobytes() for r in reqs[:8]], partition=0)
    log.produce_batch("requests", [r.tobytes() for r in reqs[8:]], partition=1)
    served = infer.drain()
    infer.close()
    preds = (log.read("predictions", 0, 0, 16).to_matrix()
             .view(np.float32).reshape(-1, copd_mlp.N_CLASSES))
    acc = (preds.argmax(1) == dataset["label"][:16]).mean()
    print(f"served {served} predictions via {len(infer.replicas)} replicas; "
          f"accuracy {acc:.2f}")

    # G) end-of-run observability summary from the cluster's own metrics
    # registry (DESIGN §9)
    log.stop_metrics_reporter()
    ingest_rate = log.metrics.gauge_value("ingest_records_per_s", topic="copd")
    lag = sum(sum(r.consumer.lag().values())
              for r in infer.replicas if r.alive)
    snap = log.metrics_snapshot()
    elections = sum(v for k, v in snap["counters"].items()
                    if k.startswith("partition_elections_total"))
    published = log.end_offset(core.METRICS_TOPIC, 0)
    print(f"metrics: ingest {ingest_rate:,.0f} records/s; inference "
          f"consumer lag {lag}; partition elections {elections}; "
          f"{published} snapshots on {core.METRICS_TOPIC} "
          f"({reporter.published} published by the reporter)")
    assert lag == 0, f"inference group should have drained to lag 0, got {lag}"


if __name__ == "__main__":
    # smoke-step watchdog (the shape of examples/quickstart.py's): a hang
    # must become a fast, loud failure. QUICKSTART_TIMEOUT_S overrides.
    import os
    import threading

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    timeout_s = float(os.environ.get("QUICKSTART_TIMEOUT_S", "120"))

    def _watchdog():
        print(f"torch_quickstart: exceeded {timeout_s:.0f}s watchdog — aborting",
              flush=True)
        os._exit(124)  # hard-exit: a hung thread can't block the failure

    timer = threading.Timer(timeout_s, _watchdog)
    timer.daemon = True
    timer.start()
    main(args.device)
    timer.cancel()
