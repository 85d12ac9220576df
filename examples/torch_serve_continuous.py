"""Continuous-batching LM serving through the PyTorch port, behind a
consumer group on a replicated cluster (the twin of
examples/serve_continuous.py).

A small yi-6b behind a 2-worker ``LMServingGroup`` on a
``BrokerCluster(3)``: mixed-length requests stream onto a
per-tenant-keyed request topic of two partitions, the continuous
engines admit them into in-flight decode batches, and keyed completions
land on the response topic under transactional publish; a read_committed
audit checks that each request was answered once, under its tenant.

The model is reduced yi-6b with random weights from a seed. On the CPU
(``--device cpu``) it is the reduced config in f32. On a CUDA card (the
default) prefill attention runs the port's flash-attention kernel, which
takes head dims 64, 128 and 256 only, so the reduced config gets head
dim 64 (its own is 16) and runs in bf16, as full-width yi-6b does.

Run:  PYTHONPATH=src python examples/torch_serve_continuous.py [--device cpu]
"""

import argparse
import dataclasses

import numpy as np

import repro_torch.configs as C
import repro_torch.core as core
from repro_torch.models.model import StreamModel
from repro_torch.models.policy import Policy
from repro_torch.serve import (
    ContinuousLMEngine,
    LMServingGroup,
    Request,
    decode_completion,
    encode_request,
    tenant_key,
)


def main(device: str = "cuda"):
    cfg = C.get_reduced("yi-6b")
    if device == "cpu":
        policy = Policy("float32", "float32", "float32")
    else:
        cfg, policy = dataclasses.replace(cfg, head_dim=64), Policy()
    model = StreamModel(cfg, policy, device=device, generator=0)

    log = core.BrokerCluster(3)
    log.create_topic("lm-requests", core.LogConfig(num_partitions=2))
    log.create_topic("lm-responses", core.LogConfig(num_partitions=2))

    group = LMServingGroup(
        log,
        [
            ContinuousLMEngine(
                model, n_slots=4, n_blocks=32, block_size=8, max_blocks=8, device=device
            )
            for _ in range(2)
        ],
        input_topic="lm-requests",
        response_topic="lm-responses",
        transactional=True,
    )

    rng = np.random.default_rng(0)
    reqs = []
    for rid in range(10):
        plen = int(rng.choice([6, 10, 14]))
        prompt = rng.integers(0, cfg.vocab, plen).astype(np.int32)
        reqs.append(Request(rid, prompt, int(rng.integers(2, 7)), tenant=rid % 3))
    for r in reqs:
        log.produce("lm-requests", encode_request(r), key=tenant_key(r.tenant))

    served = group.drain()
    got = {}
    for part in range(2):
        end = log.end_offset("lm-responses", part)
        off = 0
        while off < end:
            batch = log.read("lm-responses", part, off, 64, isolation="read_committed")
            for buf in batch.values:
                rid, tenant, gen = decode_completion(buf)
                got[rid] = (tenant, gen)
            off = batch.next_offset

    assert served == len(reqs), f"served {served} != {len(reqs)}"
    assert sorted(got) == [r.req_id for r in reqs], sorted(got)
    for r in reqs:
        tenant, gen = got[r.req_id]
        assert tenant == r.tenant and len(gen) <= r.max_new, (r.req_id, tenant, gen)
    util = [w.engine.lane_utilization for w in group.workers if w.engine.lane_steps]
    print(
        f"served {served} completions via {len(group.workers)} workers on {model.device}; "
        f"lane utilization {', '.join(f'{u:.2f}' for u in util)}"
    )


if __name__ == "__main__":
    # smoke-step watchdog (same shape as examples/serve_continuous.py): a
    # hang must become a fast, loud failure. SERVE_TIMEOUT_S overrides.
    import os
    import threading

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    timeout_s = float(os.environ.get("SERVE_TIMEOUT_S", "180"))

    def _watchdog():
        print(f"torch_serve_continuous: exceeded {timeout_s:.0f}s watchdog — aborting",
              flush=True)
        os._exit(124)  # hard-exit: a hung thread can't block the failure

    timer = threading.Timer(timeout_s, _watchdog)
    timer.daemon = True
    timer.start()
    main(args.device)
    timer.cancel()
