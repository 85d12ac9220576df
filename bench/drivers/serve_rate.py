"""A model served from a topic under an open loop: requests of
``bench/gen.py``'s ``open_loop`` produced to a request topic of the
traffic's partitions at their due times by a thread of their own, one
``LMServingWorker`` (its group's only member) over a
``ContinuousLMEngine`` polling it and publishing completions to a
response topic, which the harness reads after each tick.

The window opens once the engine is warm and lasts ``--seconds``; every
request due in it is waited for, up to ``wait_s`` past its close. A
request's latency runs from its due time to the moment its completion
can be read on the response topic, its time to first token to the
engine's ``first_token_s``; one never answered counts as infinitely
late in both. The backlog (requests due and not yet answered) is read
from those times every ``backlog_every_s`` of the window.

A traced run profiles ``trace_steps`` engine ticks of the drain after
the close, from the first tick at which every request due has its first
token on: on the H100 the profiler, CUDA activity alone too, slows every
later tick of the process about twofold, so a trace inside the window
would move what the window measures, and an earlier one the times to
first token. The trace describes the decode of the drain, not the
window.

What is compared (after the window, the program freed): every request
due is answered once, by its tenant, with ``max_new`` tokens in the
vocabulary; and for a sample drawn from the seed, the longest prompt in
it, the plain reference runs once over each prompt with its served
tokens, and the widest gap by which a served token's logit lies below
the reference's best is held to its limit.
"""

from __future__ import annotations

import gc
import math
import threading
import time

import numpy as np
import torch

from bench import gen, harness, models
from bench.trace import Profiler


def reference_gaps(cell: harness.Cell, maker, layout: list, served: list, variants: tuple = (),
                   seed: int = 0) -> dict:
    """The widest gap, over the ``served`` (prompt, tokens) pairs, by
    which a served token's f32 reference logit lies below the reference's
    best. ``variants``: "fp8" (at each position the token the reference
    in fp8 puts first, in place of the served one) and "token" (one
    served token of each request altered, at a position drawn from
    ``seed``)."""
    ref = harness.reference(cell)
    leaves = {p: maker.make(p, s, dt).float() for p, s, dt in layout}
    dec = ref.decoder(cell.config, leaves)
    low = ref.decoder(cell.config, leaves, "fp8") if "fp8" in variants else None
    rng = np.random.default_rng(seed)
    vocab = int(cell.config["vocab_size"])
    out = {"served": 0.0, "fp8": 0.0, "token": 0.0}
    for prompt, toks in served:
        seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]), dtype=torch.long, device=maker.device)
        lg = dec.logits(seq, len(prompt) - 1)
        best = lg.max(-1).values
        t = torch.as_tensor(toks, dtype=torch.long, device=maker.device)
        out["served"] = max(out["served"], float((best - lg.gather(-1, t[:, None])[:, 0]).max()))
        if low is not None:
            first = low.logits(seq, len(prompt) - 1).argmax(-1)
            out["fp8"] = max(out["fp8"], float((best - lg.gather(-1, first[:, None])[:, 0]).max()))
        if "token" in variants:
            alt = t.clone()
            i = int(rng.integers(len(toks)))
            alt[i] = (alt[i] + 1 + int(rng.integers(vocab - 1))) % vocab
            out["token"] = max(out["token"], float((best - lg.gather(-1, alt[:, None])[:, 0]).max()))
        del lg
    del dec, low, leaves
    gc.collect()
    return out


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, t0: float, device: str = "cuda",
        fault: str | None = None, variants: tuple = ()) -> dict:
    """One run of a serving cell. ``fault`` ("token": the engine's first
    token of each completion altered where it is produced) breaks the
    timed path for the harness's own tests; ``variants`` as
    :func:`reference_gaps` takes them."""
    from repro_torch.core import LogConfig, StreamLog
    from repro_torch.core.consumer import ConsumerGroup
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy
    from repro_torch.serve.lm_engine import (ContinuousLMEngine, LMServingWorker, Request, decode_completion,
                                             encode_request, tenant_key)

    tr, cfg = cell.traffic, cell.config
    vocab = int(cfg["vocab_size"])
    arch = harness.configuration(cell).arch_config(cfg)
    model = StreamModel(arch, Policy(), device=device, generator=None)
    maker = harness.weight_maker(cell, seed, device)
    maker.fill_tree(model.param_tree())
    layout = [(p, tuple(t.shape), t.dtype) for p, t in models.tree_paths(model.param_tree())]
    engine = ContinuousLMEngine(model, n_slots=int(tr["n_slots"]), n_blocks=int(tr["n_blocks"]),
                                block_size=int(tr["block_size"]), max_blocks=int(tr["max_blocks"]), device=device)
    if fault == "token":
        step = engine.step

        def altered():
            return [(rid, np.concatenate([[(int(g[0]) + 1) % vocab], g[1:]]).astype(np.int32)) for rid, g in step()]

        engine.step = altered
    # warm-up, outside the window: a full set of slots at the shortest and longest prompts
    wrng = np.random.default_rng(seed ^ 0x5EED)
    for i in range(int(tr["n_slots"])):
        n = int(tr["prompt_max"] if i % 2 else tr["prompt_min"])
        engine.submit(Request(-1 - i, wrng.integers(0, vocab, n).astype(np.int32), 2))
    engine.run_until_drained()
    engine.first_token_s.clear()

    parts = int(tr["partitions"])
    log = StreamLog()
    log.create_topic("requests", LogConfig(num_partitions=parts))
    log.create_topic("completions", LogConfig(num_partitions=parts))
    group = ConsumerGroup(log, group_id="bench-serve", topics=["requests"])
    worker = LMServingWorker("worker-0", log, group, engine, "completions")
    arrivals = gen.open_loop(tr, vocab, seed, seconds)
    due = {a.req_id: a for a in arrivals}
    sent: dict[int, float] = {}
    done: dict[int, tuple[float, int, np.ndarray]] = {}
    dupes = [0]
    offsets = [0] * parts

    def read_completions(now: float) -> None:
        for p in range(parts):
            end = log.end_offset("completions", p)
            while offsets[p] < end:
                b = log.read("completions", p, offsets[p], 256)
                for buf in b.values:
                    rid, tenant, toks = decode_completion(buf)
                    if rid in done:
                        dupes[0] += 1
                    else:
                        done[rid] = (now, tenant, toks)
                offsets[p] = b.next_offset

    if device != "cpu":
        torch.cuda.synchronize()
    prof = Profiler() if trace else None
    untimed, ticks, lanes = engine.step, [0], []

    def timed_step():
        """An engine tick; the lanes at the first tick past the close, and
        the trace over ``trace_steps`` ticks once every request due has
        its first token after the close."""
        now = time.perf_counter()
        if not lanes and now >= t_close:
            lanes.append((engine.lane_steps - lane0, engine.useful_steps - useful0))
        if (trace and prof.window_s is None and not prof.active and now >= t_close
                and all(r in engine.first_token_s for r in due)):
            prof.start()
        out = untimed()
        if trace and prof.active:
            ticks[0] += 1
            if ticks[0] >= int(tr["trace_steps"]):
                prof.stop()
        return out

    engine.step = timed_step
    lane0, useful0 = engine.lane_steps, engine.useful_steps
    t_start = time.perf_counter()
    t_close = t_start + seconds
    setup_s = t_start - t0
    stop = threading.Event()

    def produce():
        for a in arrivals:
            wait = t_start + a.due_s - time.perf_counter()
            if wait > 0 and stop.wait(wait):
                return
            log.produce("requests", encode_request(Request(a.req_id, a.prompt, a.max_new, a.tenant)),
                        key=tenant_key(a.tenant))
            sent[a.req_id] = time.perf_counter()

    producer = threading.Thread(target=produce, name="bench-open-loop", daemon=True)
    producer.start()
    deadline = t_close + float(tr["wait_s"])
    try:
        while True:
            now = time.perf_counter()
            if len(done) >= len(arrivals) or now >= deadline:
                break
            if worker.poll_serve():
                read_completions(time.perf_counter())
            else:
                time.sleep(0.0005)
    finally:
        stop.set()
        producer.join(timeout=10)
    if trace and prof.active:
        prof.stop()
    if not lanes:
        lanes.append((engine.lane_steps - lane0, engine.useful_steps - useful0))
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    first_token = dict(engine.first_token_s)

    answered_s = {r: done[r][0] - t_start for r in due if r in done}
    lat = [answered_s.get(r, math.inf) - a.due_s for r, a in due.items()]
    ttft = [first_token.get(r, math.inf) - t_start - a.due_s for r, a in due.items()]
    every = float(tr["backlog_every_s"])
    backlog = [[t, sum(a.due_s <= t for a in due.values()) - sum(v <= t for v in answered_s.values())]
               for t in np.arange(every, seconds + 1e-9, every).tolist()]
    bad = sum(1 for r, (_, tenant, toks) in done.items()
              if r not in due or tenant != due[r].tenant or len(toks) != due[r].max_new
              or not ((toks >= 0) & (toks < arch.vocab_padded)).all())
    ctx = {"ttft_s": ttft, "lane_steps": lanes[0][0], "useful_steps": lanes[0][1], "chips": cell.chips}
    if trace and prof.window_s is not None:
        ctx["trace"] = prof.trace()
    del worker, group, engine, model, log
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the reference over a sample of the answered requests, the longest prompt among them
    answered = sorted(r for r in done if r in due)
    rng = np.random.default_rng(seed)
    sample = []
    if answered:
        longest = max(answered, key=lambda r: len(due[r].prompt))
        rest = [r for r in answered if r != longest]
        k = min(int(tr["sample"]) - 1, len(rest))
        sample = [longest] + [rest[i] for i in sorted(rng.choice(len(rest), k, replace=False))]
    gaps = reference_gaps(cell, maker, layout, [(due[r].prompt, done[r][2]) for r in sample], variants, seed)
    checks = [
        harness.Check("unanswered", float(len(due) - len(answered)), 0.0),
        harness.Check("answered_twice", float(dupes[0]), 0.0),
        harness.Check("malformed", float(bad), 0.0),
        harness.Check("greedy_gap", gaps["served"], harness.limit(cell, "greedy_gap")),
    ]
    late = [sent[r] - t_start - a.due_s for r, a in due.items() if r in sent]
    return {
        "correct": all(c.ok for c in checks),
        "attempted": len(due),
        "failed": len(due) - len(answered) + bad,
        "metrics": {
            "result_latency_p95_ms": harness.percentile(lat, 95) * 1e3,
            "peak_device_gb": peak / 1e9,
            "setup_s": setup_s,
        },
        "memory_peak_bytes": peak,
        "checks": checks,
        "readings": {"gaps": gaps, "requests": len(due), "answered": len(answered), "backlog": backlog,
                     "answered_in_window": sum(v <= seconds for v in answered_s.values()),
                     "tail_s": max(answered_s.values(), default=math.inf) - seconds,
                     "generator_late_max_s": max(late, default=0.0),
                     "latency_p50_ms": harness.percentile(lat, 50) * 1e3 if lat else None},
        "ctx": ctx,
    }
