"""A training deployment fed from a topic: the seeded Markov corpus of
``bench/gen.py`` ingested into a topic of the traffic's partitions and
announced for a registered model, ``TrainingJob.run(streaming=True)``
(``StreamingBatchIterator``, ``device_feed``, the model's loss and
gradients, the 8-bit AdamW) over the cell's configuration.

One job and its state are built once. Its first ``checked_steps`` steps
are checked against the plain reference; the window opens at the start
of step ``warm_steps + 1`` and closes at the start of the first step
past ``--seconds``, so it holds whole steps only. The window's steps run
through the same call as the checked ones.

What is compared (after the window, the program's state freed, the
reference run on the same weights and the same fed rows): each checked
step's loss, each leaf's gradient norm at step 1 as the optimizer is
handed it and the norm of its difference from the reference's (the
norms alone average rounding away: a precision below the configuration's
moves them no farther than bf16 does), and each leaf's change after the
checked steps as step ``checked_steps + 1`` finds it, each by the worst
leaf against the reference's norm of that leaf or of the median leaf,
whichever is larger; leaves whose reference gradient is under a thousandth of the
median leaf's are left out of the change. Each fed row must be a row of
the corpus, none twice.
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import numpy as np
import torch

from bench import gen, harness, models
from bench.trace import Profiler


class WindowClosed(Exception):
    """Raised from the loss at the first step past the window: it ends the job's run."""


def _norm(t: torch.Tensor, minus: torch.Tensor | None = None) -> float:
    """The 2-norm of t (of t - minus), summed in f64 a layer at a time."""
    a = t.unbind(0) if t.dim() >= 3 else [t]
    b = minus.unbind(0) if minus is not None and minus.dim() >= 3 else [minus] * len(a)
    return math.sqrt(sum(float((x.float() if y is None else x.float() - y.float()).square().sum(dtype=torch.float64))
                         for x, y in zip(a, b)))


def _gaps(prog: dict, ref: dict, keys, scale: dict | None = None) -> list[float]:
    """Each leaf's gap between two norms, against the larger of the
    reference's norm of that leaf and of the median leaf (of ``scale``'s
    norms where given)."""
    keys = list(keys)
    scale = ref if scale is None else scale
    med = statistics.median(scale[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(scale[k], med) for k in keys]


def reference_readings(cell: harness.Cell, maker, layout: list, rows: list, prec: str = "f32",
                       half: bool = False, against: dict | None = None, keep: bool = False) -> dict:
    """The plain reference's losses, first gradient norms and changes
    over the fed ``rows`` (one array of token rows a checked step), from
    the benchmark's weights; ``prec`` its arithmetic, ``half`` the
    fault of a loss over the first half of each step's rows; the norms
    of its first gradient's difference from ``against``, and with
    ``keep`` that gradient on the host."""
    ref = harness.reference(cell)
    shapes = {p: (s, dt) for p, s, dt in layout}
    dev = maker.device
    dec = ref.decoder(cell.config, {p: maker.make(p, s, dt).float() for p, s, dt in layout}, prec)
    n = len(rows[0]) // 2 if half else len(rows[0])
    batches = [torch.as_tensor(np.stack(step[:n]), dtype=torch.long, device=dev) for step in rows]
    got = ref.C.train(dec, {p: dt for p, (_, dt) in shapes.items()}, batches, cell.traffic,
                      lambda p: maker.make(p, *shapes[p]), against, keep)
    del dec
    gc.collect()
    med = statistics.median(got["grad_norms"].values())
    got["moved"] = [p for p, g in got["grad_norms"].items() if g >= 1e-3 * med]
    return got


def compare(cell: harness.Cell, prog: dict, ref: dict) -> list[harness.Check]:
    """The checks of a program's (or a stand-in's) readings against the
    reference's; ``prog["grad_diff_norms"]`` are the norms of its first
    gradient's difference from the reference's."""
    return [
        harness.Check("loss_gap", max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"])),
                      harness.limit(cell, "loss_gap")),
        harness.Check("grad_gap", max(_gaps(prog["grad_norms"], ref["grad_norms"], ref["grad_norms"])),
                      harness.limit(cell, "grad_gap")),
        harness.Check("grad_diff", max(_gaps({k: 0.0 for k in ref["grad_norms"]}, prog["grad_diff_norms"],
                                             ref["grad_norms"], ref["grad_norms"])),
                      harness.limit(cell, "grad_diff")),
        harness.Check("change_gap", max(_gaps(prog["change_norms"], ref["change_norms"], ref["moved"])),
                      harness.limit(cell, "change_gap")),
    ]


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, t0: float, device: str = "cuda",
        fault: str | None = None, variants: tuple = ()) -> dict:
    """One run of a training cell. ``fault`` ("unchanged": the update
    leaves the state as it was; "half_batch": the loss of half the rows;
    "token": a token of each fed batch altered)
    breaks the timed path for the harness's own tests; ``variants``,
    (prec, half) pairs, are further reference readings on the same rows
    and weights (the control and the faults put in the program's
    place)."""
    from repro_torch.core import LogConfig, Registry, StreamLog
    from repro_torch.core.metrics import MetricsRegistry
    from repro_torch.data import ingest
    from repro_torch.data.formats import RawCodec
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy
    from repro_torch.train import TrainingJob, adamw8bit, cosine_schedule
    from repro_torch.train.optimizer import Optimizer

    tr, cfg = cell.traffic, cell.config
    batch, seq = int(tr["batch"]), int(tr["seq"])
    checked, warm = int(tr["checked_steps"]), int(tr["warm_steps"])
    conf = harness.configuration(cell)
    model = StreamModel(conf.arch_config(cfg), Policy(), device=device, generator=None)
    maker = harness.weight_maker(cell, seed, device)
    layout = [(p, tuple(t.shape), t.dtype) for p, t in models.tree_paths(model.param_tree())]
    corpus = gen.markov_corpus(int(tr["rows"]), int(cfg["vocab_size"]), seq, seed, int(tr["markov_states"]))

    log, registry = StreamLog(), Registry()
    if trace:
        log.metrics = MetricsRegistry()
    spec = registry.register_model(f"{cell.config_name}-bench")
    dep = registry.deploy(registry.create_configuration([spec.model_id]).config_id, "bench")
    log.create_topic("corpus", LogConfig(num_partitions=int(tr["partitions"])))
    ingest(log, "corpus", RawCodec("int32", (seq,), "int32", ()),
           {"data": corpus, "label": np.zeros(len(corpus), np.int32)}, dep.deployment_id, validation_rate=0.0)

    inner = adamw8bit(cosine_schedule(tr["lr"], tr["warmup_steps"], tr["schedule_steps"]), b1=tr["b1"], b2=tr["b2"],
                      eps=tr["eps"], weight_decay=tr["weight_decay"], max_grad_norm=tr["max_grad_norm"])
    st = {"k": 0, "rows": [], "losses": [], "window_losses": [], "grad_norms": None, "change": None}

    def update(grads, state, params, **kw):
        if st["grad_norms"] is None:
            st["grad_norms"] = {p: _norm(g) for p, g in models.tree_paths(grads)}
            st["grads"] = {p: g.detach().to("cpu") for p, g in models.tree_paths(grads)}
        if fault == "unchanged":
            return params, state
        return inner.update(grads, state, params, **kw)

    prof = Profiler() if trace else None
    traced = int(tr.get("trace_steps", 6))

    def loss_fn(params, fed):
        if fault == "token":  # a token of the fed batch altered where the feed produces it
            fed["data"][0, 0] = (fed["data"][0, 0] + 1) % int(cfg["vocab_size"])
        st["k"] += 1
        k, now = st["k"], time.perf_counter()
        if k <= checked:
            st["rows"].append(fed["data"].cpu().numpy())
        if k == checked + 1:  # the change after the checked steps, each leaf's first weights made again
            with torch.no_grad():
                st["change"] = {p: _norm(t, maker.make(p, tuple(t.shape), t.dtype))
                                for p, t in models.tree_paths(params)}
        if k == warm + 1:
            st["t_start"] = now
            st["setup_s"] = now - t0
            if trace:
                h = log.metrics.histogram("train_step_seconds", deployment=dep.deployment_id)
                st["hist0"] = (h.count, h.sum)
                prof.start()
        elif k > warm + 1:
            closing = now - st["t_start"] >= seconds
            if trace and prof.active and (k == warm + 1 + traced or closing):
                h = log.metrics.histogram("train_step_seconds", deployment=dep.deployment_id)
                st["hist1"] = (h.count, h.sum)
                st["traced_steps"] = k - warm - 1
                prof.stop()
            if closing:
                st["t_end"], st["steps"] = now, k - warm - 1
                raise WindowClosed
        tokens = fed["data"][: batch // 2] if fault == "half_batch" else fed["data"]
        loss, metrics = model.loss(params, {"tokens": tokens})
        if k <= checked:
            st["losses"].append(loss.detach())
        if k > warm:
            st["window_losses"].append(loss.detach())
        return loss, metrics

    job = TrainingJob(log, registry, dep.deployment_id, spec.model_id, loss_fn=loss_fn,
                      init_fn=lambda _gen: maker.fill_tree(model.param_tree()),
                      opt=Optimizer(inner.init, update, inner.state_pspecs), seed=0, device=device)
    try:
        job.run(batch_size=batch, max_steps=10**9, streaming=True)
    except WindowClosed:
        pass
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    window_s = st["t_end"] - st["t_start"]
    losses = [float(x) for x in st["losses"]]
    window_losses = [float(x) for x in st["window_losses"]]
    ctx = {}
    if trace:  # the per-layer metrics are the traced steps' (the profiler's stop is no step's time)
        (n0, s0), (n1, s1) = st["hist0"], st["hist1"]
        ctx = {
            "trace": prof.trace(), "traced_steps": st["traced_steps"],
            "steps": st["traced_steps"], "window_s": prof.window_s, "chips": cell.chips,
            "step_flops": conf.step_flops(cfg, batch, seq, {p: s for p, s, _ in layout}["embed"][0]),
            "kernel_calls": conf.kernel_calls(cfg, batch, seq),
            "opt8_leaves": [(shape, torch.empty((), dtype=dt).element_size()) for _, shape, dt in layout],
            "train_step_s": (s1 - s0) / max(n1 - n0, 1),
        }
    del job, model, inner, log
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the reference, on the same weights and the same rows
    index = {r.tobytes(): i for i, r in enumerate(corpus)}
    seen = [index.get(r.tobytes()) for step in st["rows"] for r in step]
    bad_rows = sum(i is None for i in seen) + len(seen) - len(set(seen))
    checks = [harness.Check("rows_not_in_corpus", float(bad_rows), 0.0),
              harness.Check("window_losses_not_finite", float(sum(not math.isfinite(x) for x in window_losses)), 0.0)]
    prog = {"losses": losses, "grad_norms": st["grad_norms"], "change_norms": st["change"]}
    readings = {"program": prog}
    if bad_rows == 0:
        rows = [[corpus[index[r.tobytes()]] for r in step] for step in st["rows"]]
        ref = reference_readings(cell, maker, layout, rows, against=st.pop("grads"), keep=bool(variants))
        first = ref.pop("grads", None)
        prog["grad_diff_norms"] = ref.pop("grad_diff_norms")
        readings["reference"] = ref
        checks += compare(cell, prog, ref)
        for prec, half in variants:  # each against the reference: the stand-in's difference from its gradient
            readings[f"{prec}{'_half' if half else ''}"] = reference_readings(cell, maker, layout, rows, prec, half,
                                                                               against=first)
    return {
        "correct": bad_rows == 0 and all(c.ok for c in checks),
        "attempted": st["steps"],
        "failed": sum(not math.isfinite(x) for x in window_losses),
        "metrics": {
            "train_tokens_per_s": st["steps"] * batch * seq / window_s,
            "peak_device_gb": peak / 1e9,
            "setup_s": st["setup_s"],
        },
        "memory_peak_bytes": peak,
        "checks": checks,
        "readings": readings,
        "ctx": ctx,
    }
