"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``
(port of ``repro.launch.train``).

Builds the (reduced or full) architecture, streams a synthetic corpus into
the distributed log, and runs the training step on a device mesh with
checkpoint/restart, as the JAX launcher does. ``--mesh local`` is one rank
a card (NCCL), a ``(n,)`` mesh over ``("data",)``: the ranks are spawned
processes that meet through a ``FileStore`` in a temporary directory and
are joined by ``--deadline`` seconds, killed past it. ``--device cpu``
runs ``--ranks`` gloo ranks instead (the tests). The reference's
production meshes are TPU pods, which do not carry over: ``--mesh
production`` and ``production-multi`` raise, as ``make_production_mesh``
does. Rank 0 prints the JAX launcher's lines.
"""

from __future__ import annotations

import argparse
import datetime
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

import repro_torch.configs as configs
import repro_torch.core as core
import repro_torch.data as data
from repro_torch.data.formats import RawCodec
from repro_torch.data.pipeline import ShardedFeeder
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.model import StreamModel
from repro_torch.models.policy import Policy
from repro_torch.train import adamw, checkpoint as ck, cosine_schedule
from repro_torch.train.trainer import build_train_step, make_state


def parse(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.names())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", choices=["local", "production", "production-multi"], default="local")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=None, help="ranks of the local mesh (default: every card; 1 on the CPU)")
    ap.add_argument("--deadline", type=float, default=3600.0, help="seconds by which every rank must have ended")
    return ap.parse_args(argv)


def run_rank(rank: int, world: int, store: str, args: argparse.Namespace) -> None:
    """One rank: its process group, the mesh, the stream, the steps."""
    import torch.distributed as dist

    cuda = args.device != "cpu"
    if cuda:
        torch.cuda.set_device(rank)
    else:  # the host's cores shared among the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = f"cuda:{rank}" if cuda else "cpu"
    dist.init_process_group("nccl" if cuda else "gloo", store=dist.FileStore(os.path.join(store, "store"), world),
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=args.deadline),
                            **({"device_id": torch.device(dev)} if cuda else {}))
    try:
        train(rank, args, make_mesh((world,), ("data",), device=dev))
    finally:
        dist.destroy_process_group()


def train(rank: int, args: argparse.Namespace, mesh) -> None:
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = configs.get_reduced(args.arch) if args.reduced else configs.get(args.arch)
    pol = Policy.for_mesh(mesh)
    model = StreamModel(cfg, pol, generator=None, mesh=mesh)
    say(f"arch={cfg.name} params={cfg.param_count():,} mesh={dict(mesh.sizes)}", flush=True)

    # stream a synthetic corpus through the log (the paper's pipeline); every
    # rank streams the same corpus and the feeder deals it its rows
    log, registry = core.StreamLog(), core.Registry()
    spec = registry.register_model(args.arch)
    config = registry.create_configuration([spec.model_id])
    dep = registry.deploy(config.config_id, "train")
    rng = np.random.default_rng(0)
    corpus = rng.integers(0, cfg.vocab, (max(args.batch * 8, 64), args.seq)).astype(np.int32)
    codec = RawCodec("int32", (args.seq,), "int32", ())
    log.create_topic("corpus")
    msg = data.ingest(log, "corpus", codec, {"data": corpus, "label": np.zeros(len(corpus), np.int32)},
                      dep.deployment_id)
    got, _ = core.poll_control(log, dep.deployment_id)
    train_arrays, _ = data.StreamDataset(log, got).split()

    opt = adamw(cosine_schedule(3e-4, 10, args.steps))
    step_fn, specs = build_train_step(model, opt, mesh=mesh, microbatches=args.microbatches)
    state = make_state(model, opt, 0)
    start = 0
    mgr = ck.CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if args.resume and mgr and mgr.latest() is not None:
        state, offsets, meta = ck.restore(args.ckpt_dir, state, mesh=mesh, pspecs=specs)
        start = int(meta.get("next_step", 0))
        say(f"resumed from step {start}", flush=True)
    it = iter(data.BatchIterator(train_arrays, args.batch, seed=0, epochs=None))
    feeder = ShardedFeeder(mesh, pol.batch_axes or ("data",))
    metrics = {"loss": float("nan")}
    for i in range(start, args.steps):
        host = next(it)
        batch = feeder.place({"tokens": host["data"]})
        state, metrics = step_fn(state, batch)
        if (i + 1) % 10 == 0 or i + 1 == args.steps:
            say(f"step {i+1}: loss {float(metrics['loss']):.4f}", flush=True)
            if mgr:
                mgr.save_async(i + 1, state, offsets={str(r): r.end for r in msg.ranges},
                               meta={"next_step": i + 1}, mesh=mesh, pspecs=specs)
    if mgr:
        mgr.wait()
    registry.upload_result(dep.deployment_id, spec.model_id, {"loss": float(metrics["loss"])},
                           artifact_path=args.ckpt_dir)
    say("done; result registered", flush=True)


def main(argv: list[str] | None = None) -> int:
    args = parse(argv)
    if args.mesh != "local":
        make_production_mesh(multi_pod=args.mesh == "production-multi")
    cuda = args.device != "cpu"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on gloo ranks of the CPU")
    world = args.ranks or (torch.cuda.device_count() if cuda else 1)
    store = tempfile.mkdtemp(prefix="train_store_")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run_rank, args=(r, world, store, args)) for r in range(world)]
    try:
        for p in procs:
            p.start()
        end = time.monotonic() + args.deadline
        for p in procs:
            p.join(max(end - time.monotonic(), 0.1))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        failed = [r for r, p in enumerate(procs) if p.exitcode not in (0, None)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store, ignore_errors=True)
    if late or failed:
        print(f"ranks past the deadline {late}, ranks failed {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
