"""Dry run of every (arch x shape x mesh) cell: meta-device accounting
(port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell on 256 or 512 placeholder XLA
devices and reads XLA's cost and memory analyses. Here each cell's real
step (``build_train_step``'s step, ``prefill`` or ``decode_step``) runs
once on the **meta device** (shapes and dtypes, no storage, no
arithmetic) as rank 0 of a **fake process group** of the mesh's size,
under one dispatch mode (:class:`Counter`) that counts what rank 0 holds,
allocates, computes and sends. The kernel wrappers' meta branches
allocate what the card path allocates and hand in each kernel's work
(``kernels/cost.py``); a meta call launches nothing and moves no launch
count.

MUST be run as its own process (``python -m repro_torch.launch.dryrun``):
:func:`dry_mesh` initialises torch.distributed's default process group
with the fake backend, which is process-wide and would break any other
code of the process that builds a mesh. Callers (``chip_smoke.py``, the
tests) launch it as a subprocess.

The record of a cell (:func:`analyze`) has the reference's keys:

* ``flops_per_device``: the products (``torch.utils.flop_counter``'s
  registry: mm, addmm, bmm, baddbmm, convolutions, attention) plus each
  kernel's operations;
* ``bytes_accessed_per_device``: for every aten op on meta tensors that is
  not a view nor an allocation, its tensor inputs' and outputs' bytes
  (what eager execution moves, with no fusion; an in-place op counts its
  target read and written), plus each kernel's bytes;
* ``transcendentals``: the output elements of every exp, exp2, log, log2,
  log1p, expm1, tanh, sigmoid, silu, gelu, softplus, rsqrt and sqrt
  (in-place forms too), the input elements of every logsumexp, softmax and
  log_softmax, plus the kernels' own;
* ``memory_analysis``: ``argument_size_in_bytes`` (the rank's state blocks
  or parameters, its block of the batch, for decode the cache and the
  position), ``output_size_in_bytes`` (the step's outputs' distinct
  storages; a train step's state is updated in place, so it counts
  again) and ``temp_size_in_bytes`` (the peak of the storages the step
  allocated and still held, over the step: the step's peak less its
  arguments). XLA's ``generated_code_size_in_bytes`` has no counterpart:
  torch generates no code;
* ``collective_bytes_per_device`` and ``hlo_collective_counts``: each
  c10d call's kind (all-reduce, all-gather, reduce-scatter, all-to-all,
  collective-permute) and its result tensor's bytes, as the reference
  counts result shapes;
* ``compile_s``: the accounting's seconds (nothing compiles).

The record is rank 0's. Ranks differ: context-parallel attention gives
the last rank of the model axis the most (query, key) pairs and rank 0
the fewest; a sequence-split cache's last valid slot lies on one rank;
the vocab-parallel loss's label picks fall on the ranks that own them.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    python -m repro_torch.launch.dryrun --all --out build/dryrun_torch
    python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

import repro_torch.configs as configs
from repro_torch.kernels import cost
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models.model import ArchConfig, StreamModel
from repro_torch.models.policy import Policy
from repro_torch.models.sharding import Mesh, cut
from repro_torch.train.optimizer import adamw, adamw8bit, tree_leaves
from repro_torch.train.trainer import build_train_step

__all__ = [
    "FSDP_ARCHS", "HEAD_PAD_ARCHS", "MICROBATCH_ARCHS", "OPT8BIT_ARCHS", "REMAT_ARCHS", "SERVE_INT8_ARCHS",
    "Counter", "analyze", "argument_bytes", "cell_arguments", "dry_mesh", "effective_config", "lower_cell", "main",
    "make_production_mesh", "measure_cell", "policy_for", "run_cell",
]

# The tables are the reference's, value for value, so every cell is the
# reference's cell. Their reasons were measured on TPU v5e chips of 16 GB
# (the reference's EXPERIMENTS.md); here each rank is read as one H100 of
# 80 GB, and what fits is the records' to say.

# archs whose parameter+optimizer state needs ZeRO-3 over the data axis
FSDP_ARCHS = {
    "qwen3-moe-30b-a3b",
    "arctic-480b",
    "qwen2-7b",
    "yi-6b",
    "mistral-large-123b",
    "pixtral-12b",
    "recurrentgemma-9b",
    "gemma2-2b",   # attention params don't TP-shard (8 heads); ZeRO them
    "mamba2-2.7b",
}
# archs whose optimizer moments are 8-bit (the reference's DESIGN.md §4)
OPT8BIT_ARCHS = {"arctic-480b", "mistral-large-123b", "qwen3-moe-30b-a3b"}
# archs whose *serving* weights are int8-PTQ (the reference's 16 GB a
# chip); they also replicate the (tiny) decode token batch so the KV cache
# and expert d_ff can shard over the data axis too (flash-decode + 2D EP)
SERVE_INT8_ARCHS = {"arctic-480b", "mistral-large-123b"}
# pad query heads up to a multiple of the model axis so attention runs the
# collective-free "heads" strategy instead of context parallelism; on the
# reference's chips a win for arctic alone (its collective bytes halved).
# arctic's padded heads have head dim 7168 / 64 = 112, which K1 does not
# take on the card (64, 128, 256): its cells account for the call as made.
HEAD_PAD_ARCHS = {"arctic-480b": 64}
# gradient-accumulation microbatch count for train_4k: bounds the
# activation checkpoints a rank holds (n_layers x B_micro x S x d)
MICROBATCH_ARCHS = {
    "mistral-large-123b": 16,
    "arctic-480b": 8,
    "pixtral-12b": 8,
    "yi-6b": 4,
    "qwen3-moe-30b-a3b": 4,
    "mamba2-2.7b": 4,
    "recurrentgemma-9b": 4,
    "qwen2-7b": 2,
    "whisper-tiny": 2,
}
# remat policy per arch family for train_4k: 'full' keeps only each layer
# group's input and recomputes the group in its backward; 'block' would
# also keep every projection output (on the reference's gemma2 about 20 GB
# a chip more), so every arch takes 'full'
REMAT_ARCHS = {
    "arctic-480b": "full",
    "mistral-large-123b": "full",
    "qwen3-moe-30b-a3b": "full",
    "qwen2-7b": "full",
    "yi-6b": "full",
    "pixtral-12b": "full",
    "recurrentgemma-9b": "full",
    "gemma2-2b": "full",
    "mamba2-2.7b": "full",
    "whisper-tiny": "full",
}

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
# c10d's ops (what torch.distributed's calls dispatch to) -> the reference's kind
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
# ops that allocate and move nothing
_ALLOCATIONS = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided"}
# ops whose output elements each take a transcendental; and those whose input elements do
_TRANSCENDENTAL = {"exp", "exp2", "log", "log2", "log1p", "expm1", "tanh", "sigmoid", "silu", "gelu", "softplus",
                   "rsqrt", "sqrt"}
_TRANSCENDENTAL_IN = {"logsumexp", "_softmax", "_log_softmax"}


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    if isinstance(x, dict):
        return [t for e in x.values() for t in _tensors(e)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counter(TorchDispatchMode):
    """The counting mode of one cell: every aten op on meta tensors, every
    c10d call and every kernel wrapper's meta call (``cost.record``) while
    it is active. ``flops``, ``bytes`` and ``transcendentals`` sum the
    ops' and the kernels' (``kernels`` keeps each kernel's calls and work
    apart); ``collectives`` maps a kind to [calls, result bytes];
    ``peak`` is the most bytes of storages allocated under the mode and
    alive at once (each storage held by a weak reference: the mode keeps
    nothing alive). With ``collectives_only`` only the c10d calls are
    counted (what a real step on the card or on gloo ranks can afford)."""

    def __init__(self, collectives_only: bool = False):
        super().__init__()
        self.collectives_only = collectives_only
        self.flops = self.bytes = self.transcendentals = 0
        self.kernels: dict[str, dict] = {}
        self.collectives = {k: [0, 0] for k in COLLECTIVE_KINDS}
        self.live = self.peak = 0
        self._sizes: dict[int, int] = {}
        self._refs: dict[int, weakref.ref] = {}

    def __enter__(self):
        cost._SINKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        cost._SINKS.remove(self._kernel)
        return super().__exit__(*exc)

    def _kernel(self, name: str, work: cost.Work) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0, "transcendentals": 0})
        k["calls"] += 1
        for field in ("flops", "bytes", "transcendentals"):
            k[field] += getattr(work, field)
        self.flops += work.flops
        self.bytes += work.bytes
        self.transcendentals += work.transcendentals

    def _free(self, key: int, _ref) -> None:
        self.live -= self._sizes.pop(key)
        self._refs.pop(key, None)

    def _allocated(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        self._sizes[key] = st.nbytes()
        self._refs[key] = weakref.ref(st, lambda r, key=key: self._free(key, r))
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        if name.startswith("c10d::"):
            kind = _C10D_KINDS.get(name.split("::", 1)[1])
            if kind is not None:
                self.collectives[kind][0] += 1
                self.collectives[kind][1] += sum(_nbytes(t) for t in _tensors(args[0]))
            return out
        if self.collectives_only:
            return out
        ins = [t for t in _tensors((args, kwargs)) if t.device.type == "meta"]
        outs = [t for t in _tensors(out) if t.device.type == "meta"]
        if not outs and not ins:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        base = name.split("::", 1)[1]
        returns = func._schema.returns
        is_view = any(r.alias_info is not None and not r.alias_info.is_write for r in returns)
        if not is_view and base not in _ALLOCATIONS:
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if base.rstrip("_") in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        elif base in _TRANSCENDENTAL_IN and ins:
            self.transcendentals += ins[0].numel()
        if all(r.alias_info is None for r in returns):  # fresh storages
            for t in outs:
                self._allocated(t)
        return out


# ------------------------------------------------------------------ meshes
def dry_mesh(shape, axes) -> Mesh:
    """The port's ``Mesh`` of ``shape`` over ``axes`` with meta tensors,
    this process rank 0 of torch.distributed's default process group on
    the fake backend, of the mesh's size (a default group of another size
    is destroyed first). Raises where this torch has no fake backend: the
    dry run has no other."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(f"this torch ({torch.__version__}) has no fake process group backend") from e
    world = math.prod(shape)
    if dist.is_initialized() and dist.get_world_size() != world:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return Mesh(shape, axes, device="meta")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's accounting layouts on the fake group: (16, 16) over
    ("data", "model"), or (2, 16, 16) over ("pod", "data", "model"); each
    rank read as one H100 of 80 GB (no claim about a machine of them)."""
    if multi_pod:
        return dry_mesh((2, 16, 16), ("pod", "data", "model"))
    return dry_mesh((16, 16), ("data", "model"))


def _mesh_name(multi_pod: bool) -> str:
    return "multi" if multi_pod else "single"


# ----------------------------------------------------------------- a cell
def policy_for(cfg: ArchConfig, shape: configs.ShapeCell, mesh) -> Policy:
    """The reference's policy of a cell, field for field (``unroll`` has no
    torch counterpart). ``mesh`` needs ``axis_names`` and ``shape``."""
    sizes = mesh_axis_sizes(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    fsdp = ("data",) if (cfg.name in FSDP_ARCHS and shape.kind == "train") else ()
    seq_axis = None
    weights_int8 = False
    ep_inner: tuple = ()
    big_serve = cfg.name in SERVE_INT8_ARCHS and shape.kind in ("prefill", "decode")
    if big_serve:
        weights_int8 = True
    if shape.kind == "decode":
        dp = 1
        for a in batch_axes:
            dp *= sizes[a]
        # flash-decode streams a seq-sharded cache everywhere a cache
        # exists; the batch stays on the data axes when it covers them
        if shape.global_batch < dp or big_serve:
            batch_axes = ()
            seq_axis = tuple(a for a in ("pod", "data", "model") if a in sizes)
            if big_serve and cfg.moe is not None:
                ep_inner = tuple(a for a in ("pod", "data") if a in sizes)
        else:
            seq_axis = "model"
        if cfg.n_heads == 0:  # attention-free (mamba2): no kv cache to shard
            seq_axis = None
    if big_serve and shape.kind == "prefill" and cfg.moe is not None:
        # arctic prefill: int8 expert weights still need the data axis
        fsdp = ("data",)
    remat = REMAT_ARCHS.get(cfg.name, "none") if shape.kind == "train" else "none"
    # arctic/mistral-large take full ZeRO (even 8-bit moments of TP-sharded
    # leaves overflowed the reference's chips); the rest ZeRO only the
    # params with no tensor-parallel dim
    selective = cfg.name not in OPT8BIT_ARCHS
    return Policy(
        mesh_axes=sizes,
        batch_axes=batch_axes,
        tp_axis="model",
        fsdp_axes=fsdp,
        fsdp_selective=selective,
        seq_axis=seq_axis,
        remat=remat,
        weights_int8=weights_int8,
        ep_inner_axes=ep_inner,
        kv_cache_dtype="float8_e4m3fn" if (big_serve and shape.kind == "decode") else "bfloat16",
    )


def _optimizer(cfg: ArchConfig):
    return adamw8bit(1e-4) if cfg.name in OPT8BIT_ARCHS else adamw(1e-4)


def _serving_params(model: StreamModel) -> dict:
    """The parameters of a prefill or decode cell: the rank's blocks, as
    int8 codes and scales where the policy says so (the model holds them
    as ``quantize_params`` leaves them, cut by ``quantized_pspecs``)."""
    return model.param_tree()


def effective_config(arch_id: str):
    cfg = configs.get(arch_id)
    if arch_id in HEAD_PAD_ARCHS:
        cfg = dataclasses.replace(cfg, n_heads=HEAD_PAD_ARCHS[arch_id])
    return cfg


def _rank_rows(t: torch.Tensor, pol: Policy, mesh: Mesh) -> torch.Tensor:
    """Rank 0's block of a batch input (its rows, by ``batch_spec``), a
    tensor of its own."""
    return cut(t, (pol.batch_spec(t.shape[0]),), mesh)


def cell_arguments(model: StreamModel, shape: configs.ShapeCell, mesh: Mesh, *, opt=None, microbatches: int = 1):
    """What rank 0 holds before its step, and the step: ``(args, step)``,
    where ``args`` are the step's arguments (the reference's: the state,
    or the parameters and for decode the cache; the rank's block of the
    batch; for decode the position) and ``step()`` runs the cell's step
    on them (``build_train_step``'s with ``opt`` and ``microbatches``,
    ``prefill`` or ``decode_step``; serving passes the whole batch on
    every rank, as the port's serving does)."""
    cfg, pol = model.cfg, model.policy
    inputs = configs.input_specs(cfg, shape)
    rows = {k: _rank_rows(v, pol, mesh) for k, v in inputs.items()}
    if shape.kind == "train":
        params = model.param_tree()
        for p in tree_leaves(params):
            p.requires_grad_(True)
        opt = _optimizer(cfg) if opt is None else opt
        state = {"params": params, "opt": opt.init(params, mesh=mesh, pspecs=model.param_pspecs())}
        step_fn, _ = build_train_step(model, opt, microbatches=microbatches, mesh=mesh)
        return {"state": state, "batch": rows}, lambda: step_fn(state, rows)
    params = _serving_params(model)
    if shape.kind == "prefill":
        return {"params": params, "batch": rows}, lambda: model.prefill(
            inputs["tokens"], shape.seq_len, patch_embeds=inputs.get("patch_embeds"), frames=inputs.get("frames"))
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return ({"params": params, "cache": cache, "batch": rows, "pos": pos},
            lambda: model.decode_step(cache, inputs["tokens"], pos))


def argument_bytes(args: dict) -> int:
    """The bytes of a cell's arguments (``cell_arguments``'): every tensor
    of them, on any device."""
    return sum(_nbytes(t) for t in _tensors(args))


def lower_cell(arch_id: str, shape_name: str, mesh: Mesh, *, cfg: ArchConfig | None = None,
               shape: configs.ShapeCell | None = None, policy: Policy | None = None, opt=None,
               microbatches: int | None = None):
    """Run one cell's step on the meta device under a :class:`Counter`.
    Returns (counter, meta): meta holds the cfg, shape, policy, the
    argument and output bytes and, for train, the microbatches k the step
    took. The cell is the reference's unless ``cfg``, ``shape``,
    ``policy``, ``opt`` or ``microbatches`` (train) say otherwise."""
    cfg = effective_config(arch_id) if cfg is None else cfg
    shape = configs.SHAPES[shape_name] if shape is None else shape
    pol = policy_for(cfg, shape, mesh) if policy is None else policy
    model = StreamModel(cfg, pol, mesh=mesh, generator=None)
    want = MICROBATCH_ARCHS.get(cfg.name, 1) if microbatches is None else microbatches
    args, step = cell_arguments(model, shape, mesh, opt=opt, microbatches=want)
    meta = {"cfg": cfg, "shape": shape, "policy": pol, "argument_bytes": argument_bytes(args)}
    if shape.kind == "train":  # build_train_step's k: a rank holds its own rows
        meta["microbatches"] = min(want, max(next(iter(args["batch"].values())).shape[0], 1))
    with Counter() as counter:
        out = step()
    meta["output_bytes"] = sum(st.nbytes() for st in {t.untyped_storage()._cdata: t.untyped_storage()
                                                       for t in _tensors(out)}.values())
    return counter, meta


def analyze(counter: Counter, mesh: Mesh, meta: dict) -> dict:
    """The reference's record keys from a cell's :class:`Counter` (rank 0's
    numbers; see the module's docstring for what each counts)."""
    return {
        "devices": mesh.world,
        "flops_per_device": float(counter.flops),
        "bytes_accessed_per_device": float(counter.bytes),
        "transcendentals": float(counter.transcendentals),
        "memory_analysis": {
            "argument_size_in_bytes": meta["argument_bytes"],
            "output_size_in_bytes": meta["output_bytes"],
            "temp_size_in_bytes": counter.peak,
        },
        "collective_bytes_per_device": {k: b for k, (n, b) in counter.collectives.items() if n},
        "hlo_collective_counts": {k: n for k, (n, _) in counter.collectives.items()},
        "kernels": counter.kernels,
    }


def measure_cell(arch_id: str, shape_name: str, multi_pod: bool, out_dir: str | None):
    """Depth-extrapolated cost (the reference's ``--measure``): the 1-group
    and 2-group cells with microbatching off, extrapolated linearly in
    depth, cost(L) = c1 + (c2 - c1) (L / p - 1). The reference needs it
    because XLA's cost analysis visits a loop body once; in torch every
    layer runs, so the extrapolation equals the full-depth count, and the
    full-depth record keeps the authoritative numbers."""
    ok, _ = configs.cell_supported(arch_id, shape_name)
    tag = f"{arch_id}__{shape_name}__{_mesh_name(multi_pod)}"
    if not ok:
        return None
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg_full = effective_config(arch_id)
    p = len(cfg_full.pattern)
    t0 = time.time()

    def one(groups: int) -> dict:
        cfg = dataclasses.replace(cfg_full, n_layers=groups * p)
        counter, _ = lower_cell(arch_id, shape_name, mesh, cfg=cfg, microbatches=1)
        return {"flops": float(counter.flops), "bytes": float(counter.bytes),
                "coll": {k: b for k, (n, b) in counter.collectives.items() if n}}

    try:
        c1 = one(1)
        c2 = one(2)
        g_full = cfg_full.n_layers / p

        def extra(a, b):
            return max(a + (b - a) * (g_full - 1), 0.0)

        coll_kinds = set(c1["coll"]) | set(c2["coll"])
        rec = {
            "cell": tag,
            "status": "OK",
            "measure_s": round(time.time() - t0, 1),
            "groups_full": g_full,
            "flops_per_device": extra(c1["flops"], c2["flops"]),
            "bytes_accessed_per_device": extra(c1["bytes"], c2["bytes"]),
            "collective_bytes_per_device": {
                k: extra(c1["coll"].get(k, 0), c2["coll"].get(k, 0)) for k in coll_kinds
            },
            "raw": {"g1": c1, "g2": c2},
        }
        print(f"** measured {tag}: flops/dev {rec['flops_per_device']:.3e} "
              f"bytes/dev {rec['bytes_accessed_per_device']:.3e} ({rec['measure_s']}s)")
    except Exception as e:
        rec = {"cell": tag, "status": "FAIL", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-3000:]}
        print(f"** measured {tag}: FAIL {rec['error']}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".measured.json"), "w") as f:
            json.dump(rec, f, indent=2)
    return rec


def run_cell(arch_id: str, shape_name: str, multi_pod: bool, out_dir: str | None):
    ok, why = configs.cell_supported(arch_id, shape_name)
    tag = f"{arch_id}__{shape_name}__{_mesh_name(multi_pod)}"
    if not ok:
        rec = {"cell": tag, "status": "SKIP", "reason": why}
        print(json.dumps(rec))
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=2)
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    try:
        counter, meta = lower_cell(arch_id, shape_name, mesh)
        stats = analyze(counter, mesh, meta)
        rec = {
            "cell": tag,
            "status": "OK",
            "compile_s": round(time.time() - t0, 1),
            "mesh": list(mesh.shape),
            **stats,
        }
        if "microbatches" in meta:
            rec["microbatches"] = meta["microbatches"]
        mem = stats["memory_analysis"]
        print(f"== {tag}: OK in {rec['compile_s']}s")
        print(f"   memory_analysis: {mem}")
        print(
            f"   cost: flops/dev={stats['flops_per_device']:.3e} "
            f"bytes/dev={stats['bytes_accessed_per_device']:.3e}"
        )
        print(f"   collectives: {stats['collective_bytes_per_device']}")
    except Exception as e:
        rec = {
            "cell": tag,
            "status": "FAIL",
            "compile_s": round(time.time() - t0, 1),
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
        print(f"== {tag}: FAIL {rec['error']}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=2)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--measure", action="store_true",
                    help="depth-extrapolated cost measurement instead of the full-depth step")
    args = ap.parse_args()

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    cells = []
    archs = configs.names() if (args.all or args.arch is None) else [args.arch]
    shapes = list(configs.SHAPES) if (args.all or args.shape is None) else [args.shape]
    fails = 0
    for mp in meshes:
        for a in archs:
            for s in shapes:
                if args.measure:
                    rec = measure_cell(a, s, mp, args.out)
                    if rec is None:
                        continue
                else:
                    rec = run_cell(a, s, mp, args.out)
                cells.append(rec)
                fails += rec["status"] == "FAIL"
    print(f"\n{len(cells)} cells: "
          f"{sum(r['status'] == 'OK' for r in cells)} OK, "
          f"{sum(r['status'] == 'SKIP' for r in cells)} SKIP, {fails} FAIL")
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
