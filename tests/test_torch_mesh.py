"""Training on a device mesh in the port against the JAX package, on the CPU.

The port's ranks are 4 ``gloo`` processes, each a subprocess running this
file as a script (``python tests/test_torch_mesh.py <role> ...``) that
meet through a ``FileStore`` in the test's temporary directory (no port,
no network) with an init timeout; every subprocess is joined with a
deadline and killed past it, failing the test. The reference runs in one
subprocess on a 4-device CPU mesh
(``--xla_force_host_platform_device_count=4``), as the pytest process has
started JAX with one device. Arrays travel through ``.npz`` files. One
run of the 4 ranks and one of the reference serve every test here (a
module fixture), each torch process on one thread.

The cases (``CASES``), each reduced, f32, B = 8 rows, 3 AdamW steps at lr
1e-3 from the same seeded weights and batch: yi-6b on (data 2, model 2)
with ZeRO-3 over ``data``, selective and not; arctic on (2, 2), whose 7
heads take the ``"seq"`` strategy beside its 8 experts split 4 a rank and
its dense residual; mamba2 and recurrentgemma on (2, 2); gemma2 on (1, 4),
``"seq"`` with its window of 16 and softcap at S 32; whisper on (1, 4),
``"seq"`` over the decoder with cross attention, its encoder's 24 frames
``"seq"`` too.

Tolerances, measured on this container (the largest gap over the cases in
brackets): the losses at LOSS_RTOL 1e-5 relative against the reference's
mesh step [9.7e-7, gemma2] and against the port's one-process step
[4.8e-7]; the first step's gradients, summed and gathered, against
``jax.grad`` of the reference's loss at GRAD_TOL 1e-4 of each leaf's
largest element [4.5e-5, recurrentgemma's ``b_a``, where the port in one
process is 5.0e-5 from JAX too: its sequential scan against JAX's
associative one] and against the port's one-process gradients at
PORT_GRAD_TOL 3e-5 [1.1e-5, mamba2]; the parameters after each of the 3
steps, leaf by leaf: the largest gap at PARAM_ATOL 1e-3, one step of lr
1e-3 [1.8e-4 against JAX, 5.3e-5 against one process]: AdamW's step
g / (|g| + 1e-8) turns the rounding of a gradient element near its eps
into up to a whole step; and the mean gap of each leaf at PARAM_LEAF_RTOL
1e-3 of that leaf's mean movement from the initial weights [8.6e-5,
recurrentgemma's 2048-element leaf 30 after step 3, against JAX; 5.0e-5
against one process], so a small leaf (a norm, a bias, the router) that
a rank updates wrongly fails however few elements it has.

The elastic restart (JAX's ``tests/test_elastic.py``): state saved on
(2, 2) after one step, restored onto (2, 2), (4, 1) and (1, 4), bit for
bit, and the second step taken. On (2, 2) the loss equals the
uninterrupted run's to the bit (10 digits, as the reference checks). On
another shape the model and data axes' partial sums (row-parallel
products, the vocab-parallel log-sum-exp, the loss's sum over the data
shards) are other sums of the same terms, so there the loss is held
within ELASTIC_ULPS 2 units in the last place of the f32 loss [on (4, 1)
one ulp, 4.77e-7 at 5.4234, in two runs on the same seeds; (1, 4) the
same bits]; the restored state itself is held to the bit on every shape.
A checkpoint the reference saved on its (2, 2) mesh restores onto the
port's (1, 4) mesh and the second loss equals the reference's at
LOSS_RTOL [the same bits in the measured run].
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_dp import _load, _save

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
DEADLINE_S = 300.0  # the whole multi-process run: every subprocess joined by then
INIT_TIMEOUT_S = 120  # gloo's rendezvous and collectives
ROWS = 8
STEPS = 3
LR = 1e-3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # against JAX
PORT_GRAD_TOL = 3e-5  # against the port in one process
PARAM_ATOL = 1e-3
PARAM_LEAF_RTOL = 1e-3
ELASTIC_ULPS = 2
STRADDLE_D_FF = 640  # 320 columns a rank: 1.25 quantization blocks of 256
SERVE_ROWS, SERVE_PROMPT, SERVE_CACHE = 4, 8, 16  # the serving check: rows, prompt tokens, cache slots
SERVE_TOL = 1e-5

CASES = {
    "yi-zero3-selective": {"arch": "yi-6b", "shape": [2, 2], "fsdp": "selective", "seq": 16},
    "yi-zero3-full": {"arch": "yi-6b", "shape": [2, 2], "fsdp": "full", "seq": 16},
    "arctic-seq-ep": {"arch": "arctic-480b", "shape": [2, 2], "fsdp": None, "seq": 16},
    "mamba2": {"arch": "mamba2-2.7b", "shape": [2, 2], "fsdp": None, "seq": 32},
    "recurrentgemma": {"arch": "recurrentgemma-9b", "shape": [2, 2], "fsdp": None, "seq": 32},
    "gemma2-seq-window": {"arch": "gemma2-2b", "shape": [1, 4], "fsdp": None, "seq": 32},
    "whisper-seq-cross": {"arch": "whisper-tiny", "shape": [1, 4], "fsdp": None, "seq": 16},
}
ELASTIC_SHAPES = [[2, 2], [4, 1], [1, 4]]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ subprocesses
def _env(jax_devices: int | None = None) -> dict:
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    if jax_devices is not None:
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={jax_devices}"
    return env


def _run_all(jobs: list[tuple[list[str], dict]]) -> None:
    """Start every ``(args, env)`` of this script at once, join each by
    DEADLINE_S from the start, kill them all past it and fail; fail on a
    non-zero exit with its output."""
    procs = [subprocess.Popen([sys.executable, __file__, *args], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for args, env in jobs]
    end = time.monotonic() + DEADLINE_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(end - time.monotonic(), 0.1))[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"{[a for a, _ in jobs]} did not end within {DEADLINE_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for (args, _), p, out in zip(jobs, procs, outs):
        assert p.returncode == 0, f"{args}: exit {p.returncode}\n{out[-6000:]}"


def _init_group(rank: int, d: Path) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"), WORLD), rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))


def _cfg(arch: str, **over):
    import repro_torch.configs as TC

    return dataclasses.replace(TC.get_reduced(arch), **over)


def _policy(case: dict, mesh):
    from repro_torch.models.policy import Policy

    fsdp = case.get("fsdp")
    return Policy.for_mesh(mesh, param_dtype="float32", compute_dtype="float32", kv_cache_dtype="float32",
                           fsdp_axes=("data",) if fsdp else (), fsdp_selective=fsdp != "full")


def _rows(batch: dict, mesh) -> dict:
    """This rank's rows of the global batch (its data coordinate's)."""
    n, k = mesh.size("data"), mesh.coord("data")
    return {key: v[k * ROWS // n:(k + 1) * ROWS // n] for key, v in batch.items()}


def _recording(opt):
    """``opt`` that keeps a copy of each update's gradients (leaf order)."""
    from repro_torch.train import Optimizer
    from repro_torch.train.optimizer import tree_leaves

    seen = []

    def update(grads, state, params, **kw):
        seen.append([g.detach().clone() for g in tree_leaves(grads)])
        return opt.update(grads, state, params, **kw)

    return Optimizer(opt.init, update, opt.state_pspecs), seen


# ------------------------------------------------------------ the port's ranks
def _mesh_model(case: dict, mesh, params_path: Path, **over):
    from repro_torch.models import sharding as SH
    from repro_torch.models.model import StreamModel

    m = StreamModel(_cfg(case["arch"], **over), _policy(case, mesh), device="cpu", generator=None, mesh=mesh)
    m.load_params(SH.shard_tree(_load(params_path), m.param_pspecs(), mesh))
    return m


def _train_case(rank: int, d: Path, name: str, case: dict) -> None:
    """STEPS steps of the mesh step on this rank's rows; rank 0 saves the
    losses, the gathered first-step gradients and the gathered parameters
    after each step to ``port_<name>.npz``."""
    from repro_torch.launch import make_mesh
    from repro_torch.models import sharding as SH
    from repro_torch.train import adamw, build_train_step
    from repro_torch.train.optimizer import tree_leaves

    mesh = make_mesh(case["shape"], ("data", "model"), device="cpu")
    m = _mesh_model(case, mesh, d / f"params_{name}.npz")
    opt, seen = _recording(adamw(LR))
    params = m.param_tree()
    for p in tree_leaves(params):
        p.requires_grad_(True)
    state = {"params": params, "opt": opt.init(params, mesh=mesh, pspecs=m.param_pspecs())}
    step, specs = build_train_step(m, opt, mesh=mesh)
    batch = _rows(_load(d / f"batch_{name}.npz"), mesh)
    leaf_specs = tree_leaves(specs["params"])
    out = {"losses": [], "params": {}}
    for i in range(STEPS):
        state, met = step(state, batch)
        out["losses"].append(float(met["loss"]))
        out["params"][str(i)] = SH.gather_tree(state["params"], specs["params"], mesh)
    grads0 = [SH.gather(g, s, mesh) for g, s in zip(seen[0], leaf_specs)]
    if rank == 0:
        out["losses"] = np.asarray(out["losses"], np.float32)
        out["grads0"] = {str(i): g for i, g in enumerate(grads0)}
        _save(d / f"port_{name}.npz", out)


def _straddle(rank: int, d: Path) -> None:
    """Two ``adamw8bit`` updates of reduced yi-6b (d_ff STRADDLE_D_FF) on
    (2, 2) from the same dense gradients as the unsharded test; rank 0
    saves the gathered parameters and state."""
    from repro_torch.launch import make_mesh
    from repro_torch.models import sharding as SH
    from repro_torch.train import adamw8bit, state_pspecs

    case = {"arch": "yi-6b", "fsdp": None}
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    m = _mesh_model(case, mesh, d / "params_straddle.npz", d_ff=STRADDLE_D_FF)
    opt = adamw8bit(LR)
    pspecs = m.param_pspecs()
    params = m.param_tree()
    state = opt.init(params, mesh=mesh, pspecs=pspecs)
    for i in range(2):
        grads = SH.shard_tree(_load(d / f"grads_straddle_{i}.npz"), pspecs, mesh)
        opt.update(grads, state, params, mesh=mesh, pspecs=pspecs)
    specs = state_pspecs(m, opt)
    dense = SH.gather_tree({"params": params, "opt": state}, specs, mesh)
    if rank == 0:
        _save(d / "port_straddle.npz", dense)


def _feeder(rank: int, d: Path) -> None:
    """``ShardedFeeder`` on (2, 2): the rows each rank gets of 4 batches,
    and the error a failing source raises at the consumer."""
    from repro_torch.data.pipeline import ShardedFeeder
    from repro_torch.launch import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    feeder = ShardedFeeder(mesh, ("data",), prefetch=2)
    batches = [{"x": np.arange(ROWS * 3).reshape(ROWS, 3) + 100 * i} for i in range(4)]
    got = [b["x"] for b in feeder(iter(batches))]

    def failing():
        yield batches[0]
        raise RuntimeError("the source failed")

    err = ""
    try:
        for _ in feeder(failing()):
            pass
    except RuntimeError as e:
        err = str(e)
    _save(d / f"feeder_{rank}.npz", {"rows": np.stack([g.numpy() for g in got])})
    (d / f"feeder_{rank}.json").write_text(json.dumps({"err": err}))


def _serving(rank: int, d: Path) -> None:
    """The serving entry points on the (2, 2) mesh of the ZeRO-3 case, with
    the decode cache's sequence split over the model axis
    (``seq_axis="model"``): ``forward`` over SERVE_ROWS rows (split over
    the data axis) of the case's tokens, ``prefill`` of their first
    SERVE_PROMPT tokens into an f32 cache of SERVE_CACHE slots, then
    ``decode_step`` on each next token; rank 0 saves the logits to
    ``serving.npz``."""
    from repro_torch.launch import make_mesh
    from repro_torch.models import sharding as SH
    from repro_torch.models.model import StreamModel

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    case = CASES["yi-zero3-selective"]
    m = StreamModel(_cfg(case["arch"]), dataclasses.replace(_policy(case, mesh), seq_axis="model"), device="cpu",
                    generator=None, mesh=mesh)
    m.load_params(SH.shard_tree(_load(d / "params_yi-zero3-selective.npz"), m.param_pspecs(), mesh))
    tokens = _load(d / "batch_yi-zero3-selective.npz")["tokens"][:SERVE_ROWS].long()
    out = {"forward": m(tokens)}
    lg, caches = m.prefill(tokens[:, :SERVE_PROMPT], SERVE_CACHE, cache_dtype=torch.float32)
    steps = [lg]
    for i in range(SERVE_PROMPT, tokens.shape[1]):
        lg, caches = m.decode_step(caches, tokens[:, i:i + 1])
        steps.append(lg[:, 0])
    out["steps"] = torch.stack(steps)
    if rank == 0:
        _save(d / "serving.npz", out)


def _elastic(rank: int, d: Path) -> None:
    """JAX's elastic test on the port: one step on (2, 2), a checkpoint,
    a second step (the uninterrupted run); then the checkpoint restored
    onto each of ELASTIC_SHAPES (its state gathered back, to compare with
    the saved arrays) and a second step there; then the reference's
    checkpoint restored onto (1, 4) and a second step."""
    from repro_torch.launch import make_mesh
    from repro_torch.models import sharding as SH
    from repro_torch.train import adamw, build_train_step, checkpoint as ck
    from repro_torch.train.optimizer import tree_leaves

    case = {"arch": "yi-6b", "fsdp": None}
    batch = _load(d / "batch_elastic.npz")
    out = {}

    def fresh(shape):
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        m = _mesh_model(case, mesh, d / "params_elastic.npz")
        opt = adamw(LR)
        params = m.param_tree()
        for p in tree_leaves(params):
            p.requires_grad_(True)
        state = {"params": params, "opt": opt.init(params, mesh=mesh, pspecs=m.param_pspecs())}
        step, specs = build_train_step(m, opt, mesh=mesh)
        return mesh, state, step, specs

    mesh, state, step, specs = fresh((2, 2))
    state, met = step(state, _rows(batch, mesh))
    out["loss1"] = float(met["loss"])
    ck.save(str(d / "ck_port"), 1, state, meta={"loss": out["loss1"]}, mesh=mesh, pspecs=specs)
    state, met = step(state, _rows(batch, mesh))
    out["loss2"] = float(met["loss"])
    for shape in ELASTIC_SHAPES:
        tag = f"{shape[0]}x{shape[1]}"
        mesh, state, step, specs = fresh(shape)
        state, _, meta = ck.restore(str(d / "ck_port"), state, mesh=mesh, pspecs=specs)
        restored = SH.gather_tree(state, specs, mesh)
        state, met = step(state, _rows(batch, mesh))
        out[f"loss2_{tag}"] = float(met["loss"])
        if rank == 0:
            _save(d / f"elastic_state_{tag}.npz", restored)
    end = time.monotonic() + DEADLINE_S
    while not (d / "ck_jax" / "step_1" / "manifest.json").exists():
        if time.monotonic() > end:
            raise TimeoutError("the reference's checkpoint did not appear")
        time.sleep(0.5)
    mesh, state, step, specs = fresh((1, 4))
    state, _, _ = ck.restore(str(d / "ck_jax"), state, mesh=mesh, pspecs=specs)
    state, met = step(state, _rows(batch, mesh))
    out["loss2_from_jax"] = float(met["loss"])
    if rank == 0:
        (d / "elastic_port.json").write_text(json.dumps(out))


def _ranks(rank: int, d: Path) -> None:
    _init_group(rank, d)
    import torch.distributed as dist

    torch.set_num_threads(1)
    for name, case in CASES.items():
        _train_case(rank, d, name, case)
    _straddle(rank, d)
    _feeder(rank, d)
    _serving(rank, d)
    _elastic(rank, d)
    dist.destroy_process_group()


def _collectives(rank: int, d: Path) -> None:
    """On a (pod 2, data 2, model 2) mesh of 8 ranks: the sum over each set
    of axes (its group made when the mesh is built), a tree cut by a spec
    over a pair of axes and gathered back, and the adjoint of the
    all-gather; the checks' outcomes to ``collectives_<rank>.json``."""
    import torch.distributed as dist

    from repro_torch.launch import make_mesh
    from repro_torch.models import sharding as SH
    from repro_torch.models.policy import P

    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store8"), 8), rank=rank, world_size=8,
                            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    out = {"coords": [mesh.coords[a] for a in mesh.axis_names]}
    for axes in (("pod", "data"), ("pod", "model"), ("data", "model"), ("pod",), ("pod", "data", "model")):
        got = float(SH.all_reduce(torch.tensor([float(rank)]), mesh, axes))
        want = sum(r for r in range(8) if all(
            (r >> (2 - mesh.axis_names.index(a))) & 1 == mesh.coords[a]
            for a in mesh.axis_names if a not in axes))
        out["/".join(axes)] = got == want
    dense = torch.arange(8 * 8, dtype=torch.float32).reshape(8, 8)
    for spec in (P(("pod", "data"), "model"), P(("pod", "model"), None), P("data", ("pod", "model"))):
        block = SH.cut(dense, spec, mesh)
        out[repr(spec)] = bool(torch.equal(SH.gather(block, spec, mesh), dense))
    x = torch.ones((1, 3), requires_grad=True)
    y = SH.all_gather(x, 0, mesh, ("pod", "data"))
    (g,) = torch.autograd.grad((y * 2.0).sum(), x)
    out["all_gather_adjoint"] = tuple(y.shape) == (4, 3) and bool(torch.equal(g, torch.full((1, 3), 8.0)))
    (d / f"collectives_{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


# ------------------------------------------------------------ the reference
def _jax(d: Path) -> None:
    """The reference: its elastic checkpoint first (one step on (2, 2),
    ``ck.save``, a second step), then each case's STEPS steps of
    ``build_train_step(mesh=)`` on 4 devices and ``jax.grad`` of its loss
    at the start, to ``jax_<name>.npz``."""
    import jax
    import jax.numpy as jnp

    import repro.configs as JC
    from repro.models.model import StreamModel as JModel
    from repro.models.policy import Policy as JPolicy
    from repro.train import checkpoint as jck
    from repro.train.optimizer import adamw as jadamw
    from repro.train.trainer import build_train_step as jbuild

    def mesh_of(shape):
        return jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)

    def run(case, params_path, batch_path):
        mesh = mesh_of(case["shape"])
        fsdp = case.get("fsdp")
        pol = JPolicy.for_mesh(mesh, param_dtype="float32", compute_dtype="float32",
                               fsdp_axes=("data",) if fsdp else (), fsdp_selective=fsdp != "full")
        cfg = JC.get_reduced(case["arch"])
        model = JModel(cfg, pol, mesh)
        opt = jadamw(LR)
        step, sh = jbuild(model, opt, mesh=mesh, donate=False)
        params = jax.tree.map(jnp.asarray, _load(params_path, torch_tensors=False))
        batch = {k: jnp.asarray(v) for k, v in _load(batch_path, torch_tensors=False).items()}
        state = jax.tree.map(lambda x, s: jax.device_put(x, s), {"params": params, "opt": opt.init(params)}, sh)
        return mesh, model, step, state, params, batch

    case = {"arch": "yi-6b", "shape": [2, 2], "fsdp": None}
    mesh, _, step, state, _, batch = run(case, d / "params_elastic.npz", d / "batch_elastic.npz")
    with mesh:
        state, m1 = step(state, batch)
        jck.save(str(d / "ck_jax"), 1, state, meta={"loss": float(m1["loss"])})
        state, m2 = step(state, batch)
    (d / "elastic_jax.json").write_text(json.dumps({"loss2": float(m2["loss"])}))

    for name, case in CASES.items():
        mesh, model, step, state, params, batch = run(case, d / f"params_{name}.npz", d / f"batch_{name}.npz")
        plain = JModel(JC.get_reduced(case["arch"]), JPolicy(param_dtype="float32", compute_dtype="float32"))
        grads = jax.jit(jax.grad(lambda p, b: plain.loss(p, b)[0]))(params, batch)
        out = {"losses": [], "params": {}, "grads0": jax.tree.map(np.asarray, grads)}
        with mesh:
            for i in range(STEPS):
                state, met = step(state, batch)
                out["losses"].append(float(met["loss"]))
                out["params"][str(i)] = jax.tree.map(np.asarray, state["params"])
        out["losses"] = np.asarray(out["losses"], np.float32)
        _save(d / f"jax_{name}.npz", out)


# ------------------------------------------------------------ inputs and runs
def _inputs(d: Path, name: str, arch: str, seq: int, seed: int, **over):
    """Seeded port weights (f32) and a batch of ROWS rows, saved for every
    process; returns the port's one-process model on them and the batch."""
    from repro_torch import convert
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy

    cfg = _cfg(arch, **over)
    m = StreamModel(cfg, Policy("float32", "float32", "float32"), device="cpu", generator=seed)
    _save(d / f"params_{name}.npz", convert.params_to_numpy(m.param_tree()))
    rng = np.random.default_rng(seed + 100)
    batch = {"tokens": rng.integers(0, cfg.vocab, (ROWS, seq)).astype(np.int32)}
    if cfg.enc_dec:
        batch["frames"] = rng.standard_normal((ROWS, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    _save(d / f"batch_{name}.npz", batch)
    return m, {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Every case's inputs, then the 4 ranks and the reference at once.
    Returns the run's directory."""
    d = tmp_path_factory.mktemp("mesh")
    for i, (name, case) in enumerate(CASES.items()):
        _inputs(d, name, case["arch"], case["seq"], seed=10 + i)
    _inputs(d, "elastic", "yi-6b", 16, seed=40)
    m, _ = _inputs(d, "straddle", "yi-6b", 16, seed=41, d_ff=STRADDLE_D_FF)
    rng = np.random.default_rng(42)
    for i in range(2):  # gradients whose norm is below the clip's 1: the clip scale is 1 on every side
        g = {k: v for k, v in _load(d / "params_straddle.npz").items()}
        g = _map(lambda t: torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32) * 1e-3), g)
        _save(d / f"grads_straddle_{i}.npz", g)
    t0 = time.monotonic()
    _run_all([(["ranks", str(r), str(d)], _env()) for r in range(WORLD)] + [(["jax", str(d)], _env(WORLD))])
    (d / "seconds.txt").write_text(f"{time.monotonic() - t0:.1f}")
    return d


def _map(f, tree):
    return {k: _map(f, v) for k, v in tree.items()} if isinstance(tree, dict) else f(tree)


def _leaves(tree) -> list:
    from repro_torch.train.optimizer import tree_leaves

    return tree_leaves(tree)


def _one_process(d: Path, name: str):
    """The port's one-process build_train_step on the whole batch: the
    losses, the parameters after each step and the first step's
    gradients."""
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy
    from repro_torch.train import adamw, build_train_step

    case = CASES[name]
    m = StreamModel(_cfg(case["arch"]), Policy("float32", "float32", "float32"), device="cpu", generator=None)
    m.load_params(_load(d / f"params_{name}.npz"))
    m.requires_grad_(True)
    opt, seen = _recording(adamw(LR))
    state = {"params": m.param_tree(), "opt": opt.init(m.param_tree())}
    step, specs = build_train_step(m, opt)
    assert specs is None
    batch = {k: v.long() if k == "tokens" else v for k, v in _load(d / f"batch_{name}.npz").items()}
    losses, params = [], []
    for _ in range(STEPS):
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        params.append([p.detach().clone() for p in _leaves(state["params"])])
    return np.asarray(losses), params, seen[0]


def _close_params(got: list, want: list, init: list) -> None:
    """Each leaf of ``got`` against ``want``: its largest gap at PARAM_ATOL
    and its mean gap at PARAM_LEAF_RTOL of ``want``'s mean movement from
    ``init`` (the module docstring)."""
    assert len(got) == len(want) == len(init)
    for i, (a, b, p0) in enumerate(zip(got, want, init)):
        a, b, p0 = (np.asarray(t, np.float64) for t in (a, b, p0))
        assert a.shape == b.shape == p0.shape, i
        gap = np.abs(a - b)
        assert float(gap.max()) <= PARAM_ATOL, (i, float(gap.max()))
        moved = float(np.abs(b - p0).mean())
        assert float(gap.mean()) <= PARAM_LEAF_RTOL * moved, (i, float(gap.mean()), moved)


def _initial(d: Path, name: str) -> list:
    return _leaves(_load(d / f"params_{name}.npz", torch_tensors=False))


# ------------------------------------------------------------ the tests
@pytest.mark.parametrize("name", list(CASES))
def test_mesh_losses_match_jax(mesh_run, name):
    """The port's 4 ranks against the reference's ``build_train_step(mesh=)``
    on 4 devices: the global loss of each of STEPS steps at LOSS_RTOL."""
    port, ref = _load(mesh_run / f"port_{name}.npz"), _load(mesh_run / f"jax_{name}.npz")
    np.testing.assert_allclose(port["losses"].numpy(), ref["losses"].numpy(), rtol=LOSS_RTOL)
    assert port["losses"][-1] < port["losses"][0]


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_gradients_match_jax(mesh_run, name):
    """The first step's gradients, summed over the ranks that hold each
    block and gathered, against ``jax.grad`` of the reference's loss on the
    whole batch, each leaf at GRAD_TOL of its largest element."""
    port, ref = _load(mesh_run / f"port_{name}.npz"), _load(mesh_run / f"jax_{name}.npz", torch_tensors=False)
    want = _leaves(ref["grads0"])
    got = [port["grads0"][str(i)] for i in range(len(want))]
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, i
        assert float(np.abs(g.numpy() - w).max()) <= GRAD_TOL * float(np.abs(w).max()), i


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_parameters_match_jax(mesh_run, name):
    """The gathered parameters after each step against the reference's
    sharded state, leaf by leaf (PARAM_ATOL, PARAM_LEAF_RTOL: the module
    docstring)."""
    port, ref = _load(mesh_run / f"port_{name}.npz"), _load(mesh_run / f"jax_{name}.npz", torch_tensors=False)
    for i in range(STEPS):
        _close_params([t.numpy() for t in _leaves(port["params"][str(i)])], _leaves(ref["params"][str(i)]),
                      _initial(mesh_run, name))


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_matches_one_process(mesh_run, name):
    """The port on 4 ranks against the port in one process
    (``build_train_step`` without a mesh) on the whole batch: the losses
    at LOSS_RTOL, the first step's gradients at PORT_GRAD_TOL of each
    leaf's largest element and the parameters after each step as against
    JAX."""
    port = _load(mesh_run / f"port_{name}.npz")
    losses, params, grads = _one_process(mesh_run, name)
    np.testing.assert_allclose(port["losses"].numpy(), losses, rtol=LOSS_RTOL)
    for i, w in enumerate(grads):
        g = port["grads0"][str(i)]
        assert float((g - w).abs().max()) <= PORT_GRAD_TOL * float(w.abs().max()), i
    for i in range(STEPS):
        _close_params([t.numpy() for t in _leaves(port["params"][str(i)])], [p.numpy() for p in params[i]],
                      _initial(mesh_run, name))


def test_adamw8bit_straddling_blocks_equal_the_unsharded_update(mesh_run):
    """Two ``adamw8bit`` updates on (2, 2) of a model whose ``w_in`` (and
    unembed) trailing dims split into 1.25 quantization blocks a rank give
    the unsharded update's parameters, codes and scales to the bit, from
    the same gradients (norm below 1: the clip scale is 1 on both)."""
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy
    from repro_torch.train import adamw8bit

    cfg = _cfg("yi-6b", d_ff=STRADDLE_D_FF)
    assert (STRADDLE_D_FF // 2) % 256 and (cfg.vocab_padded // 2) % 256
    m = StreamModel(cfg, Policy("float32", "float32", "float32"), device="cpu", generator=None)
    m.load_params(_load(mesh_run / "params_straddle.npz"))
    opt = adamw8bit(LR)
    params = m.param_tree()
    state = opt.init(params)
    for i in range(2):
        opt.update(_load(mesh_run / f"grads_straddle_{i}.npz"), state, params)
    got = _load(mesh_run / "port_straddle.npz")
    want = {"params": params, "opt": state}
    flat_got, flat_want = _leaves(got), _leaves(want)
    assert len(flat_got) == len(flat_want)
    for a, b in zip(flat_got, flat_want):
        assert torch.equal(a.to(b.dtype), b.detach()), tuple(b.shape)


def test_sharded_feeder_deals_each_rank_its_rows(mesh_run):
    """On (data 2, model 2) each rank gets, in order, its data shard's rows
    of every batch (ranks of one data coordinate the same), and a source
    that fails raises at the consumer."""
    for r in range(WORLD):
        got = _load(mesh_run / f"feeder_{r}.npz")
        k = r // 2  # the data coordinate of rank r
        want = np.stack([(np.arange(ROWS * 3).reshape(ROWS, 3) + 100 * i)[k * 4:(k + 1) * 4] for i in range(4)])
        np.testing.assert_array_equal(got["rows"].numpy(), want)
        assert "the source failed" in json.loads((mesh_run / f"feeder_{r}.json").read_text())["err"]


def test_serving_on_a_mesh_refuses_naming_item_10b(mesh_run):
    """``forward``, ``prefill`` and ``decode_step`` on the (2, 2) mesh of 4
    ranks (ZeRO-3 over ``data``, the decode cache's sequence split over
    ``model``, the rows over ``data``) run and agree with the reference:
    the JAX package's mesh-free model on the same weights, its forward's
    logits, and its prefill's and each decode step's, at SERVE_TOL of the
    largest logit (measured 8.7e-7 and 1.7e-6)."""
    import jax.numpy as jnp

    import repro.configs as JC
    from repro.models.model import StreamModel as JModel
    from repro.models.policy import Policy as JPolicy

    got = _load(mesh_run / "serving.npz")
    jm = JModel(JC.get_reduced("yi-6b"), JPolicy(param_dtype="float32", compute_dtype="float32"))
    params = _load(mesh_run / "params_yi-zero3-selective.npz", torch_tensors=False)
    tokens = jnp.asarray(_load(mesh_run / "batch_yi-zero3-selective.npz", torch_tensors=False)["tokens"][:SERVE_ROWS])
    want_fwd = np.asarray(jm.forward(params, {"tokens": tokens})[0])
    lg, caches = jm.prefill(params, {"tokens": tokens[:, :SERVE_PROMPT]}, SERVE_CACHE, jnp.float32)
    want = [np.asarray(lg)]
    for i in range(SERVE_PROMPT, tokens.shape[1]):
        lg, caches = jm.decode_step(params, caches, tokens[:, i:i + 1], jnp.int32(i))
        want.append(np.asarray(lg[:, 0]))

    def close(a, b):
        assert a.shape == b.shape and float(np.abs(a - b).max()) <= SERVE_TOL * float(np.abs(b).max())

    close(got["forward"].numpy(), want_fwd)
    for i, w in enumerate(want):
        close(got["steps"][i].numpy(), w)


def test_elastic_restart_restores_bits_and_continues(mesh_run):
    """The state saved on (2, 2) restores onto (2, 2), (4, 1) and (1, 4)
    to the bit (gathered back); the second step's loss equals the
    uninterrupted run's to the bit on (2, 2) and within ELASTIC_ULPS f32
    ulps on the other shapes (the module docstring)."""
    from repro_torch.train.checkpoint import _items

    port = json.loads((mesh_run / "elastic_port.json").read_text())
    with np.load(mesh_run / "ck_port" / "step_1" / "arrays.npz") as z:
        saved = {k: z[k] for k in z.files}
    for shape in ELASTIC_SHAPES:
        tag = f"{shape[0]}x{shape[1]}"
        restored = dict(("/".join(k), v) for k, v in _items(_load(mesh_run / f"elastic_state_{tag}.npz")))
        assert set(restored) == set(saved)
        for key, arr in saved.items():
            assert np.array_equal(restored[key].numpy().astype(arr.dtype), arr), (tag, key)
    assert f"{port['loss2_2x2']:.10f}" == f"{port['loss2']:.10f}"
    for tag in ("4x1", "1x4"):
        ulp = float(np.spacing(np.float32(port["loss2"])))
        assert abs(port[f"loss2_{tag}"] - port["loss2"]) <= ELASTIC_ULPS * ulp, (tag, port[f"loss2_{tag}"])
    assert port["loss2"] < port["loss1"]


def test_collectives_on_a_three_axis_mesh(tmp_path):
    """8 gloo ranks on (pod 2, data 2, model 2): the sum over every set of
    axes (one, two, all three) is the sum over that group's ranks; a
    tensor cut by specs over pairs of axes (in the mesh's order, the
    first the slowest) gathers back to the dense one; the all-gather's
    adjoint sums the gradient over the group (4 ranks of 2 each)."""
    _run_all([(["collectives", str(r), str(tmp_path)], _env()) for r in range(8)])
    for r in range(8):
        got = json.loads((tmp_path / f"collectives_{r}.json").read_text())
        coords = got.pop("coords")
        assert coords == [(r >> 2) & 1, (r >> 1) & 1, r & 1]
        assert all(got.values()), (r, got)


def test_reference_checkpoint_restores_onto_a_port_mesh(mesh_run):
    """A checkpoint the reference saved from its (2, 2) mesh restores onto
    the port's (1, 4) mesh, and the port's second step there gives the
    reference's second loss at LOSS_RTOL."""
    port = json.loads((mesh_run / "elastic_port.json").read_text())
    ref = json.loads((mesh_run / "elastic_jax.json").read_text())
    assert abs(port["loss2_from_jax"] - ref["loss2"]) <= LOSS_RTOL * abs(ref["loss2"])


if __name__ == "__main__":
    role, *rest = sys.argv[1:]
    if role == "jax":
        _jax(Path(rest[0]))
    elif role == "collectives":
        _collectives(int(rest[0]), Path(rest[1]))
    else:
        _ranks(int(rest[0]), Path(rest[1]))
