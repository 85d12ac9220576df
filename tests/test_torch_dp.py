"""Data-parallel training in the port against the JAX package, on the CPU.

``repro_torch.train.compression`` and ``dp_train_step`` over ``gloo``
process groups of 2 ranks, each rank a subprocess of its own that runs
this file as a script (``python tests/test_torch_dp.py <role> ...``),
rendezvous through a ``FileStore`` in the test's temporary directory
(no port, no network) with an init timeout, and every subprocess joined
with a deadline, killed past it, failing the test. The JAX side
(``repro.train.compression``, ``repro.train.trainer.dp_train_step``)
runs in a subprocess of its own on a 2-device CPU mesh
(``--xla_force_host_platform_device_count=2``), as the pytest process has
started JAX with one device. Arrays travel through ``.npz`` files.

Tolerances: none for the encode, the decode and the compressed mean,
which hold JAX's bits (a bf16 sum of two values is rounded once on either
side; the rest is the same f32 arithmetic). The uncompressed step
against one process's ``build_train_step`` over the whole batch: the
mean of two halves' means against the whole batch's mean is the same
number summed in another order, so the first step's gradients are held
at 1e-5 of each leaf's largest element (measured 6e-7) and the losses
at 1e-6. The parameters after three AdamW steps (lr 1e-3) at 3e-5
absolute: AdamW's step g / (|g| + 1e-8) magnifies the rounding of a
gradient element near its eps (one of 4e-8 differs by 4% between the
two sums), so one element in 24576 moved 9.3e-6 apart, about 1% of a
step. The compressed step against JAX's: the losses at 1e-5 relative (measured 8.8e-8), as
the two packages' per-rank gradients differ in their f32 rounding and a
code or a bf16 sum may round the other way, which moves a parameter by
up to a code (1/127 of its block's largest gradient, times AdamW's
normalization).
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
DEADLINE_S = 240.0  # a whole multi-process run: every subprocess joined by then
INIT_TIMEOUT_S = 60  # gloo's rendezvous and collectives
VOCAB = 250
SEQ = 33
ROWS = 4
STEPS = 3
LR = 1e-3
GRAD_TOL = 1e-5
LOSS_TOL = 1e-6
PARAM_ATOL = 3e-5
JAX_LOSS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These models are tiny: torch's thread pool only contends with the
    other test workers, so each test here runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ npz trees
def _save(path, tree: dict) -> None:
    """A nested dict of arrays or tensors to ``path`` (.npz), keys joined
    by "/"; bf16 as its bits under a "bf16:" prefix."""
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
                continue
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu()
                if v.dtype == torch.bfloat16:
                    flat["bf16:" + prefix + k] = v.view(torch.int16).numpy()
                    continue
                v = v.numpy()
            if v.dtype.name == "bfloat16":
                flat["bf16:" + prefix + k] = v.view(np.int16)
            else:
                flat[prefix + k] = np.asarray(v)

    walk(tree, "")
    np.savez(path, **flat)


def _load(path, torch_tensors: bool = True) -> dict:
    """:func:`_save`'s nested dict back: torch tensors, or numpy (bf16 as
    ml_dtypes' bfloat16)."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            a = z[key]
            name = key
            if key.startswith("bf16:"):
                name = key[5:]
                if torch_tensors:
                    a = torch.from_numpy(a.copy()).view(torch.bfloat16)
                else:
                    import ml_dtypes

                    a = a.view(ml_dtypes.bfloat16)
            elif torch_tensors:
                a = torch.from_numpy(a.copy())
            *parts, last = name.split("/")
            node = out
            for p in parts:
                node = node.setdefault(p, {})
            node[last] = a
    return out


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
        assert p.returncode == 0, f"{args}: exit {p.returncode}\n{out[-4000:]}"


def _ranks(role: str, d: Path, *extra: str) -> list:
    return [([role, str(r), str(d), *extra], _env()) for r in range(WORLD)]


def _init_group(rank: int, d: Path) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"), WORLD), rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))


# ------------------------------------------------------------ the worker roles
def _torch_mean(rank: int, d: Path) -> None:
    """Rank ``rank``'s gradients through ``compressed_psum_mean``, and each
    compressed leaf's gathered codes and scales, to ``port_<rank>.npz``."""
    import torch.distributed as dist

    from repro_torch.train import compression as C
    from repro_torch.train.optimizer import tree_leaves

    _init_group(rank, d)
    grads = _load(d / f"grads_{rank}.npz")
    out = {"mean": C.compressed_psum_mean(grads), "codes": {}, "scales": {}}
    for k in sorted(grads):
        if grads[k].numel() % (WORLD * 256) == 0:
            out["codes"][k], out["scales"][k] = C.gathered_codes(grads[k])
    assert len(tree_leaves(out["mean"])) == len(grads)
    _save(d / f"port_{rank}.npz", out)
    dist.destroy_process_group()


def _yi_model(params_path: Path):
    """Reduced yi-6b (vocab VOCAB, f32) on the weights at ``params_path``."""
    import dataclasses

    import repro_torch.configs as TC
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy

    cfg = dataclasses.replace(TC.get_reduced("yi-6b"), vocab=VOCAB)
    m = StreamModel(cfg, Policy("float32", "float32", "float32"), device="cpu", generator=None)
    m.load_params(_load(params_path))
    m.requires_grad_(True)
    return m


def _torch_dp(rank: int, d: Path, compress: str) -> None:
    """STEPS steps of ``dp_train_step`` (compressed or not) on the shared
    weights and batch; the losses and the parameters to
    ``dp_<compress>_<rank>.npz``."""
    import torch.distributed as dist

    from repro_torch.train import dp_train_step

    _init_group(rank, d)
    m = _yi_model(d / "params.npz")
    opt, seen = _recording_adamw()
    step = dp_train_step(lambda p, b: m.loss(p, b), opt, compress=compress == "1")
    state = {"params": m.param_tree(), "opt": opt.init(m.param_tree())}
    tokens = _load(d / "batch.npz")["tokens"]
    losses = []
    for _ in range(STEPS):
        state, met = step(state, {"tokens": tokens})
        losses.append(float(met["loss"]))
    _save(d / f"dp_{compress}_{rank}.npz", {"losses": np.asarray(losses, np.float32), "params": state["params"],
                                            "grads0": {str(i): g for i, g in enumerate(seen[0])}})
    dist.destroy_process_group()


def _recording_adamw():
    """AdamW at LR that keeps a copy of each step's gradients (in leaf
    order) before it clips them in place. Returns (optimizer, copies)."""
    from repro_torch.train import Optimizer, adamw
    from repro_torch.train.optimizer import tree_leaves

    inner, seen = adamw(LR), []

    def update(grads, state, params):
        seen.append([g.detach().clone() for g in tree_leaves(grads)])
        return inner.update(grads, state, params)

    return Optimizer(init=inner.init, update=update), seen


def _jax_mean(d: Path) -> None:
    """The reference's ``compressed_psum_mean`` over a 2-device mesh on the
    two ranks' gradients, and each compressed leaf's codes and scales by
    the reference's own steps (``psum_scatter``, / n, ``int8_encode``,
    ``all_gather``), to ``jax.npz``."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.train import compression as JC

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    per = [_load(d / f"grads_{r}.npz", torch_tensors=False) for r in range(WORLD)]
    stacked = {k: jnp.stack([jnp.asarray(p[k]) for p in per]) for k in per[0]}
    packed = [k for k in sorted(stacked) if per[0][k].size % (WORLD * 256) == 0]

    def local(tree):
        g = {k: v[0] for k, v in tree.items()}
        mean = JC.compressed_psum_mean(g, "data")
        codes, scales = {}, {}
        for k in packed:
            shard = jax.lax.psum_scatter(g[k].reshape(-1).astype(jnp.bfloat16), "data", scatter_dimension=0,
                                         tiled=True)
            c, s = JC.int8_encode(shard.astype(jnp.float32) / WORLD)
            codes[k] = jax.lax.all_gather(c, "data", axis=0, tiled=True)
            scales[k] = jax.lax.all_gather(s, "data", axis=0, tiled=True)
        return jax.tree.map(lambda a: a[None], {"mean": mean, "codes": codes, "scales": scales})

    spec = {k: P("data") for k in stacked}
    out_spec = {"mean": spec, "codes": {k: P("data") for k in packed}, "scales": {k: P("data") for k in packed}}
    out = jax.jit(shard_map(local, mesh=mesh, in_specs=(spec,), out_specs=out_spec, check_rep=False))(stacked)
    out = jax.tree.map(np.asarray, out)
    for r in range(WORLD):  # every device holds the same mean
        _save(d / f"jax_{r}.npz", jax.tree.map(lambda a: a[r], out))


def _jax_dp(d: Path) -> None:
    """STEPS steps of the reference's ``dp_train_step(compress=True)`` over a
    2-device mesh on the shared weights and batch; the losses to
    ``jax_dp.npz``."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import repro.configs as JCF
    from repro.models.model import StreamModel as JModel
    from repro.models.policy import Policy as JPolicy
    from repro.train.optimizer import adamw as jadamw
    from repro.train.trainer import dp_train_step as jdp

    cfg = dataclasses.replace(JCF.get_reduced("yi-6b"), vocab=VOCAB)
    jm = JModel(cfg, JPolicy(param_dtype="float32", compute_dtype="float32"))
    params = jax.tree.map(jnp.asarray, _load(d / "params.npz", torch_tensors=False))
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    opt = jadamw(LR)
    step = jdp(lambda p, b: jm.loss(p, b), opt, mesh, compress=True)
    state = {"params": params, "opt": opt.init(params)}
    tokens = jnp.asarray(_load(d / "batch.npz", torch_tensors=False)["tokens"])
    losses = []
    for _ in range(STEPS):
        state, met = step(state, {"tokens": tokens})
        losses.append(float(met["loss"]))
    _save(d / "jax_dp.npz", {"losses": np.asarray(losses, np.float32)})


ROLES = {"torch-mean": _torch_mean, "torch-dp": _torch_dp}


# ------------------------------------------------------------ the tests
def _jax_encode(x):
    import jax.numpy as jnp

    from repro.train import compression as JC

    return JC.int8_encode(jnp.asarray(x))


def _halfway() -> np.ndarray:
    """Blocks whose largest value is 127 (scale 1): the rest are k + 0.5,
    which round to the even neighbour, on both signs."""
    x = np.arange(512, dtype=np.float32) % 120 - 60 + 0.5
    x[::256] = 127.0
    x[1::256] = -127.0
    return x


ENCODE_CASES = {
    "multiple-of-256": lambda rng: rng.standard_normal((4, 512)).astype(np.float32),
    "ragged": lambda rng: rng.standard_normal((3, 333)).astype(np.float32) * 5,
    "zero-block": lambda rng: np.concatenate([np.zeros(256, np.float32), rng.standard_normal(300).astype(np.float32)]),
    "bf16": lambda rng: rng.standard_normal((5, 200)).astype(np.float32),
    "halfway": lambda rng: _halfway(),
}


@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_int8_encode_decode_match_jax_bits(case):
    """``int8_encode`` and ``int8_decode`` give the reference's codes,
    scales and decoded values to the bit: whole blocks, a ragged last
    block, an all-zero block (scale 0, divided by 1), bf16 input and
    decode, halfway values rounded to even."""
    import jax.numpy as jnp
    import ml_dtypes

    from repro.train import compression as JC
    from repro_torch.train import compression as C

    x = ENCODE_CASES[case](np.random.default_rng(3))
    if case == "bf16":
        jx, tx = x.astype(ml_dtypes.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
        assert np.array_equal(jx.astype(np.float32), tx.float().numpy())
    else:
        jx, tx = x, torch.from_numpy(x.copy())
    jc, js = _jax_encode(jx)
    tc, ts = C.int8_encode(tx)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tc.numpy(), np.asarray(jc)) and np.array_equal(ts.numpy(), np.asarray(js))
    jd = JC.int8_decode(jc, js, jx.shape, jnp.asarray(jx).dtype)
    td = C.int8_decode(tc, ts, tuple(tx.shape), tx.dtype)
    assert td.dtype == tx.dtype and tuple(td.shape) == x.shape
    assert np.array_equal(td.float().numpy(), np.asarray(jd).astype(np.float32))
    if case == "halfway":  # k + 0.5 -> the even neighbour, either sign
        want = np.round(x).astype(np.int8)  # numpy rounds half to even too
        assert np.array_equal(tc.reshape(-1).numpy(), want) and (np.abs(x - np.round(x)) == 0.5).sum() > 400
    if case == "zero-block":
        assert float(ts[0]) == 0.0 and not tc[0].any()


@pytest.fixture(scope="module")
def mean_run(tmp_path_factory):
    """Two ranks' gradients (an f32 leaf and a bf16 leaf whose sizes are
    multiples of 2 * 256, one with an all-zero block, and a leaf of 300
    that takes the f32 fallback) through the port's compressed mean over
    gloo and the reference's over a 2-device mesh. Returns (port's, JAX's)
    outputs, one per rank."""
    d = tmp_path_factory.mktemp("dp_mean")
    rng = np.random.default_rng(21)
    for r in range(WORLD):
        zero = rng.standard_normal((2, 256)).astype(np.float32)
        zero[0] = 0.0  # rank 0's shard of the sum: one zero block
        _save(d / f"grads_{r}.npz", {
            "a": rng.standard_normal((4, 512)).astype(np.float32),
            "b": rng.standard_normal((3, 100)).astype(np.float32),  # 300: not a multiple of 512
            "c": torch.from_numpy(rng.standard_normal(2048).astype(np.float32) * 4).to(torch.bfloat16),
            "z": zero,
        })
    _run_all(_ranks("torch-mean", d) + [(["jax-mean", str(d)], _env(jax_devices=WORLD))])
    return ([_load(d / f"port_{r}.npz") for r in range(WORLD)],
            [_load(d / f"jax_{r}.npz", torch_tensors=False) for r in range(WORLD)])


def test_compressed_mean_codes_and_scales_match_jax(mean_run):
    """Every compressed leaf's gathered codes and scales on each rank equal
    the reference's, to the bit (the zero block's scale 0 too)."""
    port, ref = mean_run
    for r in range(WORLD):
        assert sorted(port[r]["codes"]) == sorted(ref[r]["codes"]) == ["a", "c", "z"]
        for k in port[r]["codes"]:
            assert np.array_equal(port[r]["codes"][k].numpy(), ref[r]["codes"][k]), k
            assert np.array_equal(port[r]["scales"][k].numpy(), ref[r]["scales"][k]), k
    assert float(port[0]["scales"]["z"][0]) == 0.0


def test_compressed_mean_decoded_bits_match_jax(mean_run):
    """The decoded mean of every leaf, the f32 fallback's among them, in its
    dtype, equals the reference's to the bit, on both ranks."""
    port, ref = mean_run
    for r in range(WORLD):
        for k in ("a", "b", "c", "z"):
            got, want = port[r]["mean"][k], ref[r]["mean"][k]
            assert got.dtype == (torch.bfloat16 if k == "c" else torch.float32), k
            assert np.array_equal(got.float().numpy(), np.asarray(want).astype(np.float32)), k


def test_compressed_mean_is_the_same_on_every_rank(mean_run):
    """Both ranks decode the same bits, and the fallback leaf is the f32
    mean of the two ranks' gradients."""
    port, _ = mean_run
    for k in ("a", "b", "c", "z"):
        assert torch.equal(port[0]["mean"][k], port[1]["mean"][k]), k


def _dp_inputs(d: Path):
    """Reduced yi-6b's seeded weights and a batch of ROWS x SEQ tokens below
    the vocab (every label counts, the same number on each rank), saved
    for the ranks; returns the port's model on them and the tokens."""
    import dataclasses

    import repro_torch.configs as TC
    from repro_torch import convert
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy

    cfg = dataclasses.replace(TC.get_reduced("yi-6b"), vocab=VOCAB)
    m = StreamModel(cfg, Policy("float32", "float32", "float32"), device="cpu", generator=5)
    _save(d / "params.npz", convert.params_to_numpy(m.param_tree()))
    tokens = np.random.default_rng(22).integers(0, VOCAB, (ROWS, SEQ)).astype(np.int32)
    _save(d / "batch.npz", {"tokens": tokens})
    return tokens


def test_dp_step_uncompressed_matches_one_process(tmp_path):
    """STEPS uncompressed AdamW steps over 2 ranks, each on its 2 rows,
    against ``build_train_step`` over all 4 rows in one process: the first
    step's mean gradients at GRAD_TOL of each leaf's largest element, the
    losses at LOSS_TOL and the parameters at PARAM_ATOL (module
    docstring); both ranks' parameters equal to the bit."""
    from repro_torch.train import build_train_step
    from repro_torch.train.optimizer import tree_leaves

    tokens = _dp_inputs(tmp_path)
    _run_all(_ranks("torch-dp", tmp_path, "0"))
    runs = [_load(tmp_path / f"dp_0_{r}.npz") for r in range(WORLD)]
    m = _yi_model(tmp_path / "params.npz")
    opt, seen = _recording_adamw()
    step, _ = build_train_step(m, opt)
    state = {"params": m.param_tree(), "opt": opt.init(m.param_tree())}
    losses = []
    for _ in range(STEPS):
        state, met = step(state, {"tokens": torch.from_numpy(tokens)})
        losses.append(float(met["loss"]))
    grads0 = runs[0]["grads0"]
    assert len(grads0) == len(seen[0])
    for i, want in enumerate(seen[0]):
        got = grads0[str(i)]
        assert float((got - want).abs().max()) <= GRAD_TOL * float(want.abs().max()), i
    np.testing.assert_allclose(runs[0]["losses"].numpy(), losses, rtol=LOSS_TOL)
    one = tree_leaves(state["params"])
    for a, b, c in zip(tree_leaves(runs[0]["params"]), tree_leaves(runs[1]["params"]), one):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), c.detach().numpy(), rtol=0, atol=PARAM_ATOL)


@pytest.fixture(scope="module")
def compressed_run(tmp_path_factory):
    """STEPS compressed steps over 2 gloo ranks and the reference's over a
    2-device mesh, on the same weights and batch. Returns (the ranks'
    outputs, JAX's losses)."""
    d = tmp_path_factory.mktemp("dp_compressed")
    _dp_inputs(d)
    _run_all(_ranks("torch-dp", d, "1") + [(["jax-dp", str(d)], _env(jax_devices=WORLD))])
    return [_load(d / f"dp_1_{r}.npz") for r in range(WORLD)], _load(d / "jax_dp.npz")["losses"].numpy()


def test_compressed_replicas_stay_bit_identical(compressed_run):
    """After STEPS compressed steps both ranks hold the same parameters to
    the bit, and the training moved them (the loss fell)."""
    from repro_torch.train.optimizer import tree_leaves

    runs, _ = compressed_run
    for a, b in zip(tree_leaves(runs[0]["params"]), tree_leaves(runs[1]["params"])):
        assert torch.equal(a, b)
    assert torch.equal(runs[0]["losses"], runs[1]["losses"])
    losses = runs[0]["losses"].numpy()
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_compressed_dp_losses_match_jax(compressed_run):
    """The port's compressed losses against the reference's dp_train_step
    over 2 devices, at JAX_LOSS_TOL (module docstring)."""
    runs, jax_losses = compressed_run
    np.testing.assert_allclose(runs[0]["losses"].numpy(), jax_losses, rtol=JAX_LOSS_TOL)


if __name__ == "__main__":
    role, *rest = sys.argv[1:]
    if role == "jax-mean":
        _jax_mean(Path(rest[0]))
    elif role == "jax-dp":
        _jax_dp(Path(rest[0]))
    else:
        ROLES[role](int(rest[0]), Path(rest[1]), *rest[2:])
