"""Serving on a device mesh in the port against the JAX package, on the CPU.

The port's ranks are 4 ``gloo`` processes, each a subprocess running this
file as a script that meet through a ``FileStore`` in the test's temporary
directory with an init timeout; every subprocess is joined with a deadline
and killed past it, failing the test (``tests/test_torch_mesh.py``'s
harness). The reference runs in one subprocess on a 4-device CPU mesh
whose axes are ``AxisType.Auto`` (JAX's default, Explicit, refuses the
prefill's cache write on (2, 2) with ``seq_axis="data"`` at batch 1).
Weights are the port's seeded f32 model's, moved to both sides through
``.npz`` files; int8 weights are ``quantize_params`` of them on each side
(bit-equal across the packages), placed by ``quantized_pspecs``. One run
of the 4 ranks and one of the reference serve every test (a module
fixture), each process on one thread.

Each case (``CASES``, reduced configs, f32 weights, activations and
caches) prefills a batch of prompts and takes DECODE steps, each step fed
the case's seeded token (teacher forcing: no argmax tie can part the two
sides), through ``build_serve_step(model, mesh)`` on both sides; the
port's prefill is ``StreamModel.prefill`` with an f32 cache, as the
reference's is. Held against the reference's mesh run: the logits of the
prefill and of every step, and the caches after the prefill and after the
last step, the port's blocks gathered by ``gather_caches``. Held against
the port's own mesh-free run: the same logits.

* yi-6b on (1, 4) with ``seq_axis="model"`` (flash-decode over 4 slices
  of 8 slots; the steps cross into rank 2's), on (2, 2) with ``"model"``
  (its 2 kv heads divide the model axis: JAX's ``cache_pspecs`` names
  ``model`` twice), on (2, 2) with ``"data"`` at batch 1 (the batch stays
  whole, the flash-decode runs over ``data``), with a prompt of 3 tokens
  on (1, 4) (ranks 1-3 hold no valid slot: the ``-inf`` guard), with a
  per-row position on (1, 4) (JAX's plain path; with ``"model"`` too,
  where the port merges each row's statistics over the cache's slices)
  and through the paged cache on (1, 4);
* mamba2 on (1, 4) (the SSD heads and the conv's channels split);
* recurrentgemma on (1, 4) with ``"model"``: its RG-LRU channels split,
  its local layers' ring of 16 over 4 ranks, a 20-token prompt (the ring
  wraps), "seq" attention in the prefill;
* gemma2 on (1, 4) with ``"model"``: window 16 and the softcap on a
  24-token prompt, the rings and the global layers' caches split;
* qwen3-moe in int8 on (2, 2), a width whose expert leaves quantize;
* mistral on (1, 4) without ``seq_axis`` (8 heads over 4 ranks, 2 kv
  heads whole: each rank reads the kv head of its pair of heads);
* whisper on (1, 4) with ``"model"`` (6 heads do not divide 4: "seq"
  attention, the cross K/V cached whole, learned positions).

Tolerances, measured on this container (the largest gap over the cases in
brackets): the logits at LOGIT_TOL 1e-5 of the largest logit magnitude
against the reference [4.5e-6, gemma2] and against the port's mesh-free
run [2.5e-6, mamba2]; each cache leaf at CACHE_TOL 1e-5 of its largest
magnitude [4.5e-6, gemma2's global layers' v]: the ranks' partial sums
add in another order than one process's sums.
"""

from __future__ import annotations

import dataclasses
import datetime
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
DECODE = 8
LOGIT_TOL = 1e-5
CACHE_TOL = 1e-5

CASES = {
    "yi-1x4-model": dict(arch="yi-6b", shape=[1, 4], seq="model", batch=2, prompt=12, s_cache=32),
    "yi-2x2-model": dict(arch="yi-6b", shape=[2, 2], seq="model", batch=2, prompt=12, s_cache=32),
    "yi-2x2-data-b1": dict(arch="yi-6b", shape=[2, 2], seq="data", batch=1, prompt=12, s_cache=32),
    "yi-short-prompt": dict(arch="yi-6b", shape=[1, 4], seq="model", batch=2, prompt=3, s_cache=32),
    "yi-per-row": dict(arch="yi-6b", shape=[1, 4], seq=None, batch=2, prompt=12, s_cache=32, per_row=[0, 3]),
    "yi-per-row-seq": dict(arch="yi-6b", shape=[1, 4], seq="model", batch=2, prompt=12, s_cache=32, per_row=[0, 5]),
    "yi-paged": dict(arch="yi-6b", shape=[1, 4], seq=None, batch=2, prompt=8, s_cache=8, paged=True),
    "mamba2": dict(arch="mamba2-2.7b", shape=[1, 4], seq=None, batch=2, prompt=16, s_cache=32),
    "recurrentgemma-ring": dict(arch="recurrentgemma-9b", shape=[1, 4], seq="model", batch=2, prompt=20, s_cache=32),
    "gemma2-window": dict(arch="gemma2-2b", shape=[1, 4], seq="model", batch=2, prompt=24, s_cache=48),
    "qwen3-moe-int8": dict(arch="qwen3-moe-30b-a3b", shape=[2, 2], seq=None, batch=2, prompt=12, s_cache=32,
                           int8=True, over=dict(d_model=128), moe_over=dict(d_ff=64)),
    "mistral": dict(arch="mistral-large-123b", shape=[1, 4], seq=None, batch=2, prompt=12, s_cache=32),
    "whisper": dict(arch="whisper-tiny", shape=[1, 4], seq="model", batch=2, prompt=8, s_cache=16),
}
# the paged case: blocks of PAGE slots, each row's table of MAX_BLOCKS ids
# (row r owns 1 + MAX_BLOCKS * r onwards; block 0 is the scratch block)
PAGE, MAX_BLOCKS, N_BLOCKS = 4, 6, 16


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


def _cfg(case: dict, jax_side: bool = False):
    import repro_torch.configs as TC

    if jax_side:
        import repro.configs as JC

        cfg = JC.get_reduced(case["arch"])
    else:
        cfg = TC.get_reduced(case["arch"])
    cfg = dataclasses.replace(cfg, **case.get("over", {}))
    if "moe_over" in case:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **case["moe_over"]))
    return cfg


def _pages(row: int) -> list[int]:
    return [1 + MAX_BLOCKS * row + j for j in range(MAX_BLOCKS)]


# ------------------------------------------------------------ the port's ranks
def _serve_case(rank: int, d: Path, name: str, case: dict) -> None:
    """The case on this rank's mesh: prefill, then DECODE steps through
    ``build_serve_step(model, mesh)``; rank 0 saves the logits and the
    gathered caches to ``port_<name>.npz``."""
    from repro_torch.launch import make_mesh
    from repro_torch.models import sharding as SH
    from repro_torch.models.model import StreamModel, quantize_params, quantized_pspecs
    from repro_torch.models.policy import Policy
    from repro_torch.serve import build_serve_step

    mesh = make_mesh(case["shape"], ("data", "model"), device="cpu")
    pol = Policy.for_mesh(mesh, param_dtype="float32", compute_dtype="float32", kv_cache_dtype="float32",
                          seq_axis=case["seq"], weights_int8=case.get("int8", False))
    m = StreamModel(_cfg(case), pol, device="cpu", generator=None, mesh=mesh)
    tree = _load(d / f"params_{name}.npz")
    specs = m.param_pspecs()
    if case.get("int8"):
        tree, specs = quantize_params(tree), quantized_pspecs(tree, specs)
    m.load_params(SH.shard_tree(tree, specs, mesh))
    inp = _load(d / f"inputs_{name}.npz")
    tokens, feed, b = inp["tokens"].long(), inp["feed"].long(), case["batch"]
    step, step_specs = build_serve_step(m, mesh)
    assert step_specs == specs
    out = {"logits": []}
    if case.get("paged"):
        caches = m.init_paged_cache(b, N_BLOCKS, PAGE, MAX_BLOCKS, torch.float32)
        for r in range(b):
            lg, small = m.prefill(tokens[r:r + 1], case["s_cache"], cache_dtype=torch.float32)
            ids = _pages(r)
            m.paged_insert(caches, small, r, ids[:case["s_cache"] // PAGE], ids, case["prompt"])
            out["logits"].append(lg)
        out["logits"] = [torch.cat(out["logits"])]
        gather = lambda c: {"slots": {"s0": {k: v.clone() for k, v in c["slots"]["s0"].items()}}}  # noqa: E731
    else:
        lg, caches = m.prefill(tokens, case["s_cache"], cache_dtype=torch.float32, frames=inp.get("frames"))
        out["logits"].append(lg)
        gather = lambda c: m.gather_caches(c, b)  # noqa: E731
    out["caches0"] = gather(caches)
    if "per_row" in case:
        for sec, slots in caches.items():
            for st in slots.values():
                if "pos" in st:
                    back = torch.tensor(case["per_row"], dtype=torch.int32)
                    st["pos"] = (st["pos"][..., None] - back).contiguous()
    for i in range(DECODE):
        lg, caches = step(caches, feed[:, i:i + 1], case["prompt"] + i)
        out["logits"].append(lg[:, 0])
    out["caches1"] = gather(caches)
    out["logits"] = torch.stack(out["logits"])
    if rank == 0:
        _save(d / f"port_{name}.npz", out)


def _ranks(rank: int, d: Path) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"), WORLD), rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    torch.set_num_threads(1)
    for name, case in CASES.items():
        _serve_case(rank, d, name, case)
    dist.destroy_process_group()


# ------------------------------------------------------------ the reference
def _jax(d: Path) -> None:
    """The reference: each case on a 4-device mesh of ``AxisType.Auto``
    axes, its weights placed by ``param_pspecs`` (``quantized_pspecs`` for
    int8), the prefill jitted with an f32 cache, the steps through
    ``build_serve_step(model, mesh)``, to ``jax_<name>.npz``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from repro.models.model import StreamModel as JModel, quantize_params, quantized_pspecs
    from repro.models.policy import Policy as JPolicy
    from repro.serve import build_serve_step

    for name, case in CASES.items():
        mesh = jax.make_mesh(tuple(case["shape"]), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
        pol = JPolicy.for_mesh(mesh, param_dtype="float32", compute_dtype="float32", kv_cache_dtype="float32",
                               seq_axis=case["seq"], weights_int8=case.get("int8", False))
        model = JModel(_cfg(case, jax_side=True), pol, mesh)
        params = jax.tree.map(jnp.asarray, _load(d / f"params_{name}.npz", torch_tensors=False))
        specs = model.param_pspecs()
        if case.get("int8"):
            specs = quantized_pspecs(jax.eval_shape(lambda: params), specs)
            params = quantize_params(params)
        params = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params, specs,
                              is_leaf=lambda x: isinstance(x, JP))
        inp = _load(d / f"inputs_{name}.npz", torch_tensors=False)
        b, plen = case["batch"], case["prompt"]
        step, _ = build_serve_step(model, mesh)
        out = {"logits": []}
        with mesh:
            prefill = jax.jit(lambda p, bt: model.prefill(p, bt, case["s_cache"], jnp.float32))
            if case.get("paged"):
                caches = model.init_paged_cache(b, N_BLOCKS, PAGE, MAX_BLOCKS, jnp.float32)
                lgs = []
                for r in range(b):
                    lg, small = prefill(params, {"tokens": jnp.asarray(inp["tokens"][r:r + 1])})
                    ids = _pages(r)
                    caches = model.paged_insert(caches, small, r, ids[:case["s_cache"] // PAGE], jnp.asarray(ids), plen)
                    lgs.append(lg)
                out["logits"].append(jnp.concatenate(lgs))
            else:
                batch = {"tokens": jnp.asarray(inp["tokens"])}
                if "frames" in inp:
                    batch["frames"] = jnp.asarray(inp["frames"])
                lg, caches = prefill(params, batch)
                out["logits"].append(lg)
            out["caches0"] = jax.tree.map(np.asarray, caches)
            if "per_row" in case:
                back = jnp.asarray(case["per_row"], jnp.int32)
                caches = jax.tree.map(lambda x: x, caches)
                for slots in caches.values():
                    for st in slots.values():
                        if "pos" in st:
                            st["pos"] = st["pos"][..., None] - back
            for i in range(DECODE):
                lg, caches = step(params, caches, jnp.asarray(inp["feed"][:, i:i + 1]), jnp.int32(plen + i))
                out["logits"].append(lg[:, 0])
            out["caches1"] = jax.tree.map(np.asarray, caches)
        out["logits"] = np.stack([np.asarray(x) for x in out["logits"]])
        _save(d / f"jax_{name}.npz", out)


# ------------------------------------------------------------ inputs and runs
def _inputs(d: Path, name: str, case: dict, seed: int) -> None:
    """Seeded port weights (f32), prompts and the tokens fed to the steps."""
    from repro_torch import convert
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy

    cfg = _cfg(case)
    m = StreamModel(cfg, Policy("float32", "float32", "float32"), device="cpu", generator=seed)
    _save(d / f"params_{name}.npz", convert.params_to_numpy(m.param_tree()))
    rng = np.random.default_rng(seed + 100)
    b = case["batch"]
    inp = {"tokens": rng.integers(0, cfg.vocab, (b, case["prompt"])).astype(np.int32),
           "feed": rng.integers(0, cfg.vocab, (b, DECODE)).astype(np.int32)}
    if cfg.enc_dec:
        inp["frames"] = rng.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    _save(d / f"inputs_{name}.npz", inp)


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    """Every case's inputs, then the 4 ranks and the reference at once.
    Returns the run's directory."""
    d = tmp_path_factory.mktemp("mesh_serve")
    for i, (name, case) in enumerate(CASES.items()):
        _inputs(d, name, case, seed=50 + i)
    t0 = time.monotonic()
    _run_all([(["ranks", str(r), str(d)], _env()) for r in range(WORLD)] + [(["jax", str(d)], _env(WORLD))])
    (d / "seconds.txt").write_text(f"{time.monotonic() - t0:.1f}")
    return d


def _one_process(d: Path, name: str) -> np.ndarray:
    """The port's mesh-free run of the case: the same prefill and steps."""
    from repro_torch.models.model import StreamModel, quantize_params
    from repro_torch.models.policy import Policy

    case = CASES[name]
    pol = Policy("float32", "float32", "float32", weights_int8=case.get("int8", False))
    m = StreamModel(_cfg(case), pol, device="cpu", generator=None)
    tree = _load(d / f"params_{name}.npz")
    m.load_params(quantize_params(tree) if case.get("int8") else tree)
    inp = _load(d / f"inputs_{name}.npz")
    tokens, feed = inp["tokens"].long(), inp["feed"].long()
    if case.get("paged"):
        caches = m.init_paged_cache(case["batch"], N_BLOCKS, PAGE, MAX_BLOCKS, torch.float32)
        logits = []
        for r in range(case["batch"]):
            lg, small = m.prefill(tokens[r:r + 1], case["s_cache"], cache_dtype=torch.float32)
            ids = _pages(r)
            m.paged_insert(caches, small, r, ids[:case["s_cache"] // PAGE], ids, case["prompt"])
            logits.append(lg)
        logits = [torch.cat(logits)]
    else:
        lg, caches = m.prefill(tokens, case["s_cache"], cache_dtype=torch.float32, frames=inp.get("frames"))
        logits = [lg]
    if "per_row" in case:
        for slots in caches.values():
            for st in slots.values():
                st["pos"] = (st["pos"][..., None] - torch.tensor(case["per_row"], dtype=torch.int32)).contiguous()
    for i in range(DECODE):
        lg, caches = m.decode_step(caches, feed[:, i:i + 1])
        logits.append(lg[:, 0])
    return torch.stack(logits).numpy()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


# ------------------------------------------------------------ the tests
@pytest.mark.parametrize("name", list(CASES))
def test_mesh_serving_logits_match_jax(serve_run, name):
    """The prefill's and every step's logits of the port's 4 ranks against
    the reference's mesh run, at LOGIT_TOL of the largest logit."""
    port, ref = _load(serve_run / f"port_{name}.npz"), _load(serve_run / f"jax_{name}.npz", torch_tensors=False)
    got, want = port["logits"].numpy(), ref["logits"]
    assert got.shape == want.shape == (DECODE + 1, CASES[name]["batch"], got.shape[-1])
    assert np.isfinite(got).all()
    for i in range(DECODE + 1):
        assert float(np.abs(got[i] - want[i]).max()) <= LOGIT_TOL * float(np.abs(want[i]).max()), i


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_serving_caches_match_jax(serve_run, name):
    """The gathered caches after the prefill and after the last step
    against the reference's, leaf by leaf (positions exactly, states at
    CACHE_TOL of each leaf's largest magnitude)."""
    port = _load(serve_run / f"port_{name}.npz")
    ref = _load(serve_run / f"jax_{name}.npz", torch_tensors=False)
    for when in ("caches0", "caches1"):
        got, want = dict(_leaves(port[when])), dict(_leaves(ref[when]))
        assert set(got) == set(want), (when, sorted(set(got) ^ set(want)))
        for key, w in want.items():
            g = got[key].numpy()
            assert g.shape == w.shape, (when, key, g.shape, w.shape)
            if key.endswith(("/pos", "/bt")):
                np.testing.assert_array_equal(g, w, err_msg=f"{when} {key}")
            else:
                assert float(np.abs(g - w).max()) <= CACHE_TOL * max(float(np.abs(w).max()), 1e-30), (when, key)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_serving_matches_one_process(serve_run, name):
    """The port's 4 ranks against the port's mesh-free run of the same
    prefill and steps: every logit at LOGIT_TOL of the largest."""
    got = _load(serve_run / f"port_{name}.npz")["logits"].numpy()
    want = _one_process(serve_run, name)
    for i in range(DECODE + 1):
        assert float(np.abs(got[i] - want[i]).max()) <= LOGIT_TOL * float(np.abs(want[i]).max()), i


if __name__ == "__main__":
    role, *rest = sys.argv[1:]
    if role == "jax":
        _jax(Path(rest[0]))
    else:
        _ranks(int(rest[0]), Path(rest[1]))
