"""An LM behind the port's InferenceDeployment (examples/serve_lm.py's
path): ``build_prefill_step`` + ``build_serve_step`` on reduced yi-6b
against the JAX package's steps, the two packages' deployments over the
same prompts through a replica's death, and the example.

Reduced yi-6b in f32 on the CPU, moved weights; the caches are bf16, the
steps' default in both packages. Greedy tokens must be identical, and so
must the completion records (int32 tokens), byte for byte and in order.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.core as jcore
from repro.models.model import StreamModel as JModel
from repro.models.policy import Policy as JPolicy
from repro.serve import InferenceDeployment as JInferenceDeployment
from repro.serve import build_prefill_step as jbuild_prefill_step, build_serve_step as jbuild_serve_step
import repro_torch.configs as TC
import repro_torch.core as core
from repro_torch import convert
from repro_torch.models.model import StreamModel
from repro_torch.models.policy import Policy
from repro_torch.serve import InferenceDeployment, build_prefill_step, build_serve_step

REPO = Path(__file__).resolve().parents[1]
PROMPT, GEN = 24, 8  # examples/serve_lm.py's


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These models are tiny: torch's thread pool only contends with the
    other test workers, so each test here runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jm = JModel(JC.get_reduced("yi-6b"), JPolicy(param_dtype="float32", compute_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = StreamModel(TC.get_reduced("yi-6b"), Policy("float32", "float32", "float32"), device="cpu", generator=None)
    tm.load_params(convert.params_from_jax(jax.tree.map(np.asarray, jp)))
    return jm, jp, tm


def _example():
    """examples/torch_serve_lm.py as a module (examples/ is no package)."""
    spec = importlib.util.spec_from_file_location("torch_serve_lm", REPO / "examples" / "torch_serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_generate(jm, jp):
    """examples/serve_lm.py's ``generate`` on the JAX package's steps."""
    prefill = jbuild_prefill_step(jm, PROMPT + GEN)
    decode = jbuild_serve_step(jm)

    def generate(d):
        logits, cache = prefill(jp, {"tokens": jnp.asarray(d["data"].astype(np.int32))})
        out = []
        tok = jnp.argmax(logits, -1)[:, None]
        for i in range(GEN):
            out.append(tok)
            lg, cache = decode(jp, cache, tok, jnp.int32(PROMPT + i))
            tok = jnp.argmax(lg[:, 0], -1)[:, None]
        return np.asarray(jnp.concatenate(out, axis=1)).astype(np.int32)

    return generate


def _prompts(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, PROMPT)).astype(np.int32)


def test_greedy_tokens_match_jax_steps(pair):
    """The port's steps (through the example's ``make_generate``) give the
    JAX loop's greedy tokens for 8 steps, on a batch of 4 prompts."""
    jm, jp, tm = pair
    prompts = _prompts(4)
    want = _jax_generate(jm, jp)({"data": prompts})
    got = _example().make_generate(tm)({"prompt": prompts})
    assert got.dtype == torch.int32 and tuple(got.shape) == (4, GEN)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_step_logits_and_cache_match_jax(pair):
    """The prefill step's last-position logits against JAX's (1e-5 of the
    largest), and its cache: bf16 K/V of s_cache slots at the prompt's
    position."""
    jm, jp, tm = pair
    prompts = _prompts(2, seed=1)
    jl, jc = jbuild_prefill_step(jm, PROMPT + GEN)(jp, {"tokens": jnp.asarray(prompts)})
    tl, tc = build_prefill_step(tm, PROMPT + GEN)({"tokens": prompts})
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() <= 1e-5 * np.abs(jl).max()
    st = tc["slots"]["s0"]
    assert st["k"].dtype == torch.bfloat16 and st["k"].shape[2] == PROMPT + GEN
    assert st["k"].shape == tuple(jc["slots"]["s0"]["k"].shape)
    assert (st["pos"] == PROMPT).all()


def test_steps_refuse_a_mesh(pair, tmp_path):
    """Both built steps on a (1, 1) mesh of one gloo rank give the mesh-free
    steps' bits: the prefill's logits and bf16 cache, then each greedy
    step's logits and the cache after them. With the mesh the serve step
    comes with its parameter specs, as JAX's comes with its shardings; a
    mesh the model was not built on is refused."""
    import torch.distributed as dist

    from repro_torch.launch import make_mesh

    _, _, tm = pair
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        pol = Policy.for_mesh(mesh, param_dtype="float32", compute_dtype="float32", kv_cache_dtype="float32")
        mm = StreamModel(TC.get_reduced("yi-6b"), pol, device="cpu", generator=None, mesh=mesh)
        mm.load_params(tm.param_tree())
        prompts = _prompts(2, seed=3)
        lf, cf = build_prefill_step(tm, PROMPT + GEN)({"tokens": prompts})
        lm, cm = build_prefill_step(mm, PROMPT + GEN, mesh)({"tokens": prompts})
        assert torch.equal(lf, lm)
        free, (meshed, specs) = build_serve_step(tm), build_serve_step(mm, mesh)
        assert specs == mm.param_pspecs()
        tok = lf.argmax(-1)[:, None]
        for i in range(GEN):
            a, cf = free(cf, tok, PROMPT + i)
            b, cm = meshed(cm, tok, PROMPT + i)
            assert torch.equal(a, b), i
            tok = a[:, 0].argmax(-1)[:, None]
        for key in ("k", "v", "pos"):
            assert torch.equal(cf["slots"]["s0"][key], cm["slots"]["s0"][key]), key
        for build in (lambda: build_serve_step(tm, mesh), lambda: build_prefill_step(tm, 8, mesh)):
            with pytest.raises(ValueError, match="not built on this mesh"):
                build()
    finally:
        dist.destroy_process_group()


def _deploy(pkg_core, deploy, predict, prompts, calls):
    """examples/serve_lm.py's flow on one package: 4 partitions of 2
    prompts, 2 replicas on a controlled clock, replica 0 killed and 60 s
    passed, the prompts again. Returns the completion records, each
    round's served count and the replicas' counts after each round."""
    log, reg = pkg_core.StreamLog(), pkg_core.Registry()
    spec = reg.register_model("yi-6b-smoke")
    dep = reg.deploy(reg.create_configuration([spec.model_id]).config_id, "train")
    result = reg.upload_result(
        dep.deployment_id, spec.model_id, {"loss": 0.0}, input_format="RAW",
        input_config={"data_type": "int32", "data_reshape": [PROMPT],
                      "label_type": "int32", "label_reshape": []},
    )
    log.create_topic("prompts", pkg_core.LogConfig(num_partitions=4))
    t = [0.0]

    def counted(d):
        calls.append(d["data"].shape)
        return predict(d)

    infer = deploy(log, reg, result.result_id, predict_fn=counted, input_topic="prompts",
                   output_topic="completions", replicas=2, session_timeout_s=30.0, clock=lambda: t[0])
    served, per_replica = [], []
    try:
        for rnd in range(2):
            if rnd:
                infer.kill_replica(0)
                t[0] += 60.0
            for part in range(4):
                log.produce_batch("prompts", [r.tobytes() for r in prompts[part * 2:part * 2 + 2]], partition=part)
            served.append(infer.drain())
            per_replica.append([r.stats.processed for r in infer.replicas])
    finally:
        infer.close()
    records = [bytes(v) for v in log.read("completions", 0, 0, 100).values]
    return records, served, per_replica


def test_deployment_records_match_jax_through_a_replica_death(pair):
    """The two packages' deployments over the same prompts: 8 prompts a
    round, one prefill a partition's batch of 2, replica 1 alone serves
    round 2, and the completion records are the same bytes in the same
    order."""
    jm, jp, tm = pair
    prompts = _prompts(8, seed=2)
    jcalls, tcalls = [], []
    jrec, jserved, jper = _deploy(jcore, JInferenceDeployment, _jax_generate(jm, jp), prompts, jcalls)
    gen = _example().make_generate(tm)
    trec, tserved, tper = _deploy(core, InferenceDeployment, lambda d: gen({"prompt": d["data"]}), prompts, tcalls)
    assert tserved == jserved == [8, 8]
    assert tper == jper == [[4, 4], [4, 12]]  # replica 1 served all of round 2
    assert tcalls == jcalls == [(2, PROMPT)] * 8  # every poll's batch: one partition's 2 prompts
    assert len(trec) == 16 and all(len(r) == 4 * GEN for r in trec)
    assert trec == jrec


def test_serve_lm_example_on_the_cpu():
    """examples/torch_serve_lm.py --device cpu under its watchdog: 32
    prompts served by both replicas, then 32 more by replica 1 alone."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "SERVE_LM_TIMEOUT_S": "100"}
    out = subprocess.run([sys.executable, str(REPO / "examples" / "torch_serve_lm.py"), "--device", "cpu"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert "served 32 prompts; per-replica: {'replica-0': 16, 'replica-1': 16}" in lines, out.stdout
    assert ("after killing replica-0: served 32 more; per-replica: {'replica-0': 16, 'replica-1': 48}"
            in lines), out.stdout
    assert any(line.startswith("64 completions on output topic") for line in lines), out.stdout
