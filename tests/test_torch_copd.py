"""The paper's validation model (copd-mlp, §VI) in the port: the model
against the JAX package's on moved weights, training from a stream
(Algorithm 1) with the mirrors of the JAX package's copd tests, stream
reuse (§V) and the stream-reuse example.

f32 on the CPU. Tolerances: forward, loss and every gradient leaf within
1e-6 of the JAX value relative to the array's largest element (f32 sums
in another order); the two packages' TrainingJobs over one stream within
1e-5 at each of the first 20 step losses (the same f32 arithmetic, up to
20 AdamW steps apart).
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import copd_mlp as jcopd
from repro.train import TrainingJob as JTrainingJob, adamw as jadamw
import repro_torch.core as core
import repro_torch.data as data
from repro_torch import convert
from repro_torch.configs import copd_mlp
from repro_torch.data.formats import AvroCodec, FieldSpec, RawCodec
from repro_torch.train import TrainingJob, adamw
from repro_torch.train import checkpoint as ck

REPO = Path(__file__).resolve().parents[1]
PARITY_TOL = 1e-6
TRAJ_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These models are tiny: torch's thread pool only contends with the
    other test workers, so each test here runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codec():
    return AvroCodec(
        [FieldSpec("data", "float32", (copd_mlp.N_FEATURES,))],
        [FieldSpec("label", "int32", ())],
    )


def _moved(seed=0, **kw):
    """JAX copd params from ``seed`` and the same values in the port."""
    jp = jcopd.init(jax.random.PRNGKey(seed), **kw)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _stack(n=220, **log_cfg):
    log, reg = core.StreamLog(), core.Registry()
    spec = reg.register_model("copd-mlp")
    cfg = reg.create_configuration([spec.model_id])
    dep = reg.deploy(cfg.config_id, "train")
    log.create_topic("copd", core.LogConfig(**log_cfg))
    data.ingest(log, "copd", _codec(), copd_mlp.synth_dataset(n=n), dep.deployment_id,
                validation_rate=0.2)
    return log, reg, spec, dep


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("seed,n", [(0, 220), (3, 50), (7, 400)])
def test_synth_dataset_equals_jax(seed, n):
    got, want = copd_mlp.synth_dataset(seed, n), jcopd.synth_dataset(seed, n)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_constants_equal_jax():
    for name in ("ID", "N_FEATURES", "N_CLASSES", "HIDDEN"):
        assert getattr(copd_mlp, name) == getattr(jcopd, name)


@pytest.mark.parametrize("hidden", [32, 8])
def test_forward_loss_and_grads_match_jax(hidden):
    jp, tp = _moved(1, hidden=hidden)
    ds = copd_mlp.synth_dataset(rng_seed=2, n=40)
    batch = {"data": ds["data"], "label": ds["label"]}
    np.testing.assert_array_equal(np.asarray(jp["w1"]), tp["w1"].numpy())
    assert _rel(copd_mlp.forward(tp, ds["data"]).numpy(), jcopd.forward(jp, jnp.asarray(ds["data"]))) <= PARITY_TOL

    (jl, jm), jg = jax.value_and_grad(jcopd.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tl, tm = copd_mlp.loss_fn(leaves, {k: torch.from_numpy(v) for k, v in batch.items()})
    tg = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    assert abs(float(tl.detach()) - float(jl)) <= PARITY_TOL * abs(float(jl))
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    assert tm["accuracy"].dtype == torch.float32
    for k in jg:
        assert _rel(tg[k].numpy(), jg[k]) <= PARITY_TOL, k


def test_init_draws_on_the_generators_device_and_takes_the_jax_tests_form():
    gen = torch.Generator(device="cpu").manual_seed(0)
    p = copd_mlp.init(gen)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w1": (5, 32), "b1": (32,), "w2": (32, 4), "b2": (4,)}
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in p.values())
    assert not p["b1"].any() and not p["b2"].any()
    # the form tests/test_integration.py passes as init_fn
    init_fn = lambda k, h=8: copd_mlp.init(k, hidden=h)  # noqa: E731
    p8 = init_fn(torch.Generator().manual_seed(1))
    assert p8["w1"].shape == (5, 8) and p8["w2"].shape == (8, 4)
    # the same seed draws the same weights; the scale is 1/sqrt(fan_in)
    again = copd_mlp.init(torch.Generator(device="cpu").manual_seed(0))
    assert all(torch.equal(p[k], again[k]) for k in p)
    big = copd_mlp.init(torch.Generator().manual_seed(2), n_features=400, hidden=400)
    assert abs(float(big["w1"].std()) - 1 / np.sqrt(400)) < 5e-3


def test_predict_is_softmax_without_grad():
    _, tp = _moved(4)
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    x = copd_mlp.synth_dataset(n=12)["data"]
    probs = copd_mlp.predict(leaves, x)
    assert not probs.requires_grad and probs.dtype == torch.float32
    with torch.no_grad():
        want = torch.softmax(copd_mlp.forward(leaves, x), -1)
    assert torch.equal(probs, want)
    torch.testing.assert_close(probs.sum(-1), torch.ones(12))


# ---------------------------------------------------------------- training
def test_paper_validation_copd_learns():
    """Mirror of tests/test_system.py:17: §VI, the COPD MLP pipeline
    trains to high accuracy through streams."""
    log, reg, spec, dep = _stack()
    job = TrainingJob(log, reg, dep.deployment_id, spec.model_id,
                      loss_fn=copd_mlp.loss_fn, init_fn=copd_mlp.init,
                      opt=adamw(1e-2), device="cpu")
    res = job.run(batch_size=10, epochs=25)
    assert res.eval_metrics["accuracy"] > 0.9
    results = reg.results_for(dep.deployment_id)
    assert len(results) == 1 and results[0].metrics["loss"] < 0.5


@pytest.mark.parametrize("streaming", [False, True])
def test_training_job_trajectory_matches_jax(streaming):
    """The two packages' TrainingJobs over one stream from the same moved
    parameters: each of the first 20 step losses within 1e-5, and the
    same eval."""
    log, reg, spec, dep = _stack()
    jp, tp = _moved(5)
    jl, tl = [], []

    def jloss(p, b):
        loss, met = jcopd.loss_fn(p, b)
        jax.debug.callback(lambda v: jl.append(float(v)), met["loss"])
        return loss, met

    def tloss(p, b):
        loss, met = copd_mlp.loss_fn(p, b)
        if torch.is_grad_enabled():
            tl.append(float(met["loss"].detach()))
        return loss, met

    kw = dict(batch_size=10, max_steps=20, streaming=streaming, fetch_records=32)
    jres = JTrainingJob(log, reg, dep.deployment_id, spec.model_id, loss_fn=jloss,
                        init_fn=lambda _: jp, opt=jadamw(1e-2)).run(**kw)
    tres = TrainingJob(log, reg, dep.deployment_id, spec.model_id, loss_fn=tloss,
                       init_fn=lambda _: {k: v.clone() for k, v in tp.items()},
                       opt=adamw(1e-2), device="cpu").run(**kw)
    assert tres.steps == jres.steps == 20 and len(tl) == 20
    np.testing.assert_allclose(tl, jl[:20], rtol=0, atol=TRAJ_TOL)
    for k in ("loss", "accuracy"):
        assert tres.eval_metrics[k] == pytest.approx(jres.eval_metrics[k], abs=TRAJ_TOL)


def test_offset_coupled_resume_trains_to_completion(tmp_path):
    """Mirror of tests/test_checkpoint.py:60: a job killed mid-run resumes
    from its checkpoint (step + stream offsets) and finishes with the
    metrics of an uninterrupted run."""
    log, reg, spec, dep = _stack()

    def mkjob(d):
        return TrainingJob(log, reg, dep.deployment_id, spec.model_id,
                           loss_fn=copd_mlp.loss_fn, init_fn=copd_mlp.init,
                           opt=adamw(1e-2), ckpt_dir=str(d), ckpt_every=10, seed=3, device="cpu")

    ref = mkjob(tmp_path / "ref").run(batch_size=10, max_steps=60)
    with pytest.raises(RuntimeError, match="injected crash"):
        mkjob(tmp_path / "c").run(batch_size=10, max_steps=60, crash_after=25)
    res = mkjob(tmp_path / "c").run(batch_size=10, max_steps=60, resume=True)
    assert res.steps == 60
    assert res.metrics["loss"] == pytest.approx(ref.metrics["loss"], abs=1e-5)
    template = {"params": copd_mlp.init(torch.Generator().manual_seed(3))}
    template["opt"] = adamw(1e-2).init(template["params"])
    _, offsets, meta = ck.restore(str(tmp_path / "c"), template)
    assert meta["deployment_id"] == dep.deployment_id
    assert all(v > 0 for v in offsets.values())


def test_async_checkpoint_snapshots_the_state_at_the_call(tmp_path, monkeypatch):
    """save_async copies the state when it is called: the in-place update
    of the next step must not reach the checkpoint being written, on the
    CPU either (where ``.cpu()`` shares the parameters' storage). The
    write is held until after the update."""
    release = threading.Event()
    real_save = ck.save

    def held_save(*args, **kw):
        release.wait(10)
        return real_save(*args, **kw)

    monkeypatch.setattr(ck, "save", held_save)
    params = copd_mlp.init(torch.Generator().manual_seed(0))
    want = {k: v.clone() for k, v in params.items()}
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save_async(10, {"params": params})
    with torch.no_grad():
        for v in params.values():
            v.add_(1.0)  # the next step's update, in place
    release.set()
    mgr.wait()
    restored, _, _ = ck.restore(str(tmp_path), {"params": {k: torch.zeros_like(v) for k, v in params.items()}})
    for k in want:
        assert torch.equal(restored["params"][k], want[k]), k


def test_stream_reuse_trains_second_config_without_reingestion():
    """Mirror of tests/test_integration.py:82: a second deployment trains
    from the same log ranges via a control-message replay; no data is
    re-sent and the trajectory is the same."""
    log, reg = core.StreamLog(), core.Registry()
    m1 = reg.register_model("copd-mlp")
    d1 = reg.deploy(reg.create_configuration([m1.model_id]).config_id, "train")
    log.create_topic("shared")
    msg1 = data.ingest(log, "shared", _codec(), copd_mlp.synth_dataset(), d1.deployment_id,
                       validation_rate=0.2)
    bytes_after_ingest = log.size_bytes("shared")

    def run(spec, dep):
        return TrainingJob(log, reg, dep.deployment_id, spec.model_id,
                           loss_fn=copd_mlp.loss_fn, init_fn=copd_mlp.init,
                           opt=adamw(1e-2), device="cpu").run(batch_size=10, epochs=5)

    r1 = run(m1, d1)
    m2 = reg.register_model("copd-mlp")
    d2 = reg.deploy(reg.create_configuration([m2.model_id]).config_id, "train")
    core.ControlLogger(log).replay(msg1, d2.deployment_id)
    assert log.size_bytes("shared") == bytes_after_ingest  # no data re-sent
    r2 = run(m2, d2)
    assert r2.metrics["loss"] == pytest.approx(r1.metrics["loss"], abs=1e-6)


def test_retention_expiry_blocks_reuse():
    """Mirror of tests/test_integration.py:113: once retention evicts a
    stream, a replay points at evicted offsets and the job fails fast."""
    log, reg = core.StreamLog(), core.Registry()
    m = reg.register_model("copd-mlp")
    c = reg.create_configuration([m.model_id])
    d1 = reg.deploy(c.config_id, "train")
    log.create_topic("small", core.LogConfig(retention_bytes=2000, segment_bytes=500))
    msg = data.ingest(log, "small", _codec(), copd_mlp.synth_dataset(n=50), d1.deployment_id)
    data.ingest(log, "small", _codec(), copd_mlp.synth_dataset(n=400), "other-dep")
    d2 = reg.deploy(c.config_id, "train")
    core.ControlLogger(log).replay(msg, d2.deployment_id)
    job = TrainingJob(log, reg, d2.deployment_id, m.model_id,
                      loss_fn=copd_mlp.loss_fn, init_fn=copd_mlp.init, device="cpu")
    with pytest.raises(core.OffsetOutOfRange):
        job.run(batch_size=10, epochs=1)


def test_streaming_over_cluster_backend():
    """Mirror of tests/test_pipeline.py:217 on the port's BrokerCluster:
    the streaming iterator rides the leader-routed consumer path and stays
    byte-identical to the materialized read, and to the JAX package's
    batches over the same records."""
    from repro.data.pipeline import StreamingBatchIterator as JStreaming
    from repro_torch.data.pipeline import BatchIterator, StreamingBatchIterator

    c = core.BrokerCluster(3)
    c.create_topic("t", core.LogConfig(num_partitions=2, replication_factor=3))
    codec = RawCodec("float32", (3,), "int32", ())
    n = 60
    arrays = {
        "data": np.arange(n * 3, dtype=np.float32).reshape(n, 3),
        "label": np.arange(n, dtype=np.int32),
    }
    msg = data.ingest(c, "t", codec, arrays, "D", validation_rate=0.2, message_set_size=16)
    tr, _ = data.StreamDataset(c, msg).split()
    stream = list(StreamingBatchIterator(c, msg, 8, split="train", epochs=1, fetch_records=11))
    ref = list(BatchIterator(tr, 8, shuffle=False, epochs=1))
    jstream = list(JStreaming(c, msg, 8, split="train", epochs=1, fetch_records=11))
    assert len(stream) == len(ref) == len(jstream) == 6
    for got, *wants in zip(stream, ref, jstream):
        for want in wants:
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert np.ascontiguousarray(got[k]).tobytes() == np.ascontiguousarray(want[k]).tobytes()


def test_stream_reuse_example_on_the_cpu():
    """examples/torch_stream_reuse.py --device cpu under its watchdog: two
    replays train from the stream, and the replay after expiry fails with
    OffsetOutOfRange."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "STREAM_REUSE_TIMEOUT_S": "100"}
    out = subprocess.run([sys.executable, str(REPO / "examples" / "torch_stream_reuse.py"), "--device", "cpu"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert sum(line.startswith(("D2: reused stream", "D3: reused stream")) for line in lines) == 2
    assert any(line.startswith("D4: replay after expiry correctly fails:") and "evicted by retention" in line
               for line in lines), out.stdout
