"""The port's checkpoints: the mirrors of tests/test_checkpoint.py, a
checkpoint written by either package restored by the other, and the
offset-coupled and streaming resumes on reduced yi-6b (f32, CPU)."""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jck
import repro_torch.configs as TC
import repro_torch.core as core
import repro_torch.data as data
from repro_torch.data.formats import RawCodec
from repro_torch.models.model import StreamModel
from repro_torch.models.policy import Policy
from repro_torch.train import TrainingJob, adamw
from repro_torch.train import checkpoint as ck
from repro_torch.train.optimizer import tree_leaves

SEQ = 17


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These models are tiny: torch's thread pool only contends with the
    other test workers, so each test here runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((4, 3), generator=g), "b": torch.zeros(3)},
        "opt": {"step": torch.tensor(7, dtype=torch.int32), "m": {"w": torch.ones((4, 3)), "b": torch.zeros(3)}},
    }


def _zeros_like(state):
    if isinstance(state, dict):
        return {k: _zeros_like(v) for k, v in state.items()}
    return torch.zeros_like(state)


def test_save_restore_roundtrip(tmp_path):
    s = _state()
    ck.save(str(tmp_path), 10, s, offsets={"[t:0:0:100]": 100}, meta={"next_step": 10})
    template = _zeros_like(s)
    s2, offsets, meta = ck.restore(str(tmp_path), template)
    assert s2 is template  # filled in place
    for a, b in zip(tree_leaves(s), tree_leaves(s2)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert offsets == {"[t:0:0:100]": 100}
    assert meta["next_step"] == 10


def test_latest_step_and_retention(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save_async(step, _state(step))
        mgr.wait()
    assert mgr.latest() == 4
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ck.restore(str(tmp_path / "nope"), _state())


def test_restore_casts_dtype(tmp_path):
    ck.save(str(tmp_path), 0, {"w": torch.ones((2, 2), dtype=torch.float32)})
    s2, _, _ = ck.restore(str(tmp_path), {"w": torch.zeros((2, 2), dtype=torch.bfloat16)})
    assert s2["w"].dtype == torch.bfloat16 and torch.equal(s2["w"].float(), torch.ones((2, 2)))


def test_atomicity_no_tmp_left_behind(tmp_path):
    ck.save(str(tmp_path), 5, _state())
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def _bf16_state(rng):
    w = rng.standard_normal((2, 4, 3)).astype(np.float32)
    return w, w.astype(ml_dtypes.bfloat16), rng.standard_normal(5).astype(np.float32)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """Flat keys, bf16 stored as f32, a 0-d int32 step: the JAX package's
    file restores into the port's tree leaf for leaf."""
    _, wb, m = _bf16_state(np.random.default_rng(0))
    jstate = {"params": {"slots": {"s0": {"w": jnp.asarray(wb)}}}, "opt": {"step": jnp.int32(3), "m": {"x": jnp.asarray(m)}}}
    jck.save(str(tmp_path), 3, jstate, offsets={"r": 9}, meta={"next_step": 3})
    template = {"params": {"slots": {"s0": {"w": torch.zeros((2, 4, 3), dtype=torch.bfloat16)}}},
                "opt": {"step": torch.zeros((), dtype=torch.int32), "m": {"x": torch.zeros(5)}}}
    state, offsets, meta = ck.restore(str(tmp_path), template)
    assert torch.equal(state["params"]["slots"]["s0"]["w"].float(), torch.from_numpy(wb.astype(np.float32)))
    assert int(state["opt"]["step"]) == 3 and torch.equal(state["opt"]["m"]["x"], torch.from_numpy(m))
    assert offsets == {"r": 9} and meta == {"next_step": 3}


def test_port_checkpoint_restores_in_jax(tmp_path):
    _, wb, m = _bf16_state(np.random.default_rng(1))
    tstate = {"params": {"slots": {"s0": {"w": torch.from_numpy(wb.astype(np.float32)).to(torch.bfloat16)}}},
              "opt": {"step": torch.tensor(4, dtype=torch.int32), "m": {"x": torch.from_numpy(m)}}}
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save_async(4, tstate, offsets={"r": 11}, meta={"next_step": 4})
    mgr.wait()
    template = {"params": {"slots": {"s0": {"w": jax.ShapeDtypeStruct((2, 4, 3), jnp.bfloat16)}}},
                "opt": {"step": jax.ShapeDtypeStruct((), jnp.int32), "m": {"x": jax.ShapeDtypeStruct((5,), jnp.float32)}}}
    state, offsets, meta = jck.restore(str(tmp_path), template)
    assert state["params"]["slots"]["s0"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(state["params"]["slots"]["s0"]["w"]).astype(np.float32), wb.astype(np.float32))
    assert int(state["opt"]["step"]) == 4
    np.testing.assert_array_equal(np.asarray(state["opt"]["m"]["x"]), m)
    assert offsets == {"r": 11} and meta["next_step"] == 4


def _synth_corpus(n, vocab, seq, seed):
    """examples/torch_train_lm.py's generator (examples/ is no package)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "torch_train_lm.py"
    spec = importlib.util.spec_from_file_location("torch_train_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.synth_corpus(n, vocab, seq=seq, seed=seed)


def _stream():
    corpus = _synth_corpus(40, 256, SEQ, 4)
    log, reg = core.StreamLog(), core.Registry()
    spec = reg.register_model("yi-6b-smoke")
    dep = reg.deploy(reg.create_configuration([spec.model_id]).config_id, "train")
    log.create_topic("corpus", core.LogConfig(num_partitions=2))
    data.ingest(log, "corpus", RawCodec("int32", (SEQ,), "int32", ()),
                {"data": corpus, "label": np.zeros(len(corpus), np.int32)}, dep.deployment_id,
                validation_rate=0.2)
    return log, reg, spec, dep


@pytest.mark.parametrize("streaming", [False, True])
def test_resume_matches_uninterrupted(tmp_path, streaming):
    """Mirrors of tests/test_checkpoint.py:60 (offset-coupled resume) and
    :102 (streaming resume) on reduced yi-6b: kill a job mid-run, resume
    it from its checkpoint (step + stream offsets), land on the
    uninterrupted run's final loss (1e-5)."""
    log, reg, spec, dep = _stream()
    model = StreamModel(TC.get_reduced("yi-6b"), Policy("float32", "float32", "float32"), device="cpu",
                        generator=None)

    def run(d, **kw):
        job = TrainingJob(log, reg, dep.deployment_id, spec.model_id,
                          loss_fn=lambda p, b: model.loss(p, {"tokens": b["data"]}),
                          init_fn=model.init, opt=adamw(1e-2), ckpt_dir=str(d), ckpt_every=4,
                          seed=3, device="cpu")
        # fetch_records=8 keeps several polls per epoch in play, so the
        # resumed run re-enters mid-stream, not at a poll boundary
        return job.run(batch_size=4, max_steps=14, streaming=streaming, fetch_records=8, **kw)

    ref = run(tmp_path / "ref")
    with pytest.raises(RuntimeError, match="injected crash"):
        run(tmp_path / "c", crash_after=6)
    res = run(tmp_path / "c", resume=True)
    assert res.steps == 14
    assert res.metrics["loss"] == pytest.approx(ref.metrics["loss"], abs=1e-5)
    # offsets recorded in the checkpoint point at the consumed stream
    template = {"params": model.param_tree(), "opt": adamw(1e-2).init(model.param_tree())}
    _, offsets, meta = ck.restore(str(tmp_path / "c"), template)
    assert meta["deployment_id"] == dep.deployment_id
    assert all(v > 0 for v in offsets.values())
