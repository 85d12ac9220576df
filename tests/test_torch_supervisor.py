"""The port's Supervisor (the paper's §IV-B back-end deploy loop with
bounded restart) over the port's TrainingJob: the mirrors of
tests/test_supervisor.py, a restart that resumes from the offset-coupled
checkpoint at the step it died, and the copy's exports."""

import pytest
import torch

import repro_torch.core as core
import repro_torch.data as data
from repro_torch.configs import copd_mlp
from repro_torch.core.supervisor import JobOutcome, Supervisor
from repro_torch.data.formats import AvroCodec, FieldSpec
from repro_torch.train import TrainingJob, adamw


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These models are tiny: torch's thread pool only contends with the
    other test workers, so each test here runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(n_models=2):
    log, reg = core.StreamLog(), core.Registry()
    specs = [reg.register_model("copd-mlp") for _ in range(n_models)]
    cfg = reg.create_configuration([s.model_id for s in specs])
    dep = reg.deploy(cfg.config_id, "train", training_kwargs={"batch_size": 10, "max_steps": 40})
    codec = AvroCodec(
        [FieldSpec("data", "float32", (copd_mlp.N_FEATURES,))],
        [FieldSpec("label", "int32", ())],
    )
    log.create_topic("copd")
    data.ingest(log, "copd", codec, copd_mlp.synth_dataset(), dep.deployment_id, validation_rate=0.2)
    return log, reg, dep


def _job(cls, log, reg, dep_, spec_, ckpt_dir):
    return cls(log, reg, dep_.deployment_id, spec_.model_id,
               loss_fn=copd_mlp.loss_fn, init_fn=copd_mlp.init,
               opt=adamw(1e-2), ckpt_dir=ckpt_dir, ckpt_every=10, device="cpu")


def test_exports_follow_the_jax_package():
    assert core.Supervisor is Supervisor and core.JobOutcome is JobOutcome
    assert {"JobOutcome", "Supervisor"} <= set(core.__all__)


def test_supervisor_runs_whole_configuration(tmp_path):
    """Mirror of tests/test_supervisor.py:30."""
    log, reg, dep = _stack()
    sup = Supervisor(log, reg, lambda d, s, ck: _job(TrainingJob, log, reg, d, s, ck), ckpt_root=str(tmp_path))
    outcomes = sup.reconcile()
    assert len(outcomes) == 2 and all(o.ok for o in outcomes)
    assert reg.deployment(dep.deployment_id).status == "finished"
    assert len(reg.results_for(dep.deployment_id)) == 2
    assert sup.pending_deployments() == []


def test_supervisor_restarts_crashed_job_from_checkpoint(tmp_path):
    """Mirror of tests/test_supervisor.py:47: the first attempt dies after
    15 steps, the second resumes from its step-10 checkpoint and finishes
    the 40 steps."""
    log, reg, dep = _stack(n_models=1)
    crashes = {"left": 1}
    starts = []

    def factory(dep_, spec_, ckpt_dir):
        crash_after = 15 if crashes["left"] > 0 else None
        crashes["left"] = max(crashes["left"] - 1, 0)

        class Wrapped(TrainingJob):
            def run(self, **kw):
                return super().run(crash_after=crash_after, **kw)

        job = _job(Wrapped, log, reg, dep_, spec_, ckpt_dir)
        steps = []

        def loss_fn(p, b):
            if torch.is_grad_enabled():
                steps.append(1)
            return copd_mlp.loss_fn(p, b)

        job.loss_fn = loss_fn
        starts.append(steps)
        return job

    sup = Supervisor(log, reg, factory, ckpt_root=str(tmp_path), max_restarts=2)
    outcomes = sup.reconcile()
    assert len(outcomes) == 1
    assert outcomes[0].ok and outcomes[0].attempts == 2  # crash -> resume -> done
    assert reg.deployment(dep.deployment_id).status == "finished"
    # the resumed attempt trained only the steps after its checkpoint
    assert [len(s) for s in starts] == [15, 30]


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    """Mirror of tests/test_supervisor.py:70."""
    log, reg, dep = _stack(n_models=1)

    class AlwaysCrash(TrainingJob):
        def run(self, **kw):
            return super().run(crash_after=5, **kw)

    sup = Supervisor(log, reg, lambda d, s, ck: _job(AlwaysCrash, log, reg, d, s, ck),
                     ckpt_root=str(tmp_path), max_restarts=1)
    outcomes = sup.reconcile()
    assert not outcomes[0].ok and outcomes[0].attempts == 2
    assert "injected crash" in outcomes[0].error
    assert reg.deployment(dep.deployment_id).status == "failed"
