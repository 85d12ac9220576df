"""The port's InferenceDeployment (the paper's Algorithm 2): the copd-mlp
deployment against the JAX package's on moved weights, the mirrors of
the JAX package's deployment tests (Fig. 1 flow, parallel polling,
eviction and rejoin, zombie fencing, follower reads through an election),
exactly-once publish across a leader kill, predicting on the pool's
threads with parameters that require grad, and the quickstart example.

f32 on the CPU. The prediction records of the two packages are held
record by record, in order, within 1e-6 (f32 sums in another order).
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import copd_mlp as jcopd
from repro.serve import InferenceDeployment as JInferenceDeployment
import repro_torch.core as core
import repro_torch.data as data
from repro_torch import convert
from repro_torch.configs import copd_mlp
from repro_torch.core.cluster import BrokerCluster, ClusterConsumer, ClusterError
from repro_torch.core.log import LogConfig, StreamLog, TopicPartition
from repro_torch.data.formats import AvroCodec, FieldSpec, RawCodec
from repro_torch.serve import InferenceDeployment
from repro_torch.serve.engine import _to_numpy
from repro_torch.train import TrainingJob, adamw

REPO = Path(__file__).resolve().parents[1]
RECORD_TOL = 1e-6


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


def _fabricated_result(reg, codec=None):
    """A registered model whose result decodes RAW float32[3] requests."""
    codec = codec or RawCodec("float32", (3,), "int32", ())
    spec = reg.register_model("copd-mlp")
    cfg = reg.create_configuration([spec.model_id])
    dep = reg.deploy(cfg.config_id, "inference")
    reg.upload_result(
        dep.deployment_id, spec.model_id, {}, {},
        input_format=codec.FORMAT, input_config=codec.input_config(),
    )
    return reg.results_for(dep.deployment_id)[-1].result_id


def _moved_grad(seed):
    """JAX copd params from ``seed`` and the same values in the port,
    requiring grad as a trained job's do."""
    jp = jcopd.init(jax.random.PRNGKey(seed))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    return jp, {k: v.requires_grad_(True) for k, v in tp.items()}


def _committed_values(cluster, topic, p, group="audit"):
    """Every record a read_committed consumer can observe."""
    cons = ClusterConsumer(cluster, group_id=group, isolation_level="read_committed")
    out, off = [], 0
    while True:
        batch = cons.fetch(topic, p, off, 1024)
        if len(batch) == 0 and (batch.scanned or 0) == 0:
            return out
        out.extend(bytes(v) for v in batch.values)
        off = batch.next_offset


# ------------------------------------------------------------ the collect step
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_collect_copies_a_tensor_to_numpy_in_its_dtype(dtype):
    t = torch.arange(6, dtype=dtype).reshape(2, 3)
    got = _to_numpy(t)
    assert isinstance(got, np.ndarray) and got.dtype == t.numpy().dtype
    np.testing.assert_array_equal(got, t.numpy())


def test_collect_passes_numpy_through_and_refuses_bf16():
    a = np.ones((2, 3), np.float32)
    assert _to_numpy(a) is a
    with pytest.raises(TypeError):
        _to_numpy(torch.ones(2, dtype=torch.bfloat16))  # numpy has no bf16: no silent cast


# -------------------------------------------------- records against the JAX's
@pytest.mark.parametrize("parallel", [False, True])
def test_prediction_records_match_jax(parallel):
    """The quickstart's deployment in each package on the same moved
    parameters and the same 20 requests over 2 partitions: the same
    number of f32 probability records in the same order, each within
    1e-6 of the JAX package's."""
    jp = jcopd.init(jax.random.PRNGKey(7))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    reqs = copd_mlp.synth_dataset(rng_seed=1, n=20)["data"]
    records = {}
    for pkg, pkg_core, deploy, predict in (
        ("jax", jcore, JInferenceDeployment,
         lambda d: np.asarray(jax.nn.softmax(jcopd.forward(jp, d["data"]), axis=-1))),
        ("torch", core, InferenceDeployment, lambda d: copd_mlp.predict(tp, d["data"])),
    ):
        lg, reg_ = pkg_core.StreamLog(), pkg_core.Registry()
        lg.create_topic("requests", pkg_core.LogConfig(num_partitions=2))
        infer = deploy(lg, reg_, _fabricated_result(reg_, _codec()), predict_fn=predict,
                       input_topic="requests", output_topic="preds", replicas=2, parallel_poll=parallel)
        lg.produce_batch("requests", [r.tobytes() for r in reqs[:12]], partition=0)
        lg.produce_batch("requests", [r.tobytes() for r in reqs[12:]], partition=1)
        try:
            assert infer.drain() == 20
        finally:
            infer.close()
        records[pkg] = [bytes(v) for v in lg.read("preds", 0, 0, 100).values]
    assert len(records["jax"]) == len(records["torch"]) == 20
    assert all(len(r) == 4 * copd_mlp.N_CLASSES for r in records["torch"])
    got = np.frombuffer(b"".join(records["torch"]), np.float32).reshape(20, -1)
    want = np.frombuffer(b"".join(records["jax"]), np.float32).reshape(20, -1)
    np.testing.assert_allclose(got, want, rtol=0, atol=RECORD_TOL)


def test_parallel_poll_with_parameters_that_require_grad():
    """A trained job's parameters require grad, and grad mode is on in a
    pool thread: copd_mlp.predict serves them on the pool, giving the
    bytes of a serial no-grad forward."""
    _, tp = _moved_grad(3)
    reqs = copd_mlp.synth_dataset(rng_seed=4, n=16)["data"]
    log = StreamLog()
    log.create_topic("requests", LogConfig(num_partitions=2))
    reg = core.Registry()
    infer = InferenceDeployment(
        log, reg, _fabricated_result(reg, _codec()),
        predict_fn=lambda d: copd_mlp.predict(tp, d["data"]),
        input_topic="requests", output_topic="preds", replicas=2, parallel_poll=True,
    )
    log.produce_batch("requests", [r.tobytes() for r in reqs[:8]], partition=0)
    log.produce_batch("requests", [r.tobytes() for r in reqs[8:]], partition=1)
    try:
        assert infer.drain() == 16
    finally:
        infer.close()
    with torch.no_grad():  # one batch a partition, in replica order, as served
        want = np.concatenate([torch.softmax(copd_mlp.forward(tp, half), -1).numpy()
                               for half in (reqs[:8], reqs[8:])])
    got = log.read("preds", 0, 0, 100).to_matrix().view(np.float32)
    np.testing.assert_array_equal(got, want)


def test_a_predict_that_builds_a_graph_fails_loudly():
    """Without no_grad the pool thread builds a graph, and the collect
    step refuses the tensor rather than detach it silently."""
    _, tp = _moved_grad(3)
    log = StreamLog()
    log.create_topic("requests", LogConfig(num_partitions=2))
    reg = core.Registry()
    infer = InferenceDeployment(
        log, reg, _fabricated_result(reg, _codec()),
        predict_fn=lambda d: copd_mlp.forward(tp, d["data"]),
        input_topic="requests", output_topic="preds", replicas=2, parallel_poll=True,
    )
    reqs = copd_mlp.synth_dataset(n=4)["data"]
    log.produce_batch("requests", [r.tobytes() for r in reqs], partition=0)
    try:
        with pytest.raises(RuntimeError, match="requires grad"):
            infer.poll_all()
    finally:
        infer.close()


# ------------------------------------------------------------------ Fig. 1
def test_full_pipeline_fig1():
    """Mirror of tests/test_integration.py:34: two models of one
    configuration trained from one stream, compared, and the best
    deployed for streaming inference by 2 replicas."""
    log, reg = StreamLog(), core.Registry()
    m1 = reg.register_model("copd-mlp", {"hidden": 32})
    m2 = reg.register_model("copd-mlp", {"hidden": 8})
    cfg = reg.create_configuration([m1.model_id, m2.model_id])
    dep = reg.deploy(cfg.config_id, "train", training_kwargs={"batch_size": 10})
    log.create_topic("copd")
    ds = copd_mlp.synth_dataset()
    data.ingest(log, "copd", _codec(), ds, dep.deployment_id, validation_rate=0.2)
    for spec in (m1, m2):
        hidden = spec.overrides.get("hidden", 32)
        job = TrainingJob(
            log, reg, dep.deployment_id, spec.model_id,
            loss_fn=copd_mlp.loss_fn,
            init_fn=lambda k, h=hidden: copd_mlp.init(k, hidden=h),
            opt=adamw(1e-2), device="cpu",
        )
        job.run(batch_size=10, epochs=8)
    ranked = reg.compare(dep.deployment_id, "loss")
    assert len(ranked) == 2 and ranked[0][1] <= ranked[1][1]
    job0 = TrainingJob(log, reg, dep.deployment_id, m1.model_id,
                       loss_fn=copd_mlp.loss_fn, init_fn=copd_mlp.init, opt=adamw(1e-2), device="cpu")
    job0.run(batch_size=10, epochs=8)
    params = job0._final_state["params"]
    assert all(p.requires_grad for p in params.values())
    log.create_topic("requests", LogConfig(num_partitions=2))

    @torch.no_grad()
    def logits(d):
        return copd_mlp.forward(params, d["data"])

    infer = InferenceDeployment(
        log, reg, reg.results_for(dep.deployment_id)[-1].result_id,
        predict_fn=logits, input_topic="requests", output_topic="preds", replicas=2,
    )
    reqs = ds["data"][:20]
    log.produce_batch("requests", [r.tobytes() for r in reqs[:10]], partition=0)
    log.produce_batch("requests", [r.tobytes() for r in reqs[10:]], partition=1)
    try:
        assert infer.drain() == 20
    finally:
        infer.close()
    assert log.end_offset("preds", 0) == 20
    assert infer.result.input_format == "AVRO"  # auto-configured from the control message


# ---------------------------------------------------------- parallel polling
class TestParallelPolling:
    """Mirrors of tests/test_concurrency.py:533, :546 and :566."""

    def _deployment(self, log, parallel):
        reg = core.Registry()
        return InferenceDeployment(
            log, reg, _fabricated_result(reg),
            predict_fn=lambda d: d["data"][:, :1],
            input_topic="requests", output_topic="preds",
            replicas=2, parallel_poll=parallel,
        )

    @staticmethod
    def _fill(log):
        reqs = np.arange(60, dtype=np.float32).reshape(20, 3)
        log.produce_batch("requests", [r.tobytes() for r in reqs[:10]], partition=0)
        log.produce_batch("requests", [r.tobytes() for r in reqs[10:]], partition=1)

    @pytest.mark.parametrize("parallel", [False, True])
    def test_poll_all_processes_every_request(self, parallel):
        log = StreamLog()
        log.create_topic("requests", LogConfig(num_partitions=2))
        infer = self._deployment(log, parallel)
        self._fill(log)
        try:
            assert infer.drain() == 20
            assert log.end_offset("preds", 0) == 20
        finally:
            infer.close()

    def test_parallel_poll_output_order_matches_serial(self):
        outs = {}
        for parallel in (False, True):
            log = StreamLog()
            log.create_topic("requests", LogConfig(num_partitions=2))
            infer = self._deployment(log, parallel)
            self._fill(log)
            try:
                infer.drain()
            finally:
                infer.close()
            outs[parallel] = [bytes(v) for v in log.read("preds", 0, 0, 100).values]
        assert outs[True] == outs[False]

    def test_parallel_poll_publishes_healthy_replicas_when_one_fails(self):
        log = StreamLog()
        log.create_topic("requests", LogConfig(num_partitions=2))
        reg = core.Registry()

        def predict(d):
            if np.any(d["data"] < 0):
                raise RuntimeError("poisoned batch")
            return d["data"][:, :1]

        infer = InferenceDeployment(
            log, reg, _fabricated_result(reg), predict_fn=predict,
            input_topic="requests", output_topic="preds", replicas=2, parallel_poll=True,
        )
        log.produce_batch("requests", [r.tobytes() for r in -np.ones((10, 3), np.float32)], partition=0)
        log.produce_batch("requests", [r.tobytes() for r in np.ones((10, 3), np.float32)], partition=1)
        try:
            with pytest.raises(RuntimeError, match="poisoned"):
                infer.poll_all()
            assert log.end_offset("preds", 0) == 10
        finally:
            infer.close()


def test_expired_inference_replica_rejoins_and_serves():
    """Mirror of tests/test_consumer.py:230: an alive replica whose
    heartbeats lapsed re-enters the group and keeps serving."""
    t = [0.0]
    log = StreamLog()
    log.create_topic("t", LogConfig(num_partitions=2))
    reg = core.Registry()
    result_id = _fabricated_result(reg, RawCodec("float32", (2,), "int32", ()))
    infer = InferenceDeployment(
        log, reg, result_id, predict_fn=lambda d: d["data"][:, :1],
        input_topic="t", output_topic="preds", replicas=2,
        session_timeout_s=5.0, parallel_poll=False, clock=lambda: t[0],
    )
    reqs = np.arange(8, dtype=np.float32).reshape(4, 2)
    log.produce_batch("t", [r.tobytes() for r in reqs[:2]], partition=0)
    log.produce_batch("t", [r.tobytes() for r in reqs[2:]], partition=1)
    assert infer.poll_all() == 4
    t[0] = 20.0
    assert sorted(infer.group.expire_dead_members()) == ["replica-0", "replica-1"]
    assert infer.group.members == []
    log.produce_batch("t", [r.tobytes() for r in reqs[:2]], partition=0)
    served = infer.poll_all()  # eviction observed: replicas rejoin
    served += infer.poll_all()  # and serve again
    assert served == 2
    assert sorted(infer.group.members) == ["replica-0", "replica-1"]


# ----------------------------------------------------------------- clusters
def test_zombie_replica_cannot_commit_stale_offsets_via_txn():
    """Mirror of tests/test_transactions.py:509: a replica evicted between
    poll and publish must not rewind the committed offsets through its
    transaction; its predictions stay invisible."""
    c = BrokerCluster(3, default_acks="all")
    c.create_topic("t", LogConfig(num_partitions=1, replication_factor=3))
    reg = core.Registry()
    spec = reg.register_model("m")
    dep = reg.deploy(reg.create_configuration([spec.model_id]).config_id, "train")
    res = reg.upload_result(
        dep.deployment_id, spec.model_id, {"loss": 0.0}, input_format="RAW",
        input_config={"data_type": "float32", "data_reshape": [2],
                      "label_type": "int32", "label_reshape": []},
    )
    c.create_topic("req", LogConfig(num_partitions=1, replication_factor=3))
    infer = InferenceDeployment(
        c, reg, res.result_id, predict_fn=lambda d: d["data"].sum(axis=1),
        input_topic="req", output_topic="pred", replicas=1, transactional=True,
    )
    reqs = np.arange(8, dtype=np.float32).reshape(4, 2)
    c.produce_batch("req", [np.concatenate([r, np.zeros(1, np.float32)]).tobytes() for r in reqs],
                    partition=0)
    r0 = infer.replicas[0]
    outs = r0.poll_compute()  # polled the batch, positions advanced
    infer.group.leave(r0.replica_id)  # the group moves on while r0 stalls
    tp = TopicPartition("req", 0)
    c.commit_offset(infer.group.group_id, tp, 4)  # the new owner's commit
    assert r0.publish(outs) == 0  # the zombie's publish aborts
    assert c.committed_offset(infer.group.group_id, tp) == 4  # no rewind
    assert _committed_values(c, "pred", 0) == []
    infer.close()


def test_follower_reads_keep_inference_serving_through_election():
    """Mirror of tests/test_cluster_chaos.py:365: the request topic's
    leader killed with its election deferred; in-sync follower reads keep
    every replica answering, and the new leader serves new requests."""
    c = BrokerCluster(3, default_acks="all")
    c.create_topic("requests", LogConfig(num_partitions=2, replication_factor=3))
    reg = core.Registry()
    infer = InferenceDeployment(
        c, reg, _fabricated_result(reg), predict_fn=lambda d: d["data"][:, :1],
        input_topic="requests", output_topic="preds", replicas=2,
    )
    try:
        reqs = np.arange(120, dtype=np.float32).reshape(40, 3)
        for p in range(2):
            c.produce_batch("requests", [r.tobytes() for r in reqs[p * 20:p * 20 + 20]],
                            partition=p, acks="all")
        assert infer.poll_all() == 40
        c.produce_batch("requests", [r.tobytes() for r in reqs[:10]], partition=0)
        victim = c.leader_for("requests", 0)
        c.kill_broker(victim, defer_election=True)
        assert c.leader_for("requests", 0) == victim  # election pending
        assert infer.poll_all() >= 10  # follower reads keep answering
        assert c.leader_for("requests", 0) == victim
        with core.ReplicationService(c, interval_s=0.002):
            deadline = time.monotonic() + 10
            while c.leader_for("requests", 0) == victim:
                assert time.monotonic() < deadline, "election never completed"
                time.sleep(0.005)
            c.produce_batch("requests", [r.tobytes() for r in reqs[10:20]], partition=0)
            assert infer.drain() >= 10
    finally:
        infer.close()


def test_transactional_predictions_exactly_once_across_a_leader_kill():
    """copd-mlp behind a transactional deployment on a BrokerCluster(3):
    16 requests on 2 partitions at replication factor 3, the predictions
    topic's leader killed between two drains; in the read_committed view
    each request's prediction appears exactly once, with the bytes of a
    serial forward."""
    _, tp = _moved_grad(6)
    c = BrokerCluster(3, default_acks="all")
    c.create_topic("requests", LogConfig(num_partitions=2, replication_factor=3))
    c.create_topic("preds", LogConfig(num_partitions=1, replication_factor=3))
    reg = core.Registry()
    infer = InferenceDeployment(
        c, reg, _fabricated_result(reg, _codec()),
        predict_fn=lambda d: copd_mlp.predict(tp, d["data"]),
        input_topic="requests", output_topic="preds", replicas=2, transactional=True,
    )
    reqs = copd_mlp.synth_dataset(rng_seed=5, n=16)["data"]
    with torch.no_grad():
        want = sorted(r.tobytes() for r in torch.softmax(copd_mlp.forward(tp, reqs), -1).numpy())
    for p in range(2):
        c.produce_batch("requests", [r.tobytes() for r in reqs[p * 4:p * 4 + 4]], partition=p)
    try:
        assert infer.drain() == 8
        c.start_replication(interval_s=0.002, workers=2)
        try:
            c.kill_broker(c.leader_for("preds", 0))
            for p in range(2):
                c.produce_batch("requests", [r.tobytes() for r in reqs[8 + p * 4:12 + p * 4]], partition=p)
            deadline = time.monotonic() + 60
            got = []
            while len(got) < 16:
                assert time.monotonic() < deadline, f"{len(got)} of 16 predictions committed"
                c.controller_tick()
                try:
                    infer.poll_all()
                except ClusterError:
                    continue  # election window: abort and rewind, retry the tick
                got = _committed_values(c, "preds", 0)
        finally:
            c.stop_replication()
    finally:
        infer.close()
    assert sorted(got) == want  # every prediction once: none lost, none twice


# ------------------------------------------------------------------ example
def test_quickstart_example_on_the_cpu():
    """examples/torch_quickstart.py --device cpu under its watchdog: the
    trained accuracy line, 16 predictions served, and lag 0."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "QUICKSTART_TIMEOUT_S": "100"}
    out = subprocess.run([sys.executable, str(REPO / "examples" / "torch_quickstart.py"), "--device", "cpu"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    served = [line for line in lines if line.startswith("served ")]
    assert len(served) == 1 and served[0].startswith("served 16 predictions via 2 replicas; accuracy ")
    assert float(served[0].rsplit(" ", 1)[1]) > 0.9, served
    assert any("inference consumer lag 0;" in line for line in lines), out.stdout
