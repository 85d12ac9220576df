"""The port's LM serving group against the JAX package's, on moved weights.

Reduced yi-6b in f32 on the CPU, the JAX parameters moved into the port
by ``convert.params_from_jax``. The group is host code over the port's
copies of the consumer group and the replicated cluster, so what it
serves must be token-identical to the engines it wraps and to the JAX
group on the same requests. The chaos mirrors of
tests/test_serving_chaos.py are slow there and here.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.configs as JC
import repro.core as jcore
from repro.models.model import StreamModel as JModel
from repro.models.policy import Policy as JPolicy
from repro.serve import lm_engine as J
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.core.cluster import BrokerCluster, ClusterError
from repro_torch.core.log import LogConfig, StreamLog
from repro_torch.models.model import StreamModel
from repro_torch.models.policy import Policy
from repro_torch.serve import lm_engine as T

REPO = Path(__file__).resolve().parents[1]
N_REQ = 12


@pytest.fixture(scope="module")
def lm():
    cfg = JC.get_reduced("yi-6b")
    jm = JModel(cfg, JPolicy(param_dtype="float32", compute_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = StreamModel(
        TC.get_reduced("yi-6b"), Policy("float32", "float32", "float32"), device="cpu", generator=None
    )
    tm.load_params(convert.params_from_jax(jax.tree.map(np.asarray, jp)))
    return cfg, jm, jp, tm


def _engine(tm, kind="continuous"):
    if kind == "wave":
        return T.LMEngine(tm, n_slots=4, s_cache=32, device="cpu")
    return T.ContinuousLMEngine(tm, n_slots=4, n_blocks=32, block_size=8, max_blocks=8, device="cpu")


def _requests(cfg, rng, n=N_REQ):
    """Mixed-length keyed requests over four tenants, as the JAX chaos
    tests draw them (three prompt lengths: the JAX engines compile one
    prefill per length)."""
    reqs = []
    for rid in range(n):
        plen = int(rng.choice([6, 10, 14]))
        reqs.append(T.Request(
            rid, rng.integers(0, cfg.vocab, plen).astype(np.int32),
            int(rng.integers(2, 7)), tenant=rid % 4,
        ))
    return reqs


def _reference(tm, reqs, kind="continuous"):
    eng = _engine(tm, kind)
    for r in reqs:
        eng.submit(r)
    return dict(eng.run_until_drained())


def _collect(log, topic="lm-resp", parts=2):
    """Read-committed audit of the response topic: (req_id -> (tenant,
    tokens), per-req occurrence counts)."""
    got, counts = {}, {}
    for p in range(parts):
        off = 0
        try:
            end = log.end_offset(topic, p)
        except (ClusterError, KeyError, IndexError):
            continue  # partition offline mid-election, or fewer partitions
        while off < end:
            try:
                batch = log.read(topic, p, off, 256, isolation="read_committed")
            except ClusterError:
                break
            for buf in batch.values:
                rid, tenant, gen = T.decode_completion(buf)
                got[rid] = (tenant, gen)
                counts[rid] = counts.get(rid, 0) + 1
            off = batch.next_offset
    return got, counts


@pytest.mark.parametrize("kind", ["continuous", "wave"])
def test_serving_group_roundtrip_bare_log(lm, kind):
    """Keyed requests through a 1-worker serving group on a bare
    StreamLog (non-transactional): all completions land keyed on the
    response topic and match the engine run directly."""
    cfg, _, _, tm = lm
    rng = np.random.default_rng(8)
    log = StreamLog()
    log.create_topic("lmreq")
    reqs = [
        T.Request(i, rng.integers(0, cfg.vocab, 8 + 4 * (i % 2)).astype(np.int32),
                  3 + i % 3, tenant=i % 2)
        for i in range(5)
    ]
    for r in reqs:
        log.produce("lmreq", T.encode_request(r), key=T.tenant_key(r.tenant))
    group = T.LMServingGroup(log, [_engine(tm, kind)], input_topic="lmreq", response_topic="lmresp")
    assert group.drain() == 5
    ref = _reference(tm, reqs, kind)

    got, counts = _collect(log, topic="lmresp", parts=1)
    assert sorted(got) == sorted(ref) == list(range(5))
    assert all(n == 1 for n in counts.values())
    for rid in ref:
        tenant, gen = got[rid]
        assert tenant == rid % 2
        np.testing.assert_array_equal(gen, ref[rid])


@pytest.mark.parametrize("kind", ["continuous", "wave"])
def test_serving_group_matches_jax_group(lm, kind):
    """The same request records through the JAX group and the port's, each
    on a bare StreamLog with 2 partitions and 2 workers: every req_id's
    completion is token-identical and carries the same tenant (the codecs
    are byte-identical, tests/test_torch_lm_engine.py)."""
    cfg, jm, jp, tm = lm
    reqs = _requests(cfg, np.random.default_rng(21), n=8)
    if kind == "wave":
        jengines = [J.LMEngine(jm, jp, n_slots=4, s_cache=32) for _ in range(2)]
    else:
        jengines = [J.ContinuousLMEngine(jm, jp, n_slots=4, n_blocks=32, block_size=8, max_blocks=8)
                    for _ in range(2)]
    jlog, tlog = jcore.StreamLog(), StreamLog()
    for log, log_config in ((jlog, jcore.LogConfig), (tlog, LogConfig)):
        log.create_topic("lm-req", log_config(num_partitions=2))
        for r in reqs:
            log.produce("lm-req", T.encode_request(r), key=T.tenant_key(r.tenant))
    jgroup = J.LMServingGroup(jlog, jengines, input_topic="lm-req", response_topic="lm-resp")
    tgroup = T.LMServingGroup(tlog, [_engine(tm, kind) for _ in range(2)],
                              input_topic="lm-req", response_topic="lm-resp")
    assert jgroup.drain() == tgroup.drain() == 8
    assert [w.served for w in tgroup.workers] == [w.served for w in jgroup.workers]
    assert all(w.served for w in tgroup.workers)  # both partitions, both workers

    want, _ = _collect(jlog)
    got, counts = _collect(tlog)
    assert sorted(got) == sorted(want) == list(range(8))
    assert all(n == 1 for n in counts.values())
    for rid, (tenant, gen) in want.items():
        assert got[rid][0] == tenant == rid % 4
        np.testing.assert_array_equal(got[rid][1], gen)


@pytest.mark.slow
def test_serving_survives_partition_leader_kill_exactly_once(lm):
    cfg, _, _, tm = lm
    rng = np.random.default_rng(11)
    c = BrokerCluster(3, default_acks="all")
    c.create_topic("lm-req", LogConfig(num_partitions=2, replication_factor=3))
    c.create_topic("lm-resp", LogConfig(num_partitions=2, replication_factor=3))
    reqs = _requests(cfg, rng)
    want = _reference(tm, reqs)

    group = T.LMServingGroup(
        c, [_engine(tm) for _ in range(2)],
        input_topic="lm-req", response_topic="lm-resp", transactional=True,
    )
    # phase 1: half the requests served cleanly
    for r in reqs[: N_REQ // 2]:
        c.produce("lm-req", T.encode_request(r), key=T.tenant_key(r.tenant))
    group.poll_all()

    # kill the response partition leader, then stream the rest: the next
    # transactional publish hits the dead leader mid-serve
    c.start_replication(interval_s=0.002, workers=2)
    try:
        c.kill_broker(c.leader_for("lm-resp", 0))
        for r in reqs[N_REQ // 2 :]:
            c.produce("lm-req", T.encode_request(r), key=T.tenant_key(r.tenant))
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            c.controller_tick()
            try:
                group.poll_all()
            except ClusterError:
                continue  # election window: abort+rewind, retry the tick
            got, _counts = _collect(c)
            if len(got) == N_REQ:
                break
        got, counts = _collect(c)
    finally:
        c.stop_replication()

    assert sorted(got) == list(range(N_REQ)), f"missing: {set(range(N_REQ)) - set(got)}"
    # exactly-once: no req_id published twice (read_committed view)
    dups = {rid: n for rid, n in counts.items() if n != 1}
    assert dups == {}, f"duplicated completions: {dups}"
    # token-identical to the undisturbed engine (greedy determinism)
    for rid in want:
        assert got[rid][0] == rid % 4
        np.testing.assert_array_equal(got[rid][1], want[rid])


@pytest.mark.slow
def test_serving_survives_worker_death_via_rebalance(lm):
    cfg, _, _, tm = lm
    rng = np.random.default_rng(12)
    t = [0.0]
    log = StreamLog()
    log.create_topic("lm-req", LogConfig(num_partitions=2))
    reqs = _requests(cfg, rng)
    want = _reference(tm, reqs)

    group = T.LMServingGroup(
        log, [_engine(tm) for _ in range(2)],
        input_topic="lm-req", response_topic="lm-resp",
        session_timeout_s=5.0, clock=lambda: t[0],
    )
    for r in reqs[: N_REQ // 2]:
        log.produce("lm-req", T.encode_request(r), key=T.tenant_key(r.tenant))
    group.poll_all()

    group.kill_worker(0)
    t[0] += 10.0  # heartbeats lapse; the survivor absorbs both partitions
    for r in reqs[N_REQ // 2 :]:
        log.produce("lm-req", T.encode_request(r), key=T.tenant_key(r.tenant))
    for _ in range(10):
        group.poll_all()
        got, _ = _collect(log)
        if len(got) == N_REQ:
            break

    got, counts = _collect(log)
    assert sorted(got) == list(range(N_REQ))
    assert all(n == 1 for n in counts.values())
    for rid in want:
        np.testing.assert_array_equal(got[rid][1], want[rid])
    assert group.workers[1].served >= N_REQ // 2


def test_example_serves_on_the_cpu():
    """examples/torch_serve_continuous.py end to end on the CPU, under its
    own watchdog."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "SERVE_TIMEOUT_S": "120"}
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_serve_continuous.py"), "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=180,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "served 10 completions via 2 workers on cpu" in out.stdout, out.stdout
