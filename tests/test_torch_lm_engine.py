"""The port's serving engines against the JAX package's, on moved weights.

Reduced yi-6b in f32 on the CPU (``Policy`` as in tests/test_lm_engine.py).
Both engines build f32 caches, so greedy tokens must be identical.
"""

import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.core as jcore
from repro.models.model import StreamModel as JModel
from repro.models.policy import Policy as JPolicy
from repro.serve import lm_engine as J
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.core.log import StreamLog
from repro_torch.models.model import StreamModel
from repro_torch.models.policy import Policy
from repro_torch.serve import lm_engine as T

PLEN, GEN = 12, 6


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


def _mixed_requests(cfg, rng, n=9):
    """Mixed prompt lengths and budgets, grouped by length so the wave
    engines (equal-length waves) can serve the same set."""
    reqs, rid = [], 0
    for plen in (8, PLEN, 16):
        for _ in range(n // 3):
            reqs.append((rid, rng.integers(0, cfg.vocab, plen).astype(np.int32), int(rng.integers(3, 9))))
            rid += 1
    return reqs


def _run(engine, make_request, reqs):
    for rid, prompt, max_new in reqs:
        engine.submit(make_request(rid, prompt, max_new))
    return dict(engine.run_until_drained())


def _continuous(tm, n_slots=4):
    return T.ContinuousLMEngine(tm, n_slots=n_slots, n_blocks=32, block_size=8, max_blocks=8, device="cpu")


@pytest.mark.parametrize("kind", ["continuous", "wave"])
def test_greedy_tokens_identical_to_jax(lm, kind):
    cfg, jm, jp, tm = lm
    reqs = _mixed_requests(cfg, np.random.default_rng(7))
    if kind == "continuous":
        jeng = J.ContinuousLMEngine(jm, jp, n_slots=4, n_blocks=32, block_size=8, max_blocks=8)
        teng = _continuous(tm)
    else:
        jeng = J.LMEngine(jm, jp, n_slots=4, s_cache=64)
        teng = T.LMEngine(tm, n_slots=4, s_cache=64, device="cpu")
    want = _run(jeng, J.Request, reqs)
    got = _run(teng, T.Request, reqs)
    assert sorted(got) == sorted(want) == list(range(9))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    if kind == "continuous":
        assert teng.lane_utilization == jeng.lane_utilization


def test_codecs_byte_identical():
    rng = np.random.default_rng(0)
    for rid, tenant, max_new, plen in ((12, 3, 5, 7), (0, 0, 1, 1), (2**20, 9, 16, 300)):
        prompt = rng.integers(0, 64000, plen).astype(np.int32)
        jb = J.encode_request(J.Request(rid, prompt, max_new, tenant=tenant))
        tb = T.encode_request(T.Request(rid, prompt, max_new, tenant=tenant))
        assert jb == tb
        back = T.decode_request(jb)
        assert (back.req_id, back.tenant, back.max_new) == (rid, tenant, max_new)
        np.testing.assert_array_equal(back.prompt, prompt)
        gen = rng.integers(0, 64000, max_new).astype(np.int32)
        assert J.encode_completion(rid, tenant, gen) == T.encode_completion(rid, tenant, gen)
        r2, t2, g2 = J.decode_completion(T.encode_completion(rid, tenant, gen))
        assert (r2, t2) == (rid, tenant) and (g2 == gen).all()
        assert J.tenant_key(tenant) == T.tenant_key(tenant)


def test_slot_recycling_isolation(lm):
    """Admission mid-decode must not perturb in-flight rows."""
    cfg, _, _, tm = lm
    rng = np.random.default_rng(5)
    target = T.Request(99, rng.integers(0, cfg.vocab, PLEN).astype(np.int32), GEN)
    solo = _continuous(tm, n_slots=2)
    solo.submit(target)
    want = dict(solo.run_until_drained())[99]

    churn = _continuous(tm, n_slots=2)
    churn.submit(target)
    out = churn.step()
    for i in range(4):
        churn.submit(T.Request(i, rng.integers(0, cfg.vocab, 8).astype(np.int32), 2))
    while churn.qsize() or churn.active:
        out.extend(churn.step())
    got = dict(out)
    assert sorted(got) == [0, 1, 2, 3, 99]
    np.testing.assert_array_equal(got[99], want)
    assert churn.blocks.free_blocks == 31  # every block back, scratch block 0 never handed out


def test_serve_stream_fixed_prompts_byte_identical_to_jax(lm):
    """The JAX record format: int32[prompt_len] in, req_id || int32[max_new] out."""
    cfg, jm, jp, tm = lm
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (6, PLEN)).astype(np.int32)
    jlog, tlog = jcore.StreamLog(), StreamLog()
    for log in (jlog, tlog):
        log.create_topic("prompts")
        log.produce_batch("prompts", [p.tobytes() for p in prompts])
    jn = J.serve_stream(J.LMEngine(jm, jp, n_slots=4, s_cache=PLEN + GEN + 2), jlog, "prompts", "out", PLEN, max_new=GEN)
    tn = T.serve_stream(_continuous(tm), tlog, "prompts", "out", PLEN, max_new=GEN)
    assert jn == tn == 6
    jrec = {bytes(b) for b in jlog.read("out", 0, 0, 10).values}
    trec = {bytes(b) for b in tlog.read("out", 0, 0, 10).values}
    assert jrec == trec


def test_serve_stream_encoded_requests(lm):
    """Variable-length request records in, keyed completion records out."""
    cfg, _, _, tm = lm
    rng = np.random.default_rng(8)
    reqs = [
        T.Request(i, rng.integers(0, cfg.vocab, 8 + 4 * (i % 3)).astype(np.int32), 3 + i % 3, tenant=i % 2)
        for i in range(5)
    ]
    log = StreamLog()
    log.create_topic("lmreq")
    for r in reqs:
        log.produce("lmreq", T.encode_request(r), key=T.tenant_key(r.tenant))
    assert T.serve_stream(_continuous(tm), log, "lmreq", "lmresp") == 5
    want = _run(_continuous(tm), T.Request, [(r.req_id, r.prompt, r.max_new) for r in reqs])
    batch = log.read("lmresp", 0, 0, 64)
    got = {}
    for buf in batch.values:
        rid, tenant, gen = T.decode_completion(buf)
        assert tenant == rid % 2
        got[rid] = gen
    assert sorted(got) == list(range(5))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_param_round_trip(lm):
    _, _, jp, tm = lm
    tree = jax.tree.map(np.asarray, jp)
    back = convert.params_to_numpy(tm.param_tree())
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_t[path], leaf)
    jb = jax.tree.map(lambda a: np.asarray(a.astype("bfloat16")), jp)
    bf = convert.params_from_jax(jb)
    assert bf["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(convert.params_to_numpy(bf)["embed"], np.asarray(jb["embed"], np.float32))


def test_block_table_and_oversized_request(lm):
    bt = T.KVBlockTable(5)
    a, b = bt.reserve(2), bt.reserve(2)
    assert a == [1, 2] and b == [3, 4] and bt.reserve(1) is None
    bt.release(a)
    assert bt.free_blocks == 2 and 0 not in bt.reserve(2)
    with pytest.raises(ValueError):
        T.KVBlockTable(1)
    with pytest.raises(ValueError):
        _continuous(lm[3]).submit(T.Request(0, np.zeros(60, np.int32), 16))


def test_engine_device_must_match_model(lm):
    with pytest.raises(ValueError):
        T.ContinuousLMEngine(lm[3], device="meta")
