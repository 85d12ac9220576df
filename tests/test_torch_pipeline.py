"""The port's data pipeline against the JAX package's, over the same
ingested stream: the producer side writes the same records, and the
batch iterators yield the same batches to the byte. ``device_feed`` on
the CPU; its card path is tested in tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.data as jdata
import repro_torch.core as core
import repro_torch.data as data
from repro.data.formats import AvroCodec as JAvroCodec, FieldSpec as JFieldSpec, RawCodec as JRawCodec
from repro_torch.data.formats import AvroCodec, FieldSpec, RawCodec

SEQ = 17


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These models are tiny: torch's thread pool only contends with the
    other test workers, so each test here runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _corpus(n=50, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, SEQ)).astype(np.int32)


def _ingest_both(corpus, partitions=3, rate=0.2):
    """The same dataset through each package's ingest into its own log."""
    logs = []
    for c, d, codec in ((jcore, jdata, JRawCodec("int32", (SEQ,), "int32", ())),
                        (core, data, RawCodec("int32", (SEQ,), "int32", ()))):
        log = c.StreamLog()
        log.create_topic("corpus", c.LogConfig(num_partitions=partitions))
        msg = d.ingest(log, "corpus", codec, {"data": corpus, "label": np.arange(len(corpus), dtype=np.int32)},
                       "dep-1", validation_rate=rate)
        logs.append((log, msg))
    return logs


def test_ingest_writes_the_same_records():
    """The same records in the same order (the sticky partitioner may pick
    another partition in each log) and the same announcement."""
    (jlog, jmsg), (tlog, tmsg) = _ingest_both(_corpus())

    def records(log, msg):
        return [bytes(v) for r in msg.ranges for b in log.iter_range(r.topic, r.partition, r.offset, r.length)
                for v in b.values]

    assert [(r.offset, r.length) for r in tmsg.ranges] == [(r.offset, r.length) for r in jmsg.ranges]
    assert (tmsg.total_msg, tmsg.validation_rate, tmsg.input_format, tmsg.input_config) == (
        jmsg.total_msg, jmsg.validation_rate, jmsg.input_format, jmsg.input_config)
    assert records(tlog, tmsg) == records(jlog, jmsg)


def test_avro_codec_encodes_as_the_reference():
    rng = np.random.default_rng(1)
    x = {"data": rng.standard_normal((7, 5)).astype(np.float32), "label": rng.integers(0, 3, 7).astype(np.int32)}
    j = JAvroCodec([JFieldSpec("data", "float32", (5,))], [JFieldSpec("label", "int32", ())])
    t = AvroCodec([FieldSpec("data", "float32", (5,))], [FieldSpec("label", "int32", ())])
    assert [bytes(b) for b in t.encode_batch(x)] == [bytes(b) for b in j.encode_batch(x)]


@pytest.mark.parametrize("split", ["train", "eval"])
@pytest.mark.parametrize("fetch", [4, 64])
def test_streaming_batches_identical_to_jax(split, fetch):
    """StreamingBatchIterator over each package's own ingest of the data,
    two epochs, and after a fast-forward."""
    (jlog, jmsg), (tlog, tmsg) = _ingest_both(_corpus())
    epochs = 2 if split == "train" else 1
    j = list(jdata.pipeline.StreamingBatchIterator(jlog, jmsg, 3, split=split, epochs=epochs, fetch_records=fetch))
    t = list(data.StreamingBatchIterator(tlog, tmsg, 3, split=split, epochs=epochs, fetch_records=fetch))
    assert len(t) == len(j) > 0
    for a, b in zip(t, j):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    it = data.StreamingBatchIterator(tlog, tmsg, 3, split=split, epochs=epochs, fetch_records=fetch)
    it.fast_forward(2)
    assert next(iter(it))["data"].tobytes() == j[2]["data"].tobytes()


@pytest.mark.parametrize("shuffle", [False, True])
def test_batch_iterator_identical_to_jax(shuffle):
    """BatchIterator over StreamDataset.split() of each package's log: the
    seeded shuffle is numpy in both."""
    (jlog, jmsg), (tlog, tmsg) = _ingest_both(_corpus())
    jtrain, jeval = jdata.StreamDataset(jlog, jmsg).split()
    ttrain, teval = data.StreamDataset(tlog, tmsg).split()
    for a, b in ((ttrain, jtrain), (teval, jeval)):
        assert all(a[k].tobytes() == b[k].tobytes() for k in b)
    j = jdata.BatchIterator(jtrain, 4, seed=3, epochs=2, shuffle=shuffle)
    t = data.BatchIterator(ttrain, 4, seed=3, epochs=2, shuffle=shuffle, prefetch=2)
    jb, tb = list(j), list(t)
    t.close()
    assert len(tb) == len(jb) == 2 * (40 // 4)
    for a, b in zip(tb, jb):
        assert all(a[k].tobytes() == b[k].tobytes() for k in b)


@pytest.mark.parametrize("depth", [0, 2])
def test_device_feed_on_cpu(depth):
    """The CPU path hands out tensors equal to the host batches, in order,
    serially at depth 0 and through the prefetch worker above it."""
    (_, _), (tlog, tmsg) = _ingest_both(_corpus())
    host = list(data.StreamingBatchIterator(tlog, tmsg, 5, split="train", epochs=1))
    it = data.StreamingBatchIterator(tlog, tmsg, 5, split="train", epochs=1)
    feed = data.device_feed(iter(it), device="cpu", depth=depth)
    got = list(feed)
    assert (depth > 0) == isinstance(feed, data.PrefetchIterator)
    assert len(got) == len(host)
    for g, h in zip(got, host):
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in g.values())
        assert all(np.array_equal(g[k].numpy(), h[k]) for k in h)


def test_device_feed_close_stops_an_infinite_stream():
    (_, _), (tlog, tmsg) = _ingest_both(_corpus())
    it = data.StreamingBatchIterator(tlog, tmsg, 5, split="train", epochs=None)
    feed = data.device_feed(iter(it), device="cpu", depth=2)
    next(feed)
    feed.close()
    assert not feed._thread.is_alive()


def test_device_feed_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is its path")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        data.device_feed(iter([]))
