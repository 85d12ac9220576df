"""Each per-layer metric's arithmetic, on traces and counts made up here."""

import dataclasses
import json
import math

import pytest

from bench import harness, work
from bench.trace import Trace

YI_CELL = harness.load_cell("yi6b.train_stream")
YI = YI_CELL.config
MAMBA2_CELL = dataclasses.replace(YI_CELL, config_name="mamba2-2.7b",
                                  config=json.loads((harness.BENCH / "configs" / "mamba2-2.7b.json").read_text()))
MAMBA2 = MAMBA2_CELL.config


def read(name, ctx):
    return harness.metric_reader(name).read(ctx)


def trace(ops, host=(), window=1.0):
    return Trace(sorted(ops, key=lambda t: t[1]), list(host), window)


def test_busy_idle_and_gaps():
    tr = trace([("a", 0.0, 0.2), ("b", 0.1, 0.3), ("c", 0.5, 0.6)],
               host=[("feed", 0.25, 0.55), ("aten::mm", 0.4, 0.45)], window=1.0)
    assert tr.busy_s() == pytest.approx(0.4)
    assert read("device_idle_pct.train", {"trace": tr, "traced_steps": 2}) == pytest.approx(60.0)
    assert read("device_idle_pct.serve", {"trace": tr, "ttft_s": [0.1]}) == pytest.approx(60.0)
    assert tr.idle_gaps() == [["aten::mm", pytest.approx(0.2)]]
    assert tr.top_ops(1) == [["a", pytest.approx(0.2)]]


def calls(cell):
    return harness.configuration(cell).kernel_calls(cell.config, 4, 1024)


def test_k1_roofline():
    ctx = {"kernel_calls": calls(YI_CELL), "traced_steps": 3,
           "trace": trace([("void flash_attention_bf16_kernel<128>(Params)", 0.0, 0.5),
                           ("dq_bf16_kernel", 0.5, 1.0), ("nvjet_gemm", 1.0, 2.0)])}
    shape = (4, 32, 4, 1024, 128, "bfloat16")
    per_call = work.bound_s(work.attention_work(*shape), "bfloat16") + work.bound_s(
        work.attention_bwd_work(*shape), "bfloat16")
    assert read("k1_roofline_pct.train", ctx) == pytest.approx(100 * 32 * per_call * 3 / 1.0)
    assert read("k1_roofline_pct.train", {**ctx, "kernel_calls": calls(MAMBA2_CELL)}) is None
    assert read("k1_roofline_pct.train", {**ctx, "trace": trace([("nvjet", 0, 1)])}) is None


def test_k2_roofline():
    ctx = {"kernel_calls": calls(MAMBA2_CELL), "traced_steps": 2,
           "trace": trace([("ssd_chunk_out_kernel", 0.0, 0.25), ("ssd_bwd_grads_bf16_kernel", 0.25, 1.0)])}
    shape = (4, 80, 1, 1024, 64, 128, 256, "bfloat16")
    per_call = work.bound_s(work.ssd_work(*shape), "bfloat16") + work.bound_s(work.ssd_bwd_work(*shape), "bfloat16")
    assert read("k2_roofline_pct.train", ctx) == pytest.approx(100 * 64 * per_call * 2 / 1.0)
    assert read("k2_roofline_pct.train", {**ctx, "kernel_calls": calls(YI_CELL)}) is None


def test_opt8_roofline_and_mfu():
    leaves = [((32, 4096, 11008), 2), ((1, 4096), 2)]
    ctx = {"opt8_leaves": leaves, "traced_steps": 4,
           "trace": trace([("adamw8bit_kernel<bf16>", 0, 0.3), ("sumsq_kernel", 0.3, 0.35),
                           ("finish_kernel", 0.35, 0.4), ("ssd_bwd_finish_bf16_kernel", 0.4, 0.9)])}
    n = 32 * 4096 * 11008 + 4096
    nbytes = work.opt8_bytes(32 * 4096 * 11008, 11008, 2) + work.opt8_bytes(4096, 4096, 2) + 2 * n
    assert read("opt8_roofline_pct.train", ctx) == pytest.approx(100 * nbytes / 3.35e12 * 4 / 0.4)
    flops = harness.configuration(YI_CELL).step_flops(YI, 4, 1024, 64000)
    assert 1.40e14 < flops < 1.55e14
    ctx = {"step_flops": flops, "steps": 25, "window_s": 10.0, "chips": 1}
    assert read("train_mfu", ctx) == pytest.approx(100 * flops * 25 / 10 / 989e12)
    assert 6.5e13 < harness.configuration(MAMBA2_CELL).step_flops(MAMBA2, 4, 1024, 50304) < 7.6e13


def test_serving_and_span_metrics():
    ttft = [i / 100 for i in range(1, 101)]
    assert read("ttft_p95_ms.serve", {"ttft_s": ttft}) == pytest.approx(950.0)
    assert read("ttft_p95_ms.serve", {"ttft_s": ttft[:-1] + [math.inf]}) == pytest.approx(950.0)
    assert read("ttft_p95_ms.serve", {"ttft_s": ttft[:-10] + [math.inf] * 10}) is None
    assert read("lane_util_pct.serve", {"lane_steps": 64, "useful_steps": 48}) == pytest.approx(75.0)
    assert read("lane_util_pct.serve", {}) is None
    assert read("train_step_ms.train", {"train_step_s": 0.4}) == pytest.approx(400.0)
    assert read("train_step_ms.train", {}) is None


def test_percentile():
    assert harness.percentile([3.0, 1.0, 2.0, 4.0], 50) == 2.0
    assert harness.percentile(list(range(1, 21)), 95) == 19
