"""Every cell's files are found by name, and a cell added by files and
entries alone loads."""

import json
import shutil

import pytest

from bench import harness
from bench.tests.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_files(name):
    cell = harness.load_cell(name)
    assert (ROOT / "bench" / "drivers" / f"{cell.traffic['driver']}.py").exists()
    assert hasattr(harness.reference(cell), "decoder")
    assert cell.limits, f"bench/limits/{name}.json"
    for m in cell.per_layer:
        assert hasattr(harness.metric_reader(m["name"]), "read")
        moves = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        assert "workloads" not in moves or name in moves["workloads"], (m["name"], name)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


def test_cell_from_files_alone(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    traffic = json.loads((ROOT / "bench" / "traffic" / "train_stream.json").read_text())
    (tmp_path / "bench" / "traffic" / "train_long.json").write_text(json.dumps({**traffic, "seq": 2048, "batch": 2}))
    (tmp_path / "bench" / "limits" / "yi6b.train_long.json").write_text(
        (ROOT / "bench" / "limits" / "yi6b.train_stream.json").read_text())
    spec["workloads"].append({"name": "yi6b.train_long", "config": "yi-6b", "traffic": "train_long", "chips": 1,
                              "why": "longer rows"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "yi6b.train_stream" in m.get("workloads", []):
            m["workloads"].append("yi6b.train_long")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("yi6b.train_long", tmp_path / "BENCHMARK.json")
    assert cell.traffic["seq"] == 2048 and cell.traffic["driver"] == "train_stream"
    assert cell.config["name"] == "yi-6b" and cell.limits
    assert {m["name"] for m in cell.end_to_end} == {"train_tokens_per_s", "peak_device_gb", "setup_s"}
    assert "k1_roofline_pct.train" in {m["name"] for m in cell.per_layer}
    assert "k2_roofline_pct.train" not in {m["name"] for m in cell.per_layer}


# A configuration of a third family (qwen2: a Llama decoder with biases on
# the query, key and value projections), cut to a tiny size, added with
# its files and entries alone.
TOY_CONFIG = {"name": "toy-qwen2", "family": "qwen2", "source": "https://huggingface.co/Qwen/Qwen2-7B",
              "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4, "num_key_value_heads": 2,
              "num_hidden_layers": 2, "vocab_size": 256, "rope_theta": 1000000.0, "rms_norm_eps": 1e-6}
TOY_MODULE = '''
from bench.work import attention_work


def arch_config(cfg):
    from repro_torch.models.model import ArchConfig

    return ArchConfig(name=cfg["name"], d_model=cfg["hidden_size"], n_layers=cfg["num_hidden_layers"],
                      n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
                      d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"], rope_theta=cfg["rope_theta"],
                      norm_eps=cfg["rms_norm_eps"], attn_bias=True)


def kernel_calls(cfg, batch, seq):
    h = cfg["num_attention_heads"]
    return {"attention": [(cfg["num_hidden_layers"], {"b": batch, "h": h, "kv": cfg["num_key_value_heads"],
                                                      "s": seq, "d": cfg["hidden_size"] // h, "dtype": "bfloat16"})]}


def step_flops(cfg, batch, seq, vocab_rows):
    return 3 * sum(n * attention_work(**kw).flops for n, kw in kernel_calls(cfg, batch, seq)["attention"])
'''
TOY_REFERENCE = '''
import importlib.util
from pathlib import Path

import torch.nn.functional as F

_spec = importlib.util.spec_from_file_location("bench_reference_common", Path(__file__).with_name("common.py"))
C = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(C)


def decoder(cfg, leaves, prec="f32"):
    d, h, kv = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, eps, theta = d // h, cfg["rms_norm_eps"], cfg["rope_theta"]

    def layer(p, x, prec):
        b, s, _ = x.shape
        a = C.rms_norm(x, p["norm1/w"], eps)
        q = C.mm(a, p["mixer/wq"].reshape(d, h * hd), prec).reshape(b, s, h, hd) + p["mixer/bq"]
        k = C.mm(a, p["mixer/wk"].reshape(d, kv * hd), prec).reshape(b, s, kv, hd) + p["mixer/bk"]
        v = C.mm(a, p["mixer/wv"].reshape(d, kv * hd), prec).reshape(b, s, kv, hd) + p["mixer/bv"]
        o = C.causal_attention(C.rope(q, theta), C.rope(k, theta), v, prec).reshape(b, s, h * hd)
        x = x + C.mm(o, p["mixer/wo"].reshape(h * hd, d), prec)
        a = C.rms_norm(x, p["norm2/w"], eps)
        return x + C.mm(F.silu(C.mm(a, p["mlp/w_gate"], prec)) * C.mm(a, p["mlp/w_in"], prec), p["mlp/w_out"], prec)

    C.no_tf32()
    return C.Decoder(leaves, layer, eps, False, prec)
'''
REHEARSAL = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
from bench import harness
from bench.trace import Trace
cell = harness.load_cell("toyqwen2.train_tiny")
out = harness.driver(cell).run(cell, 2**31 + 3, 1.0, False, time.perf_counter(), device="cpu")
calls = harness.configuration(cell).kernel_calls(cell.config, 2, 32)
k1 = harness.metric_reader("k1_roofline_pct.train").read(
    {{"kernel_calls": calls, "traced_steps": 1, "trace": Trace([("dq_bf16_kernel", 0.0, 1e-3)], [], 1.0)}})
print(json.dumps({{"bench": str(harness.BENCH), "correct": out["correct"], "k1": k1,
                  "checks": {{c.name: c.value for c in out["checks"]}}, "held": harness.forbidden_modules()}}))
"""


def test_third_family_from_files_alone(tmp_path):
    """A copy of the benchmark, with only new files and entries for a
    configuration of another family (its file, its module, its plain
    reference), a traffic mix and a cell, runs that cell on the CPU to
    ``correct``, no shared file edited."""
    import subprocess
    import sys

    from bench.tests.tiny import TINY_LIMITS, TINY_TRAFFIC

    shutil.copytree(ROOT / "bench", tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "bench").rglob("*") if p.is_file()}
    b = tmp_path / "bench"
    (b / "configs" / "toy-qwen2.json").write_text(json.dumps(TOY_CONFIG))
    (b / "configs" / "toy-qwen2.py").write_text(TOY_MODULE)
    (b / "reference" / "toy-qwen2.py").write_text(TOY_REFERENCE)
    traffic = json.loads((ROOT / "bench" / "traffic" / "train_stream.json").read_text())
    (b / "traffic" / "train_tiny.json").write_text(json.dumps({**traffic, **TINY_TRAFFIC["train_stream"]}))
    (b / "limits" / "toyqwen2.train_tiny.json").write_text(json.dumps(TINY_LIMITS["train_stream"]))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "toy-qwen2", "source": TOY_CONFIG["source"], "file": "bench/configs/toy-qwen2.json",
                            "reduced": ["num_hidden_layers"], "why": "a third family"})
    spec["workloads"].append({"name": "toyqwen2.train_tiny", "config": "toy-qwen2", "traffic": "train_tiny",
                              "chips": 1, "why": "a tiny training cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "yi6b.train_stream" in m.get("workloads", []):
            m["workloads"].append("toyqwen2.train_tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "bench").rglob("*")
             if p.is_file() and p.relative_to(tmp_path) in before}
    assert after == before

    code = REHEARSAL.format(root=str(tmp_path), src=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bench"] == str(b) and out["held"] == []
    assert out["correct"] is True, out["checks"]
    assert out["k1"] > 0
