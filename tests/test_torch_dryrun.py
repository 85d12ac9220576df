"""The dry run (``repro_torch.launch.dryrun``) against the reference's, on
the CPU.

The dry run initialises torch.distributed's default process group on the
fake backend, which is process-wide, so every fake-group computation runs
in one subprocess of this file run as a script (``python
tests/test_torch_dryrun.py dry <dir>``), and the real collectives in 4
``gloo`` ranks (``... rank <r> <dir>``) that meet through a ``FileStore``
in the test's temporary directory, as ``tests/test_torch_mesh.py``
launches them; every subprocess is joined by DEADLINE_S and killed past
it, failing the test. Numbers travel as JSON. The reference's module is
imported after JAX has started with its devices, and its import-time
``XLA_FLAGS`` is taken back out of the environment at once.

What is held, and how closely:

* (a) the six tables, ``SHAPES``, ``LONG_CONTEXT_OK``, ``cell_supported``
  and ``effective_config`` equal to the reference's;
* (b) ``policy_for`` equal to the reference's, field for field (its
  ``unroll`` aside), on every arch, shape and both meshes (a stand-in
  mesh object: both read only the axis names and sizes);
* (c) ``input_specs``' shapes and dtypes equal to the reference's
  ``ShapeDtypeStruct``s on every arch and shape, and ``make_batch``'s
  values equal to the reference's, to the bit, for one seed;
* (d) rank 0's argument bytes equal, to the byte, to the per-device bytes
  of the reference's ``jax.eval_shape`` trees cut by its specs
  (``state_pspecs``, ``_serving_params``, ``cache_pspecs``, the batch's
  ``batch_spec``): every arch's ``decode_32k`` and ``prefill_32k`` on the
  single mesh and ``train_4k`` for yi-6b, mistral-large-123b (8-bit
  moments) and qwen3-moe-30b-a3b. One difference is the port's and is
  held exactly: mamba2's decode conv state keeps its B/C channels
  whole on every rank (the reference splits the whole conv dim), so
  rank 0 holds MAMBA2_CONV_EXTRA more bytes (PERF.md);
* (e) the collective inventory (kinds, calls, result bytes) of a reduced
  yi-6b on a (2, 2) mesh, train step (ZeRO-3, "full" recomputation, two
  microbatches, 8-bit moments) and decode step (the sequence-split
  cache), on the fake group equal to what the same counting mode counts
  on rank 0 of 4 real gloo ranks running those steps;
* (f) reduced dense configs on a (1, 1) mesh: the products outside the
  kernels equal 2 T (matrix parameters) for a prefill (the logits of the
  last position only), and for a train step three times the forward,
  plus the loss chunk's unembed again (its checkpoint) and, under
  "full", the layers' forward again but for each group's closing MLP
  product, where torch's checkpoint stops its rerun: exactly;
* (g) K1's counted pairs equal to a brute-force count of the mask;
* (h) ``measure_cell``'s extrapolation equal to the full-depth count,
  exactly, on a train and a decode cell;
* (i) each kernel wrapper's meta branch: outputs of the plain version's
  shapes and dtypes and the card path's strides, its work recorded, no
  launch counted;
* (j) the CLI: one OK record with the reference's keys and the
  reference's SKIP record for ``long_500k`` on yi-6b;
* the kernels' work formulas (``kernels/cost.py``) giving, to the bit,
  the bounds ``chip_smoke.py`` gave before they moved, at the shapes of
  PERF.md's kernel table.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import math
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
DEADLINE_S = 240.0  # every subprocess joined by then
INIT_TIMEOUT_S = 120  # gloo's rendezvous and collectives

# (d): the cells whose argument bytes are held to the reference's
ARG_CELLS = [(a, s) for a in (
    "mamba2-2.7b", "qwen3-moe-30b-a3b", "arctic-480b", "qwen2-7b", "gemma2-2b", "yi-6b", "mistral-large-123b",
    "pixtral-12b", "recurrentgemma-9b", "whisper-tiny") for s in ("prefill_32k", "decode_32k")] + [
    ("yi-6b", "train_4k"), ("mistral-large-123b", "train_4k"), ("qwen3-moe-30b-a3b", "train_4k")]
# mamba2 decode_32k on (16, 16): 64 layers x 8 rows x 3 conv slots x the B/C
# channels (2 G N = 256) less the reference's share of them (256 / 16), f32
MAMBA2_CONV_EXTRA = 64 * 8 * 3 * (256 - 256 // 16) * 4
# (e): reduced yi-6b on (data 2, model 2)
INV_TRAIN = {"seq_len": 32, "global_batch": 8, "microbatches": 2}
INV_DECODE = {"seq_len": 32, "global_batch": 4}
# (f): reduced dense configs, batch and sequence
FLOP_ARCHS = ("yi-6b", "qwen2-7b", "gemma2-2b")
FLOP_B, FLOP_S = 2, 16
# (h): cells measured by depth extrapolation against their full depth
MEASURE_CELLS = [("whisper-tiny", "train_4k"), ("gemma2-2b", "decode_32k")]
RECORD_KEYS = {"cell", "status", "compile_s", "mesh", "devices", "flops_per_device", "bytes_accessed_per_device",
               "transcendentals", "memory_analysis", "collective_bytes_per_device", "hlo_collective_counts"}


# ------------------------------------------------------------ subprocesses
def _env() -> dict:
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    return env


def _run_all(jobs: list[list[str]]) -> list[str]:
    """Start every command at once, join each by DEADLINE_S from the start,
    kill them all past it and fail; fail on a non-zero exit. Returns their
    outputs."""
    procs = [subprocess.Popen(cmd, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=REPO) for cmd in jobs]
    end = time.monotonic() + DEADLINE_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(end - time.monotonic(), 0.1))[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"{jobs} did not end within {DEADLINE_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for cmd, p, out in zip(jobs, procs, outs):
        assert p.returncode == 0, f"{cmd}: exit {p.returncode}\n{out[-6000:]}"
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One run of the fake-group worker, the 4 gloo ranks and the CLI."""
    d = tmp_path_factory.mktemp("dryrun")
    me = [sys.executable, __file__]
    cli = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    jobs = [me + ["dry", str(d)]] + [me + ["rank", str(r), str(d)] for r in range(WORLD)] + [
        cli + ["--arch", "whisper-tiny", "--shape", "decode_32k", "--out", str(d / "cli")],
        cli + ["--arch", "yi-6b", "--shape", "long_500k", "--out", str(d / "cli")],
    ]
    outs = _run_all(jobs)
    return {"dir": d, "dry": json.loads((d / "dry.json").read_text()),
            "rank0": json.loads((d / "rank0.json").read_text()), "cli": outs[-2:]}


@pytest.fixture(scope="module")
def JD():
    """The reference's dry-run module, imported after JAX has its devices,
    with the ``XLA_FLAGS`` its import sets taken back out."""
    import jax

    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as JD
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return JD


def _stand_in(multi: bool):
    shape = (2, 16, 16) if multi else (16, 16)
    axes = ("pod", "data", "model") if multi else ("data", "model")
    return types.SimpleNamespace(axis_names=axes, shape=shape, devices=types.SimpleNamespace(shape=shape))


# ---------------------------------------------------------------- (a)-(c)
TABLES = ("FSDP_ARCHS", "OPT8BIT_ARCHS", "SERVE_INT8_ARCHS", "HEAD_PAD_ARCHS", "MICROBATCH_ARCHS", "REMAT_ARCHS")


@pytest.mark.parametrize("name", TABLES)
def test_tables_equal_the_reference(JD, name):
    from repro_torch.launch import dryrun as D

    assert getattr(D, name) == getattr(JD, name)


def test_shapes_and_supported_cells_equal_the_reference(JD):
    import repro.configs as RC

    import repro_torch.configs as TC
    from repro_torch.launch import dryrun as D

    assert {k: dataclasses.astuple(v) for k, v in TC.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in RC.SHAPES.items()}
    assert TC.LONG_CONTEXT_OK == RC.LONG_CONTEXT_OK
    assert sorted(TC.names()) == sorted(RC.names())
    for a in RC.names():
        for s in RC.SHAPES:
            assert TC.cell_supported(a, s) == RC.cell_supported(a, s), (a, s)
        mine, theirs = dataclasses.asdict(D.effective_config(a)), dataclasses.asdict(JD.effective_config(a))
        assert mine == {k: theirs[k] for k in mine}, a


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_policy_for_equals_the_reference(JD, multi):
    import repro.configs as RC

    import repro_torch.configs as TC
    from repro_torch.launch import dryrun as D

    mesh = _stand_in(multi)
    n = 0
    for a in RC.names():
        for s in RC.SHAPES:
            mine = dataclasses.asdict(D.policy_for(D.effective_config(a), TC.SHAPES[s], mesh))
            theirs = dataclasses.asdict(JD.policy_for(JD.effective_config(a), RC.SHAPES[s], mesh))
            theirs.pop("unroll")
            assert mine == theirs, (a, s)
            n += 1
    assert n == 40


def test_input_specs_and_make_batch_equal_the_reference():
    import repro.configs as RC

    import repro_torch.configs as TC

    for a in RC.names():
        for s in RC.SHAPES:
            mine, theirs = TC.input_specs(TC.get(a), TC.SHAPES[s]), RC.input_specs(RC.get(a), RC.SHAPES[s])
            assert set(mine) == set(theirs), (a, s)
            for k, t in mine.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(theirs[k].shape), (a, s, k)
                assert str(t.dtype).split(".")[1] == str(theirs[k].dtype), (a, s, k)
    for a in RC.names():  # values at a size a test can hold, every kind
        for kind in ("train", "prefill", "decode"):
            mine = TC.make_batch(TC.get_reduced(a), TC.ShapeCell("t", 40, 3, kind), np.random.default_rng(7))
            theirs = RC.make_batch(RC.get_reduced(a), RC.ShapeCell("t", 40, 3, kind), np.random.default_rng(7))
            assert set(mine) == set(theirs)
            for k in mine:
                assert mine[k].dtype == theirs[k].dtype and np.array_equal(mine[k], theirs[k]), (a, kind, k)


# ---------------------------------------------------------------------- (d)
def _local_bytes(sds, spec, sizes: dict) -> int:
    n = 1
    entries = tuple(spec) + (None,) * (len(sds.shape) - len(tuple(spec)))
    for dim, e in zip(sds.shape, entries):
        axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        k = math.prod(sizes[x] for x in axes)
        assert dim % k == 0, (sds.shape, spec)
        n *= dim // k
    return n * np.dtype(sds.dtype).itemsize


def _tree_bytes(tree, specs, sizes) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(tree[k], specs[k], sizes) for k in tree)
    return _local_bytes(tree, specs, sizes)


def _reference_argument_bytes(JD, arch: str, shape_name: str) -> int:
    """Per-device bytes of the reference's arguments on the single mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    import repro.configs as RC
    from repro.models.model import StreamModel, quantize_params, quantized_pspecs
    from repro.train.trainer import state_pspecs

    mesh = _stand_in(False)
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    cfg = JD.effective_config(arch)
    shape = RC.SHAPES[shape_name]
    pol = JD.policy_for(cfg, shape, mesh)
    model = StreamModel(cfg, pol)
    in_specs = RC.input_specs(cfg, shape)
    batch = sum(_local_bytes(v, JP(pol.batch_spec(v.shape[0])), sizes) for v in in_specs.values())
    raw = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    if shape.kind == "train":
        opt = JD._optimizer(cfg)
        state = {"params": raw, "opt": jax.eval_shape(opt.init, raw)}
        return _tree_bytes(state, state_pspecs(model, opt), sizes) + batch
    pspecs = model.param_pspecs()
    if pol.weights_int8:
        params, pspecs = jax.eval_shape(quantize_params, raw), quantized_pspecs(raw, pspecs)
    else:
        params = raw
    total = _tree_bytes(params, pspecs, sizes) + batch
    if shape.kind == "decode":
        cache = jax.eval_shape(lambda: model.init_cache(shape.global_batch, shape.seq_len))
        total += _tree_bytes(cache, model.cache_pspecs(shape.global_batch), sizes) + jnp.int32(0).nbytes
    return total


@pytest.mark.parametrize("cell", ARG_CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_argument_bytes_equal_the_reference(runs, JD, cell):
    got = runs["dry"]["arguments"]["__".join(cell)]
    want = _reference_argument_bytes(JD, *cell)
    if cell == ("mamba2-2.7b", "decode_32k"):
        want += MAMBA2_CONV_EXTRA
    assert got == want, (cell, got, want, got - want)


# ---------------------------------------------------------------------- (e)
@pytest.mark.parametrize("step", ["train", "decode"])
def test_collective_inventory_equals_real_gloo_ranks(runs, step):
    fake, real = runs["dry"]["inventory"][step], runs["rank0"][step]
    assert fake == real
    assert sum(n for n, _ in fake.values()) > 0
    if step == "train":  # ZeRO-3's gathers and their adjoints, the row-parallel sums
        assert all(fake[k][0] > 0 for k in ("all-reduce", "all-gather", "reduce-scatter")), fake


# ---------------------------------------------------------------------- (f)
def _matrix_params(cfg) -> tuple[int, int]:
    """(the layers' matrix parameters, the unembed's) of a dense config."""
    hd = cfg.hd
    attn = cfg.d_model * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    mlp = cfg.d_model * cfg.d_ff * (3 if cfg.mlp_kind == "gated" else 2)
    return cfg.n_layers * (attn + mlp), cfg.d_model * cfg.vocab_padded


@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_products_are_two_flops_a_parameter_a_token(runs, arch):
    import repro_torch.configs as TC

    cfg = TC.get_reduced(arch)
    layers, unembed = _matrix_params(cfg)
    got = runs["dry"]["products"][arch]
    tokens, predicted = FLOP_B * FLOP_S, FLOP_B * (FLOP_S - 1)
    assert got["prefill"] == 2 * tokens * layers + 2 * FLOP_B * unembed
    fwd = 2 * tokens * layers + 2 * predicted * unembed
    assert got["train"] == 3 * fwd + 2 * predicted * unembed
    # "full" runs each group's forward again in its backward, and torch's
    # checkpoint stops that run at the last tensor the backward saved: a
    # group's closing MLP product is not run again unless a norm after it
    # (gemma2's post2) saved its output
    skipped = 0 if cfg.post_norms else (cfg.n_layers // len(cfg.pattern)) * cfg.d_model * cfg.d_ff
    assert got["train_full"] == got["train"] + 2 * tokens * (layers - skipped)


# ---------------------------------------------------------------------- (g)
@pytest.mark.parametrize("s, causal, window, sk, off", [
    (64, True, None, None, 0), (100, True, 17, None, 0), (33, False, None, 70, 0), (20, True, None, 90, 50),
    (48, True, 16, 128, 80), (7, False, 3, None, 0), (300, True, 256, None, 0)])
def test_mask_pairs_equal_a_brute_force_count(s, causal, window, sk, off):
    from repro_torch.kernels import cost

    keys = s if sk is None else sk
    want = 0
    for i in range(s):
        q = off + i
        for j in range(keys):
            want += (not causal or j <= q) and (window is None or j > q - window)
    assert cost.mask_pairs(s, causal, window, sk, off) == want


# ---------------------------------------------------------------------- (h)
@pytest.mark.parametrize("cell", MEASURE_CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_measured_extrapolation_equals_full_depth(runs, cell):
    got = runs["dry"]["measure"]["__".join(cell)]
    assert got["status"] == "OK"
    for key in ("flops", "bytes"):
        assert got["extrapolated"][key] == got["full"][key], key
    assert got["extrapolated"]["coll"] == got["full"]["coll"]


# ---------------------------------------------------------------------- (i)
def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta")


def _contiguous_of(shape, perm, dtype):
    """A (B, H, S, D)-style view of a contiguous tensor laid out by ``perm``."""
    base = torch.empty([shape[i] for i in perm], dtype=dtype, device="meta")
    inv = [perm.index(i) for i in range(len(shape))]
    return base.permute(*inv)


def _kernel_calls():
    """(name, plain call on CPU tensors, meta call, card-layout outputs)."""
    from repro_torch.kernels import adamw8bit, flash_attention as fa, grad_norm, rglru_scan as rs, ssd_scan as ss

    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)

    b, h, kv, s, d = 2, 4, 2, 24, 16
    q, k, v = (rnd(b, n, s, d) for n in (h, kv, kv))
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    do = rnd(b, h, s, d)
    x, dt = rnd(b, 3, s, 16), rnd(b, 3, s).abs()
    A, Bm = -rnd(3).abs(), rnd(b, 1, s, 16)
    y, _ = ss.ssd_scan(x, dt, A, Bm, Bm, chunk=8)
    xr, la = rnd(b, s, 8), -rnd(b, s, 8).abs()
    hr, _ = rs.rglru_scan(xr, la)
    p, gp = rnd(3, 300), rnd(3, 300)
    opt = dict(lr=torch.tensor(1e-3), bc1=torch.tensor(0.1), bc2=torch.tensor(0.05), b1=0.9, b2=0.95, eps=1e-8,
               weight_decay=0.01)

    def opt_args(t):
        return (t(p), t(gp), t(torch.zeros(3, 300, dtype=torch.int8)), t(torch.zeros(3, 2)),
                t(torch.zeros(3, 300, dtype=torch.int8)), t(torch.zeros(3, 2, 2)))

    bhsd = (0, 2, 1, 3)  # the card's (B, S, H, D) storage under a (B, H, S, D) view
    return [
        ("flash_attention", lambda t: fa.flash_attention(t(q), t(k), t(v), causal=True, window=8, return_lse=True),
         [_contiguous_of((b, h, s, d), bhsd, q.dtype), torch.empty(b, h, s, device="meta")]),
        ("flash_attention_bwd", lambda t: fa.flash_attention_bwd(t(q), t(k), t(v), t(o), t(do), t(lse)),
         [_contiguous_of(t.shape, bhsd, q.dtype) for t in (q, k, v)]),
        ("ssd_scan", lambda t: ss.ssd_scan(t(x), t(dt), t(A), t(Bm), t(Bm), chunk=8),
         [_contiguous_of(x.shape, bhsd, x.dtype), torch.empty(b, 3, 16, 16, device="meta")]),
        ("ssd_scan_bwd", lambda t: ss.ssd_scan_bwd(t(x), t(dt), t(A), t(Bm), t(Bm), None, t(y), chunk=8)[:5],
         [_contiguous_of(x.shape, bhsd, x.dtype), _contiguous_of(dt.shape, (0, 2, 1), dt.dtype),
          torch.empty(3, device="meta"), _contiguous_of(Bm.shape, bhsd, Bm.dtype),
          _contiguous_of(Bm.shape, bhsd, Bm.dtype)]),
        ("rglru_scan", lambda t: rs.rglru_scan(t(xr), t(la)),
         [torch.empty(b, s, 8, device="meta"), torch.empty(b, 8, device="meta")]),
        ("rglru_scan_bwd", lambda t: rs.rglru_scan_bwd(t(xr), t(la), None, t(hr), t(hr))[:2],
         [torch.empty(b, s, 8, device="meta")] * 2),
        ("grad_norm", lambda t: grad_norm.global_norm([t(p), t(gp)], 1.0),
         [torch.empty((), device="meta")] * 2),
        ("adamw8bit", lambda t: adamw8bit.adamw8bit_update(*opt_args(t), **opt), []),
    ]


def _launch_counts():
    from repro_torch.kernels import adamw8bit, flash_attention as fa, grad_norm, rglru_scan as rs, ssd_scan as ss

    return (fa.LAUNCHES, fa.BWD_LAUNCHES, fa.OFFSET_LAUNCHES, fa.BWD_OFFSET_LAUNCHES, ss.LAUNCHES, ss.BWD_LAUNCHES,
            rs.LAUNCHES, rs.BWD_LAUNCHES, adamw8bit.LAUNCHES, grad_norm.LAUNCHES)


@pytest.mark.parametrize("idx", range(8), ids=["flash_attention", "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd",
                                                "rglru_scan", "rglru_scan_bwd", "grad_norm", "adamw8bit"])
def test_meta_branch_allocates_as_the_card_and_counts_no_launch(idx):
    from repro_torch.kernels import cost

    name, call, card = _kernel_calls()[idx]
    plain = call(lambda t: t.clone())
    plain = [] if plain is None else [t for t in plain if t is not None]
    before = _launch_counts()
    seen = []
    cost._SINKS.append(lambda k, w: seen.append((k, w)))
    try:
        got = call(_meta)
    finally:
        cost._SINKS.pop()
    got = [] if got is None else [t for t in got if t is not None]
    assert _launch_counts() == before
    assert [k for k, _ in seen] == [name] and seen[0][1].bytes > 0 and seen[0][1].flops > 0
    assert len(got) == len(plain) == len(card)
    for m, p, c in zip(got, plain, card):
        assert m.device.type == "meta"
        assert m.shape == p.shape and m.dtype == p.dtype, name
        assert m.stride() == c.stride(), (name, m.stride(), c.stride())


def test_meta_branch_scratch_mirrors_the_card_counts():
    """The meta branches' scratch sizes against hand counts of the C
    functions they mirror (the card's phase holds them against the C
    functions themselves)."""
    from repro_torch.kernels import flash_attention as fa, grad_norm, ssd_scan as ss

    # K1's backward: Di padded to 64, then the GQA split's partials (split 2 at D 128, 4 at D 256)
    assert fa._bwd_scratch_floats(torch.bfloat16, 4, 32, 4, 1024, 1024, 128) == 4 * 32 * 1024 + 2 * 2 * 4 * 4 * 1024 * 128
    assert fa._bwd_scratch_floats(torch.bfloat16, 4, 16, 1, 1024, 1024, 256) == 4 * 16 * 1024 + 4 * 2 * 4 * 1 * 1024 * 256
    assert fa._bwd_scratch_floats(torch.bfloat16, 4, 28, 4, 1024, 1024, 128) == 4 * 28 * 1024  # GQA 7: no split
    assert fa._bwd_scratch_floats(torch.bfloat16, 1, 3, 3, 5, 5, 64) == 64
    assert fa._bwd_scratch_floats(torch.float32, 1, 8, 2, 100, 100, 64) == 800
    # K2's backward at mamba2's training call: 80 heads of one group, 40 a block
    nc = 4
    assert ss._bwd_scratch_floats(4, 80, 1, 1024, 64, 128, 256, torch.bfloat16) == (
        3 * 4 * 80 * nc * 128 * 64 + 2 * 4 * 1 * 2 * 1024 * 128 + 4 * 4 * 80 * 1024 + 4 * 80 * nc * (1 + 8))
    assert grad_norm._parts(1) == 1 and grad_norm._parts(65536 * 3 + 1) == 4 and grad_norm._parts(1 << 40) == 1024


# ---------------------------------------------------------------------- (j)
def test_cli_writes_the_reference_records(runs):
    d = runs["dir"] / "cli"
    ok = json.loads((d / "whisper-tiny__decode_32k__single.json").read_text())
    assert ok["status"] == "OK" and RECORD_KEYS <= set(ok), sorted(ok)
    assert set(ok["memory_analysis"]) == {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes"}
    assert set(ok["hlo_collective_counts"]) == {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute"}
    assert ok["devices"] == 256 and ok["mesh"] == [16, 16]
    skip = json.loads((d / "yi-6b__long_500k__single.json").read_text())
    assert skip == {"cell": "yi-6b__long_500k__single", "status": "SKIP",
                    "reason": "pure full attention: 500k context unsupported (DESIGN.md §5)"}
    assert "1 cells: 1 OK, 0 SKIP, 0 FAIL" in runs["cli"][0]
    assert "1 cells: 0 OK, 1 SKIP, 0 FAIL" in runs["cli"][1]


# ----------------------------------------------- the kernels' work formulas
# chip_smoke.py's bounds at PERF.md's kernel-table shapes, as they were
# before the formulas moved to kernels/cost.py (ms, and what binds)
BOUNDS = {
    "attention_bound": [
        ((1, 32, 4, 512, 128, "bfloat16", True, None, None, 0), (0.0028170698507462687, "bytes")),
        ((1, 32, 4, 2000, 128, "bfloat16", True, None, None, 0), (0.03314902325581395, "operations")),
        ((4, 16, 1, 3000, 256, "bfloat16", True, 2048, None, 0), (0.26823189018402427, "operations")),
        ((4, 32, 4, 1024, 128, "bfloat16", True, None, None, 0), (0.0347758268958544, "operations")),
        ((4, 8, 4, 4500, 256, "bfloat16", True, 4096, None, 0), (0.33283010912032357, "operations")),
        ((1, 6, 6, 4, 64, "bfloat16", False, None, 1500, 0), (0.000689595223880597, "bytes")),
        ((4, 28, 4, 128, 128, "bfloat16", True, None, 1024, 640), (0.005228566778564206, "operations")),
        ((1, 8, 4, 512, 256, "float32", True, 4096, 8192, 5120), (0.25641595797014927, "operations")),
        ((2, 8, 2, 777, 64, "float32", True, None, None, 0), (0.01847803414925373, "operations")),
    ],
    "attention_bwd_bound": [
        ((4, 32, 4, 1024, 128, "bfloat16", True, None, None, 0), (0.086939567239636, "operations")),
        ((2, 8, 2, 777, 64, "bfloat16", True, None, None, 0), (0.003129495166835187, "operations")),
        ((4, 16, 1, 1024, 256, "bfloat16", True, 2048, None, 0), (0.086939567239636, "operations")),
        ((1, 8, 4, 8192, 256, "bfloat16", True, 4096, None, 0), (0.5211708984428716, "operations")),
        ((4, 6, 6, 448, 64, "bfloat16", False, None, 1500, 0), (0.010436723963599596, "operations")),
        ((4, 28, 4, 128, 128, "bfloat16", True, None, 1024, 640), (0.013071416946410515, "operations")),
    ],
    "ssd_bound": [
        ((4, 80, 1, 1024, 64, 128, 256, "bfloat16", False), (0.029187973731343284, "bytes")),
        ((4, 80, 1, 2000, 64, 128, 256, "bfloat16", True), (0.057154483582089556, "bytes")),
        ((1, 80, 1, 2015, 64, 128, 256, "float32", False), (0.19587194268656719, "operations")),
    ],
    "ssd_bwd_bound": [
        ((4, 80, 1, 1024, 64, 128, 256, "bfloat16", False), (0.07073912105156724, "operations")),
        ((4, 80, 1, 2000, 64, 128, 256, "bfloat16", True), (0.13650837354903944, "operations")),
        ((1, 80, 1, 2015, 64, 128, 256, "float32", False), (0.5091853755223881, "operations")),
    ],
    "rglru_bound": [
        ((4, 3000, 4096, True), (0.17610599164179105, "bytes")),
        ((1, 3015, 4096, False), (0.04424169074626865, "bytes")),
        ((4, 1024, 4096, False), (0.06011705313432836, "bytes")),
    ],
    "rglru_bwd_bound": [
        ((4, 1024, 4096, False, False), (0.12017541731343284, "bytes")),
        ((4, 1024, 4096, True, True), (0.12023410626865672, "bytes")),
    ],
}
YI_LEAVES = [(64000, 4096), (1, 4096), (32, 4096, 4, 128), (32, 32, 128, 4096), (32, 4096, 32, 128),
             (32, 4096, 4, 128), (32, 4096, 11008), (32, 4096, 11008), (32, 11008, 4096), (32, 4096), (32, 4096),
             (4096, 64000)]
TREE_BOUNDS = {  # (leaves, dtype): (opt8_bound, norm_bound)
    "yi-6b": ((YI_LEAVES, torch.bfloat16), ((18.28104234029851, "bytes"), (3.6185286686567166, "bytes"))),
    "qwen3-moe-w_in": (([(12, 128, 2048, 768)], torch.bfloat16),
                       ((7.279308494328359, "bytes"), (1.4423397635820896, "bytes"))),
    "yi-6b-f32": ((YI_LEAVES[:3], torch.float32), ((1.5836628823880599, "bytes"), (0.39314263880597017, "bytes"))),
}


@pytest.mark.parametrize("fn, args, want", [(f, a, w) for f, rows in BOUNDS.items() for a, w in rows],
                         ids=lambda x: x if isinstance(x, str) else None)
def test_kernel_bounds_unchanged_by_the_move(fn, args, want):
    from repro_torch.kernels import cost

    assert getattr(cost, fn)(*args) == want


@pytest.mark.parametrize("tree", list(TREE_BOUNDS))
def test_optimizer_bounds_unchanged_by_the_move(tree):
    from repro_torch.kernels import cost

    (shapes, dtype), (opt8, norm) = TREE_BOUNDS[tree]
    leaves = [torch.empty(s, dtype=dtype, device="meta") for s in shapes]
    assert cost.opt8_bound(leaves) == opt8
    assert cost.norm_bound(leaves) == norm


# ------------------------------------------------------- the subprocesses
def _dry_main(d: Path) -> None:
    """Every fake-group computation of the tests, into ``d/dry.json``."""
    import repro_torch.configs as TC
    from repro_torch.launch import dryrun as D
    from repro_torch.train.optimizer import adamw8bit

    out: dict = {"arguments": {}, "inventory": {}, "products": {}, "measure": {}}
    mesh = D.make_production_mesh()
    for arch, shape in ARG_CELLS:  # (d): the arguments alone, no step
        cfg, cell = D.effective_config(arch), TC.SHAPES[shape]
        model = D.StreamModel(cfg, D.policy_for(cfg, cell, mesh), mesh=mesh, generator=None)
        out["arguments"][f"{arch}__{shape}"] = D.argument_bytes(D.cell_arguments(model, cell, mesh)[0])
    for arch, shape in MEASURE_CELLS:  # (h)
        rec = D.measure_cell(arch, shape, False, None)
        counter, _ = D.lower_cell(arch, shape, D.make_production_mesh(), microbatches=1)
        full = {"flops": float(counter.flops), "bytes": float(counter.bytes),
                "coll": {k: float(b) for k, (n, b) in counter.collectives.items() if n}}
        out["measure"][f"{arch}__{shape}"] = {
            "status": rec["status"], "full": full,
            "extrapolated": {"flops": rec["flops_per_device"], "bytes": rec["bytes_accessed_per_device"],
                             "coll": rec["collective_bytes_per_device"]}}
    mesh = D.dry_mesh((2, 2), ("data", "model"))  # (e)
    for step, (pol, cell, kw) in _inventory_cells(mesh).items():
        counter, _ = D.lower_cell("yi-6b", cell.name, mesh, cfg=TC.get_reduced("yi-6b"), shape=cell, policy=pol,
                                  **kw)
        out["inventory"][step] = counter.collectives
    mesh = D.dry_mesh((1, 1), ("data", "model"))  # (f)
    for arch in FLOP_ARCHS:
        cfg = TC.get_reduced(arch)
        got = {}
        for key, kind, remat in (("prefill", "prefill", "none"), ("train", "train", "none"),
                                 ("train_full", "train", "full")):
            cell = TC.ShapeCell(key, FLOP_S, FLOP_B, kind)
            pol = dataclasses.replace(D.policy_for(cfg, cell, mesh), remat=remat)
            counter, _ = D.lower_cell(arch, key, mesh, cfg=cfg, shape=cell, policy=pol, microbatches=1,
                                      opt=adamw8bit(1e-4))
            got[key] = counter.flops - sum(k["flops"] for k in counter.kernels.values())
        out["products"][arch] = got
    (d / "dry.json").write_text(json.dumps(out))


def _inventory_cells(mesh) -> dict:
    """(e)'s train and decode cells: (policy, shape, lower_cell keywords)."""
    import repro_torch.configs as TC
    from repro_torch.launch import dryrun as D
    from repro_torch.train.optimizer import adamw8bit

    cfg = TC.get_reduced("yi-6b")
    train = TC.ShapeCell("inv_train", INV_TRAIN["seq_len"], INV_TRAIN["global_batch"], "train")
    decode = TC.ShapeCell("inv_decode", INV_DECODE["seq_len"], INV_DECODE["global_batch"], "decode")
    pol_train = dataclasses.replace(D.policy_for(cfg, train, mesh), fsdp_axes=("data",), fsdp_selective=False,
                                    remat="full")
    return {"train": (pol_train, train, {"opt": adamw8bit(1e-4), "microbatches": INV_TRAIN["microbatches"]}),
            "decode": (D.policy_for(cfg, decode, mesh), decode, {})}


def _rank_main(rank: int, d: Path) -> None:
    """One of 4 gloo ranks: (e)'s steps on real CPU tensors, the
    collectives counted by the dry run's mode; rank 0 writes them."""
    import torch.distributed as dist

    import repro_torch.configs as TC
    from repro_torch.launch import dryrun as D
    from repro_torch.models.model import StreamModel
    from repro_torch.models.sharding import Mesh, cut
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.trainer import build_train_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"), WORLD), rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    mesh = Mesh((2, 2), ("data", "model"), device="cpu")
    cfg = TC.get_reduced("yi-6b")
    rng = np.random.default_rng(0)
    out = {}
    for step, (pol, cell, kw) in _inventory_cells(mesh).items():
        model = StreamModel(cfg, pol, mesh=mesh, generator=0)
        batch = {k: torch.from_numpy(v) for k, v in TC.make_batch(cfg, cell, rng).items()}
        if step == "train":
            params = model.param_tree()
            for p in tree_leaves(params):
                p.requires_grad_(True)
            opt = kw["opt"]
            state = {"params": params, "opt": opt.init(params, mesh=mesh, pspecs=model.param_pspecs())}
            rows = {k: cut(v, (pol.batch_spec(v.shape[0]),), mesh) for k, v in batch.items()}
            step_fn, _ = build_train_step(model, opt, microbatches=kw["microbatches"], mesh=mesh)
            with D.Counter(collectives_only=True) as counter:
                step_fn(state, rows)
        else:
            cache = model.init_cache(cell.global_batch, cell.seq_len)
            with D.Counter(collectives_only=True) as counter:
                model.decode_step(cache, batch["tokens"], torch.tensor(cell.seq_len // 2, dtype=torch.int32))
        out[step] = counter.collectives
    if rank == 0:
        (d / "rank0.json").write_text(json.dumps(out))
    dist.destroy_process_group()


if __name__ == "__main__":
    role = sys.argv[1]
    if role == "dry":
        _dry_main(Path(sys.argv[2]))
    elif role == "rank":
        _rank_main(int(sys.argv[2]), Path(sys.argv[3]))
    else:
        raise SystemExit(f"unknown role {role!r}")
