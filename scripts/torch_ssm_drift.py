#!/usr/bin/env python3
"""How far a model's served tokens drift from its teacher-forced forward,
and how far a wrong decode state sends them.

    python3 scripts/torch_ssm_drift.py                          # mamba2-2.7b
    python3 scripts/torch_ssm_drift.py --model recurrentgemma   # recurrentgemma-9b
    python3 scripts/torch_ssm_drift.py --model gemma2           # gemma2-2b

On a machine with one CUDA card. The full-width model with chip_smoke.py's
random bf16 weights (seed ``chip_smoke.SEED``) serves four prompts greedily
for 16 tokens (prefill through the port's kernels, then the one-token
decode step), and each row's sequence goes through the teacher-forced
full-sequence forward. mamba2-2.7b takes 2000-token prompts (prefill on
the SSD kernel); recurrentgemma-9b takes 3000-token prompts, past its local
layers' 2048 window (prefill on the RG-LRU kernel and on flash attention
with its window; decode through the RG-LRU state and the ring cache);
gemma2-2b takes 4500-token prompts, past its local layers' 4096 window
(prefill on flash attention with its softcap and window; decode through
the ring and the dense caches). For
each token it prints the gap (how far the served token's logit trails the
forward's max) and the largest logit difference between the two, with

- bf16 activations, the sound path (what chip_smoke.py serves);
- f32 activations, the same bf16 weights;
- bf16 activations, then f32 ones, with one fault planted in the decode
  cache after the prefill (``MODELS``' faults): the gaps a broken state
  gives, which the greedy slacks in chip_smoke.py have to catch.

Then it measures how the stack amplifies noise: a perturbation of 1e-3
of the embeddings' mean magnitude on a 256-token prefix, and its size
relative to the residual stream after every eighth layer and the last,
in bf16 and in f32. Writes ``chiprun_out/ssm_drift[_recurrentgemma|_gemma2].json``.
Exits non-zero with no CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)

PROMPTS, NEW = 4, 16


def _leaves(cache, key):
    """Every layer stack's ``key`` tensor, slots and tail."""
    return [st[key] for sec in cache.values() for st in sec.values() if key in st]


# ---- mamba2: faults in the one slot's SSD and conv states
def _zero_ssd(model, tokens, cache):
    cache["slots"]["s0"]["ssd"].zero_()


def _zero_conv(model, tokens, cache):
    cache["slots"]["s0"]["conv"].zero_()


def _zero_ssd_layer0(model, tokens, cache):
    cache["slots"]["s0"]["ssd"][0].zero_()


def _ssd_of_next_row(model, tokens, cache):
    ssd = cache["slots"]["s0"]["ssd"]
    ssd.copy_(ssd.roll(-1, dims=1))


def _ssd_in_bf16(model, tokens, cache):
    ssd = cache["slots"]["s0"]["ssd"]
    ssd.copy_(ssd.bfloat16().float())


def _ssd_one_position_early(model, tokens, cache):
    _, short = model.prefill(tokens[:, :-1], 0)
    cache["slots"]["s0"]["ssd"].copy_(short["slots"]["s0"]["ssd"])


# ---- recurrentgemma: faults in the RG-LRU states and the local layers' rings
def _zero_h(model, tokens, cache):
    for t in _leaves(cache, "h"):
        t.zero_()


def _zero_rec_conv(model, tokens, cache):
    for t in _leaves(cache, "conv"):
        t.zero_()


def _h_of_next_row(model, tokens, cache):
    for t in _leaves(cache, "h"):
        t.copy_(t.roll(-1, dims=-2))  # the batch dim: (B, D) in the tail, (G, B, D) in slots


def _ring_one_slot_off(model, tokens, cache):
    for key in ("k", "v"):  # every position one slot later than pos % window
        for t in _leaves(cache, key):
            t.copy_(t.roll(1, dims=-3))


def _window_on_ring_slots(model, tokens, cache):
    """Decode applies the window to ring slot indices as a non-ring cache
    would (the port's rule before ring caches): from the wrap on, it masks
    the most recent positions."""
    from repro_torch.models import layers

    valid = layers._decode_valid
    return mock.patch.object(
        layers, "_decode_valid", lambda pos, s, *, ring, window: valid(pos, s, ring=False, window=window)
    )


# ---- gemma2: faults in the attention caches and the decode step
def _last_prompt_position_zeroed(model, tokens, cache):
    """Every layer's K and V of the last prompt position zeroed (slot pos % size:
    the ring's or the dense cache's)."""
    last = tokens.shape[1] - 1
    for key in ("k", "v"):
        for t in _leaves(cache, key):
            t[..., last % t.shape[-3], :, :].zero_()


def _attention_softcap_dropped(model, tokens, cache):
    """Decode attends without the attention softcap of 50."""
    import dataclasses

    from repro_torch.models import layers

    attend = layers._attend
    return mock.patch.object(
        layers, "_attend", lambda q, kf, vf, valid, ap: attend(q, kf, vf, valid, dataclasses.replace(ap, softcap=None))
    )


def _post_norms_dropped(model, tokens, cache):
    """Decode runs each block without its sandwich norms."""
    import dataclasses

    return mock.patch.object(model, "cfg", dataclasses.replace(model.cfg, post_norms=False))


MODELS = {
    "mamba2": ("mamba2-2.7b", chip_smoke.SSM_PROMPT_LEN, {
        "SSD state zeroed in every layer": _zero_ssd,
        "conv state zeroed in every layer": _zero_conv,
        "SSD state zeroed in layer 0 only": _zero_ssd_layer0,
        "SSD state of the next row (a slot mix-up)": _ssd_of_next_row,
        "SSD state rounded to bf16": _ssd_in_bf16,
        "SSD state one prompt position early": _ssd_one_position_early,
    }),
    "recurrentgemma": ("recurrentgemma-9b", chip_smoke.RG_PROMPT_LEN, {
        "RG-LRU h zeroed in every layer": _zero_h,
        "conv state zeroed in every RG-LRU layer": _zero_rec_conv,
        "RG-LRU h of the next row (a slot mix-up)": _h_of_next_row,
        "ring written one slot off": _ring_one_slot_off,
        "window mask applied to ring slots": _window_on_ring_slots,
    }),
    "gemma2": ("gemma2-2b", chip_smoke.GEMMA2_PROMPT_LEN, {
        "ring written one slot off": _ring_one_slot_off,
        "window mask applied to ring slots": _window_on_ring_slots,
        "last prompt position's K and V zeroed in every layer": _last_prompt_position_zeroed,
        "attention softcap dropped in decode": _attention_softcap_dropped,
        "sandwich norms dropped in decode": _post_norms_dropped,
    }),
}


def _served_vs_forward(model, tokens, s_cache, fault=None):
    """Greedy prefill + decode (``fault`` planted in the cache after the
    prefill; a fault in the decode code returns the patch it runs under),
    then the teacher-forced forward of each row."""
    import torch

    plen = tokens.shape[1]
    lg, cache = model.prefill(tokens, s_cache, cache_dtype=torch.float32)
    patch = fault(model, tokens, cache) if fault is not None else None
    gen, served = [lg.argmax(-1)], [lg]
    with patch or contextlib.nullcontext():
        for _ in range(NEW - 1):
            lg, cache = model.decode_step(cache, gen[-1][:, None])
            served.append(lg[:, 0])
            gen.append(lg[:, 0].argmax(-1))
    gen, served = torch.stack(gen, 1), torch.stack(served, 1)
    rows = []
    for r in range(tokens.shape[0]):
        seq = torch.cat([tokens[r], gen[r, :-1]])[None]
        fwd = model(seq)[0, plen - 1:]
        gap = fwd.max(-1).values - fwd.gather(-1, gen[r][:, None])[:, 0]
        diff = (fwd - served[r]).abs().max(-1).values
        rows.append({"gap": [float(g) for g in gap], "max_logit_diff": [float(d) for d in diff]})
        del fwd
    return rows


def _amplification(model, tokens, gen):
    """Relative size of a 1e-3 embedding perturbation after every eighth layer and the last."""
    import torch

    x = model._embed_tokens(tokens[:1, :256])
    positions = torch.arange(x.shape[1], device=x.device)
    noise = torch.randn(x.shape, generator=gen, device=x.device)
    xp = x + (noise * 1e-3 * x.float().abs().mean()).to(x.dtype)
    layers = model._layer_params()
    out = []
    for i, (kind, _, _, _, blk) in enumerate(layers):
        x, _ = model._layer(kind, blk, x, positions)
        xp, _ = model._layer(kind, blk, xp, positions)
        if i % 8 == 7 or i == len(layers) - 1:
            out.append({"layer": i, "rel": float((x.float() - xp.float()).norm() / x.float().norm())})
    return out


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=tuple(MODELS), default="mamba2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ssm_drift: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    _build.build_all()
    arch, prompt_len, faults = MODELS[args.model]
    cfg = configs.get(arch)
    rng = np.random.default_rng(chip_smoke.SEED + 1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (PROMPTS, prompt_len))).cuda()
    s_cache = prompt_len + chip_smoke.MAX_NEW
    results = {"card": card, "model": arch, "prompt_len": prompt_len}
    for compute, runs in (
        ("bfloat16", [("bf16 activations", None)] + [(f"bf16, fault: {k}", f) for k, f in faults.items()]),
        ("float32", [("f32 activations", None)] + [(f"f32, fault: {k}", f) for k, f in faults.items()]),
    ):
        model = StreamModel(cfg, Policy(compute_dtype=compute), device="cuda", generator=chip_smoke.SEED)
        for label, fault in runs:
            rows = _served_vs_forward(model, tokens, s_cache, fault)
            decoded_gap = max(max(r["gap"][1:]) for r in rows)
            worst_diff = max(max(r["max_logit_diff"]) for r in rows)
            results[label] = {"rows": rows, "worst_decoded_gap": decoded_gap, "worst_logit_diff": worst_diff}
            print(f"[{card}] {arch} {label}: worst gap of a decoded token {decoded_gap:.4f}, worst logit "
                  f"difference {worst_diff:.4f}, first-token gaps {[round(r['gap'][0], 4) for r in rows]}",
                  flush=True)
        amp = _amplification(model, tokens, torch.Generator(device="cuda").manual_seed(chip_smoke.SEED))
        results[f"{compute} amplification"] = amp
        print(f"[{card}] {arch} {compute} activations, 1e-3 embedding perturbation, relative after layer: "
              + ", ".join(f"{a['layer']}: {a['rel']:.4f}" for a in amp), flush=True)
        del model
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    suffix = "" if args.model == "mamba2" else f"_{args.model}"
    (out / f"ssm_drift{suffix}.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
