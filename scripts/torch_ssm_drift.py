#!/usr/bin/env python3
"""How far mamba2's served tokens drift from its teacher-forced forward,
and how far a wrong decode state sends them.

    python3 scripts/torch_ssm_drift.py      # on a machine with one CUDA card

Full-width mamba2-2.7b with chip_smoke.py's random bf16 weights (seed
``chip_smoke.SEED``) serves four 2000-token prompts greedily for 16
tokens (prefill through the SSD kernel, then the one-token recurrence),
and each row's sequence goes through the teacher-forced full-sequence
forward (the SSD kernel over all of it). For each token it prints the
gap (how far the served token's logit trails the forward's max) and the
largest logit difference between the two, with

- bf16 activations, the sound path (what chip_smoke.py serves);
- f32 activations, the same bf16 weights;
- bf16 activations with one fault planted in the decode cache after the
  prefill (``FAULTS``): the gaps a broken state gives, which the greedy
  slack in chip_smoke.py has to catch.

Then it measures how the stack amplifies noise: a perturbation of 1e-3
of the embeddings' mean magnitude on a 256-token prefix, and its size
relative to the residual stream after every eighth layer, in bf16 and
in f32. Writes ``chiprun_out/ssm_drift.json``. Exits non-zero with no
CUDA device.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)

PROMPTS, PROMPT_LEN, NEW = 4, 2000, 16


def _zero_ssd(model, tokens, slot):
    slot["ssd"].zero_()


def _zero_conv(model, tokens, slot):
    slot["conv"].zero_()


def _zero_ssd_layer0(model, tokens, slot):
    slot["ssd"][0].zero_()


def _ssd_of_next_row(model, tokens, slot):
    slot["ssd"].copy_(slot["ssd"].roll(-1, dims=1))


def _ssd_in_bf16(model, tokens, slot):
    slot["ssd"].copy_(slot["ssd"].bfloat16().float())


def _ssd_one_position_early(model, tokens, slot):
    _, short = model.prefill(tokens[:, :-1], 0)
    slot["ssd"].copy_(short["slots"]["s0"]["ssd"])


# faults planted in the decode cache between prefill and the first decode step
FAULTS = {
    "SSD state zeroed in every layer": _zero_ssd,
    "conv state zeroed in every layer": _zero_conv,
    "SSD state zeroed in layer 0 only": _zero_ssd_layer0,
    "SSD state of the next row (a slot mix-up)": _ssd_of_next_row,
    "SSD state rounded to bf16": _ssd_in_bf16,
    "SSD state one prompt position early": _ssd_one_position_early,
}


def _served_vs_forward(model, tokens, fault=None):
    """Greedy prefill + decode (``fault`` planted in the cache after the
    prefill), then the teacher-forced forward of each row."""
    import torch

    lg, cache = model.prefill(tokens, 0)
    if fault is not None:
        fault(model, tokens, cache["slots"]["s0"])
    gen, served = [lg.argmax(-1)], [lg]
    for _ in range(NEW - 1):
        lg, cache = model.decode_step(cache, gen[-1][:, None])
        served.append(lg[:, 0])
        gen.append(lg[:, 0].argmax(-1))
    gen, served = torch.stack(gen, 1), torch.stack(served, 1)
    rows = []
    for r in range(tokens.shape[0]):
        seq = torch.cat([tokens[r], gen[r, :-1]])[None]
        fwd = model(seq)[0, PROMPT_LEN - 1:]
        gap = fwd.max(-1).values - fwd.gather(-1, gen[r][:, None])[:, 0]
        diff = (fwd - served[r]).abs().max(-1).values
        rows.append({"gap": [float(g) for g in gap], "max_logit_diff": [float(d) for d in diff]})
    return rows


def _amplification(model, tokens, gen):
    """Relative size of a 1e-3 embedding perturbation after every eighth layer."""
    import torch

    x = model._embed_tokens(tokens[:1, :256])
    noise = torch.randn(x.shape, generator=gen, device=x.device)
    xp = x + (noise * 1e-3 * x.float().abs().mean()).to(x.dtype)
    out = []
    for i, blk in enumerate(model._layer_params()):
        x = x + model._ssm(blk, model._norm(blk["norm1"]["w"], x), None, i)
        xp = xp + model._ssm(blk, model._norm(blk["norm1"]["w"], xp), None, i)
        if i % 8 == 7:
            out.append({"layer": i, "rel": float((x.float() - xp.float()).norm() / x.float().norm())})
    return out


def main() -> int:
    import numpy as np
    import torch

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
    cfg = configs.get("mamba2-2.7b")
    rng = np.random.default_rng(chip_smoke.SEED + 1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (PROMPTS, PROMPT_LEN))).cuda()
    results = {"card": card}
    for compute, runs in (
        ("bfloat16", [("bf16 activations", None)] + [(f"bf16, fault: {k}", f) for k, f in FAULTS.items()]),
        ("float32", [("f32 activations", None)]),
    ):
        model = StreamModel(cfg, Policy(compute_dtype=compute), device="cuda", generator=chip_smoke.SEED)
        for label, fault in runs:
            rows = _served_vs_forward(model, tokens, fault)
            decoded_gap = max(max(r["gap"][1:]) for r in rows)
            worst_diff = max(max(r["max_logit_diff"]) for r in rows)
            results[label] = {"rows": rows, "worst_decoded_gap": decoded_gap, "worst_logit_diff": worst_diff}
            print(f"[{card}] {label}: worst gap of a decoded token {decoded_gap:.4f}, worst logit "
                  f"difference {worst_diff:.4f}, first-token gaps {[round(r['gap'][0], 4) for r in rows]}",
                  flush=True)
        amp = _amplification(model, tokens, torch.Generator(device="cuda").manual_seed(chip_smoke.SEED))
        results[f"{compute} amplification"] = amp
        print(f"[{card}] {compute} activations, 1e-3 embedding perturbation, relative after layer: "
              + ", ".join(f"{a['layer']}: {a['rel']:.4f}" for a in amp), flush=True)
        del model
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ssm_drift.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
