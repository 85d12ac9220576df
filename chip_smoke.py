#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py            # from the repository root

Phases: (1) the card's name and power limit; (2) build every CUDA kernel
of the port from ``src/repro_torch/kernels/csrc`` with nvcc; (3) hold
each kernel against its plain PyTorch version on the card, at its paths'
shapes and a sweep of modes, and time kernel, plain version and (where
one exists) one library call: K1 (flash attention, head dims 64, 128 and
256; gemma2-2b's softcap of 50 at 256, its wave's calls timed beside
qwen2-7b's and mistral-large-123b's prefills), K1's backward (dq, dk, dv
against autograd through the plain version; head dims 64, 128 and 256,
recurrentgemma's training call timed; gemma2's softcap at 256, its
training call timed with and without the cap and its 8192-token context
with the window, flex_attention's backward the library; qwen2-7b's GQA 7
call timed) and its forward's row log-sum-exp, then K2 (SSD scan), then K2's
backward (dx, ddt, dA, dB, dC and d(initial state) against autograd
through the plain version, the same bits on a repeated call, and its
training call timed beside K2's forward at that call), then K3 (RG-LRU
scan), then K3's backward (dx, dlog_a and dh0 against the plain adjoint
run in float64, at the tile edges of both K3 kernels, the same bits on
repeated calls, and its training call timed beside K3's forward at that
call), then K1 and its backward at whisper-tiny's calls (queries and keys
of different lengths for its cross attention, no mask; the encoder's
bidirectional calls; more queries than keys once; the backward's bits);
(3b) the paper's loop
(examples/torch_quickstart.py): copd-mlp trained from a stream on a
three-broker cluster and served by a two-replica ``InferenceDeployment``,
then by a transactional one across a kill of the predictions topic's
leader, then the ``Supervisor`` restarting a crashed training job from
its checkpoint; (4) train full-width yi-6b (16 of
its 32 layers, d 4096, bf16 weights from a seed) from a stream:
a seeded Markov corpus ingested into a 4-partition topic and announced
on the control topic, ``TrainingJob(streaming=True)`` with AdamW for 8
steps of 4 x 1024 tokens and its streaming eval, checking finite,
falling losses and K1's launches forward and backward; then the
gradients of one full-width attention layer at the training shape,
through K1 forward + backward against the plain version; (4b) the 8-bit
AdamW update's kernel and the global-norm kernel whose clip scale it
applies, against their plain versions (one layer slice of each of
yi-6b's stacked leaf shapes and embed, bf16 and f32, three clipped
updates from the zero state) and timed over the whole 32-layer tree,
with the optimizer phase (norm and updates) and the norm's library
yardstick; (4c) the same training workload on yi-6b at all 32 layers
with ``adamw8bit``, a norm launch a leaf and one to finish and an update
launch a leaf a step, freed before serving; (4d) the same workload on
full-width mamba2-2.7b at all 64 layers with ``adamw8bit`` (K2 forward
and backward on every layer, K1 never), then the gradients of its
trained first mixer layer at the training shape, through K2 forward +
backward against the plain version, freed before serving; (4e) the
same workload on full-width recurrentgemma-9b cut to 25 of its 38
layers with ``adamw8bit`` (K3 forward and backward on every RG-LRU
layer, K1 forward and backward at head dim 256 with its window on every
local layer, K2 never), then the gradients of its trained first RG-LRU
layer at the training shape, through K3 forward + backward against the
plain version, freed before serving; (4f) the same workload on
full-width gemma2-2b at all 26 layers (K1 forward and backward with the
softcap at head dim 256 on every layer, the window on the local ones)
and on qwen2-7b at all 28 (its QKV bias), each with ``adamw8bit``, then
each one's trained first attention layer's gradients through K1 forward
+ backward against the plain version; (4g) the same workload on
full-width qwen3-moe-30b-a3b cut to MOE_TRAIN_LAYERS of its 48 layers at
the published capacity factor (its dropped routes counted), then its
trained first MoE layer's gradients in bf16 twice (the same bits) and in
f32 against a float64 run routed alike, then the 8-bit update and the
norm on its whole trained w_in leaf, past 2^31 elements (the last rows
bit for bit against the plain version run on them alone, the norm
against a float64 sum); (4h) the same workload on full-width pixtral-12b
cut to PIXTRAL_TRAIN_LAYERS of its 40 layers, each batch behind 1024
seeded patch embeddings a sequence (K1 forward and backward at 2048
positions); (4i) the same workload on full-width whisper-tiny at its
full depth (4 encoder and 4 decoder layers), 448-token transcripts each
behind 1500 seeded frame embeddings, then the gradients of its trained
first encoder and decoder layers' attention (bidirectional, causal,
cross) through K1 forward + backward against the plain version; (4j)
activation recomputation (``Policy.remat``): full-width layer groups of
yi-6b, mamba2-2.7b, recurrentgemma-9b, qwen3-moe-30b-a3b and whisper-tiny,
the loss and every gradient under "full" and "block" held to "none"'s
bits, then recurrentgemma-9b at all 38 layers and pixtral-12b at
all 40 layers trained under "full" (phase_train's workload, each
grouped layer's kernels launched once more a step); (4k)
``dp_train_step`` over an NCCL process group of one (full-width yi-6b cut
to DP_LAYERS): uncompressed, the bits of ``build_train_step``; with the
int8-compressed mean, falling losses; ``int8_encode`` on the card against
the CPU's bits; (5) serve four
requests of mixed prompt lengths from a stream topic
through full-width yi-6b (32 layers, random bf16 weights from a
seed) with ``ContinuousLMEngine`` and check what comes back (and, after
(6b), the same through full-width qwen2-7b at all 28 layers and
mistral-large-123b cut to MISTRAL_LAYERS of its 88); (6) serve
eight requests through the same model behind ``LMServingGroup`` (two
transactional workers on a three-broker cluster, request and response
topics of two partitions at replication factor 3, the response leader
killed after the first four) and check that each comes back exactly once
and greedy; (6b) serve sixteen 1024-token prompts through the same model
behind a two-replica ``InferenceDeployment`` (examples/torch_serve_lm.py's
prefill and decode steps, two prompts a partition a prefill), replica 0
killed after the first eight, and check each completion once and greedy;
(7) drop yi-6b and serve a topic of four 2000-token prompts
through full-width mamba2-2.7b (64 layers, d 2560, random bf16 weights
from a seed) with the wave engine ``LMEngine`` and check what comes
back, then serve it again
with the same weights and f32 activations, where every token is held to
the teacher-forced forward at the tight slack; (8) drop mamba2 and serve
a topic of four 3000-token prompts through full-width recurrentgemma-9b
(38 layers, d 4096: 26 RG-LRU layers on K3, 12 local-attention layers of
window 2048 on K1 at head dim 256; random bf16 weights from a seed) with
``LMEngine`` and check what comes back (its bf16 drift stays within the
tight slack, so every token is held there and no f32 twin is needed);
(8b) serve a topic of four 4500-token prompts through full-width
gemma2-2b (26 layers, softcapped K1 at head dim 256, the local layers'
window of 4096 bound in prefill and their ring wrapped) the same way;
(8c) serve the requests of (5) through full-width qwen3-moe-30b-a3b (48
layers, 128 experts top-8) with int8 weights drawn layer by layer from
the seed, behind ``ContinuousLMEngine`` at the published capacity factor
(K1 48 times a request, the routes it drops counted), then at a factor
where no route can drop, each token held to the teacher-forced int8
forward; its fp8 KV cache (contiguous, then paged) against an f32 cache
over 16 decode steps; and int8 against bf16 with its width cut to 12
layers (total variation and argmax agreement); (8d) full-width
pixtral-12b at all 40 layers: each of (5)'s prompt lengths behind 1024
seeded patch embeddings, prefilled and decoded 16 greedy steps, every
token held to the teacher-forced forward; (8e) full-width whisper-tiny:
prompts of 4, 64, 224 and 432 tokens each behind its own 1500 seeded
frame embeddings, prefilled and decoded 16 greedy steps, then 4 requests
of 224 tokens prefilled together and decoded in lockstep, K1 12 times a
prefill, every token held to the teacher-forced forward;
(9) print the ``kernels`` line (K1's, K1's backward's, K2's and K3's
times summed over their paths, and each path's own under ``by_path``;
K2's backward, K3's backward, the 8-bit update and the global norm as
entries of their own);
(10) print the result line. Each path is driven with every kernel's
launch count set to 0 just before it and read just after.

It imports nothing of JAX or of the JAX package. With no CUDA device, or
run from a directory without the repository, it exits non-zero and
prints no result. Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.cost import (  # noqa: E402  the kernels' work, shared with the dry run
    attention_bound, attention_bwd_bound, mask_pairs, norm_bound, opt8_bound, opt8_bytes, rglru_bound, rglru_bwd_bound,
    ssd_bound, ssd_bwd_bound,
)

SEED = 0
PROMPT_LENS = (512, 1000, 1536, 2000)  # the served requests' prompt lengths
MAX_NEW = 16
BLOCK = 16
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py
# K2: error relative to max(|want|.max(), 1), tests/test_kernels.py:66-74
SSD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
GREEDY_SLACK = 0.25  # logits: a served token may trail the forward's max by this much
# mamba2 with bf16 activations: decode (one-token recurrence) and the
# teacher-forced forward (chunked scan) round differently, and the random
# 64-layer stack amplifies that noise as decoding goes on (PERF.md, Findings;
# scripts/torch_ssm_drift.py measures it, worst decoded gap about 1); a
# lost, stale or misplaced decode state gives gaps above 4 there, so the
# slack sits about halfway between on a ratio scale
SSM_BF16_DRIFT_SLACK = 2.0
# yi-6b behind the serving group: two transactional workers on a request
# topic of two partitions (replication factor 3 on 3 brokers), PROMPT_LENS
# twice; the phase fails if the read_committed view lacks a request this
# long after the response leader's kill (the reference's chaos test allows
# 60 s for the reduced model)
GROUP_WORKERS = 2
GROUP_PARTITIONS = 2
GROUP_DEADLINE_S = 300.0
SSM_PROMPT_LEN = 2000  # mamba2 path: one wave of 4 fixed-length prompts
WAVE_REQUESTS = 4  # the wave paths' slots and requests
# recurrentgemma path: past the 2048 window, so the prefill's window mask,
# the rolled ring fill and the ring's wrap on decode all run; 3000 = 46 x
# 64 + 56 = 11 x 256 + 184 is ragged for K1's tiles and any time block
RG_PROMPT_LEN = 3000
# recurrentgemma with bf16 activations needs no more than GREEDY_SLACK:
# its served tokens trail the teacher-forced forward by one or two bf16
# steps of the logits (0.0625 and 0.125 on two prompt sets), and with f32
# activations by 0; faults planted in the decode cache give 0.625 (the
# window applied to ring slots) to 14.9 (the RG-LRU state zeroed), while
# zeroing the conv state (0.25) or writing the ring one slot off (0.0625)
# hides within bf16 rounding (scripts/torch_ssm_drift.py --model
# recurrentgemma and this script on an H100 80GB HBM3 at 700 W; PERF.md,
# Findings)
# K3 is held to a float64 run of its plain version: the f32 plain
# version's 1 - a * a cancels when a is near 1 and alone strays past 1e-5
# (PERF.md, Findings). At tests/test_kernels.py's shapes and decays the
# tolerance is that file's, |got - want| <= tol + tol |want| with tol
# 1e-5; at the path's shape, with the model's decays (a up to ~0.9995)
# over 3000 steps, 1e-4 (a lost carry or a wrong decay gives errors of
# the order of rms(h))
RGLRU_TOL = 1e-5
RGLRU_F64_TOL = 1e-4
# K3's checks beside its path's own calls, (b, s, c), with a random h0 and
# the tests' decays: tests/test_kernels.py:77-87's shapes, then ragged S
RGLRU_SWEEP = ((1, 128, 64), (2, 256, 128), (3, 64, 256), (2, 1000, 96), (1, 1000, 512))
# ... and at the edges of the kernel's tiles (csrc/rglru_scan.cu: 32
# channels a block, 16 steps a warp, time blocks of 256): S = 1, one
# warp's steps + 1, T - 1, T, T + 1 and a ragged S past 3 T; C below,
# above and off the channel tile; B 1 and 3
RGLRU_EDGES = ((1, 1, 64), (1, 17, 33), (3, 255, 100), (1, 256, 96), (3, 257, 40), (1, 845, 4096))
# K2's checks beside its path's own calls, (b, s, h, p, n, g, chunk), each
# in f32 and bf16 with a random initial state that the tests' slow decays
# carry a long way: tests/test_kernels.py:49-53's shapes (G = 1, 2 and H)
# and a ragged S
SSD_SWEEP = ((1, 128, 2, 32, 64, 1, 32), (2, 256, 4, 64, 128, 2, 64), (1, 64, 4, 16, 32, 4, 64),
             (2, 1000, 8, 64, 128, 1, 256))


# K1's backward against autograd through the plain version: the error of
# dq, dk and dv relative to each one's largest element. f32: the forward's
# 2e-5 (its FMAs in another order; measured 3e-6 at the training shape);
# bf16: the forward's 2e-2 (P and dS enter their products rounded to bf16)
BWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOG2E = 1.4426950408889634
LSE_TOL = 1e-4  # the base-2 log-sum-exp, absolute (values near log2(S) + a few)
# the training path: full-width yi-6b cut to 16 of its 32 layers (bf16
# params and grads and f32 AdamW moments are 12 bytes a parameter: 72.7 GB
# at 32 layers, 39.5 GB at 16), a seeded Markov corpus
# (examples/torch_train_lm.py) of 64 sequences of 1024 tokens, 8 steps of
# batch 4, streaming eval over the held-out eighth
TRAIN_LAYERS = 16
TRAIN_SEQS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_WARMUP = 64, 1024, 4, 8, 2
TRAIN_VAL_RATE = 0.125
TRAIN_ATTN = (TRAIN_BATCH, TRAIN_SEQ, 32, 4, 128)  # (B, S, H, Kv, D) of its attention calls
# the full-depth training path: yi-6b at all 32 layers and its published
# widths, trained with adamw8bit (int8 moments: about 6 bytes a parameter of
# state, 36.7 GB in all, where f32 moments would need 72.7), otherwise
# phase_train's workload
FULL_LAYERS = 32
# the 8-bit update against its plain version on the card: one layer slice
# of each of yi-6b's stacked leaf shapes (trailing 128: wq; 11008: w_in and
# w_gate; 4096: w_out) and embed, in bf16 and f32, 3 updates from the zero
# state; p within the CPU tests' tolerance (tests/test_torch_optimizer8.py:
# 1e-5 relative in f32, one bf16 step), m codes and scales equal, v codes
# at most 1 apart on at most 0.1% of entries
OPT8_SHAPES = ((4096, 32, 128), (4096, 11008), (11008, 4096), (64000, 4096))
OPT8_UPDATES = 3
OPT8_RTOL = {"float32": 1e-5, "bfloat16": 2 ** -8}
OPT8_V_SHARE = 1e-3
# the clip at these checks: max_norm 1 against gradients of standard
# deviation 1e-3, so the scale is below 1 on every shape (the slices' norms
# are 4-16) and over the tree (about 78), and the update applies it
OPT8_MAX_NORM = 1.0
# the global norm against its plain version: both sum f32 squares, in
# another order (threads, blocks and partials against torch.sum a layer
# slice at a time), so relative to the norm within 1e-5 (at most a few
# thousand terms a running sum here: errors of order 1e-7)
NORM_RTOL = 1e-5
# the first loss: ln(vocab) plus half the variance of random logits
# (unembed, or mamba2's tied embed, 1/sqrt(d) on a unit-RMS hidden state:
# about 0.5): ln(64000) = 11.07, ln(50280) = 10.83; recurrentgemma's final
# norm scales by 1 + w with w initialised to ones, as in JAX, so its tied
# embed's logits have a variance of about 4: ln(256000) + 2 = 14.45
# gemma2-2b is recurrentgemma's case again (tied embed, final norm 1 + w
# with w ones, so logits of variance 4; its final softcap of 30 bends logits
# of standard deviation 2 by under 0.3%): ln(256000) + 2 = 14.45, whatever
# its sandwich norms do to the residual stream, which the final norm
# rescales; qwen2-7b is yi-6b's (an untied unembed): ln(152064) + 0.5 =
# 12.43
# qwen3-moe-30b-a3b and pixtral-12b are yi-6b's case too: ln(151936) +
# 0.5 = 12.43 and ln(131072) + 0.5 = 12.28
# whisper-tiny's tied embed (1/sqrt(d)) on a final layer norm's output
# (unit variance, weights ones, biases zeros): logits of variance about 1,
# ln(51865) + 0.5 = 11.36
TRAIN_LOSS0_BAND = {"yi-6b": (10.5, 12.5), "mamba2-2.7b": (10.3, 12.3), "recurrentgemma-9b": (13.5, 15.5),
                    "gemma2-2b": (13.5, 15.5), "qwen2-7b": (11.4, 13.4), "qwen3-moe-30b-a3b": (11.4, 13.4),
                    "pixtral-12b": (11.3, 13.3), "whisper-tiny": (10.4, 12.4)}
# mamba2's training path: full-width mamba2-2.7b at all its 64 layers (d
# 2560, 80 heads x 64, N 128, chunk 256, 2,702,296,576 params), trained
# with adamw8bit on phase_train's stream at batch TRAIN_BATCH x TRAIN_SEQ
MAMBA2_LAYERS = 64
# K2's backward against the plain version, ref.ssd_bwd (autograd through
# ref.ssd): each gradient's error relative to its largest element within
# SSD_TOL (tests/test_kernels.py:55-74) at SSD_SWEEP's shapes, each with a
# random initial state and d(final state), and the same bits on a repeated
# call; then the training path's call, (b, s, h, p, n, g, chunk) in bf16
# with the model's decays and no state, timed with the forward beside it
SSD_TRAIN = (TRAIN_BATCH, TRAIN_SEQ, 80, 64, 128, 1, 256)
# recurrentgemma-9b's training path: its published widths (d 4096, 16/1
# heads x 256, window 2048, d_rnn 4096, d_ff 12288, vocab 256000, tied and
# scaled embed), trained with adamw8bit on phase_train's stream, batch and
# schedule, cut in depth to RG_TRAIN_LAYERS of its 38 layers with the
# pattern kept (rec, rec, local, ...: 8 groups and one RG-LRU layer of the
# tail): all 38 run out of the card's memory (about 1.99 GB a layer of
# weights, 8-bit state, gradients and activations: peak 65.66 GB at 20
# layers, 77.59 GB at 26, out of memory at 38 on an H100 80GB HBM3); 25 is
# the most whose peak stays under about 76 GB (PERF.md, Findings)
RG_TRAIN_LAYERS = 25
RG_WINDOW = 2048
RG_TRAIN_ATTN = (TRAIN_BATCH, TRAIN_SEQ, 16, 1, 256)  # (B, S, H, Kv, D) of its local attention calls
RGLRU_TRAIN = (TRAIN_BATCH, TRAIN_SEQ, 4096)  # (B, S, C) of its RG-LRU calls
# K3's backward against ref.rglru_bwd run in float64, element by element:
# |got - want| <= tol + tol * scale with tol RGLRU_TOL at the tests' decays
# and RGLRU_F64_TOL at the model's, as check_rglru holds K3. The scale is
# the size that each gradient's f32 roundings are relative to: g, a sum of
# dh terms, crosses 0, and dlog_a's bracket, a difference of terms up to
# 30 |x| at a = 0.9995, does too. With G the same adjoint chain over |dh|
# and |d(h_last)|: dx's scale is w G, dh0's a_0 G_0 (both the plain
# adjoint of |dh|), dlog_a's G (|a h_{t-1}| + |a^2 x / w|). Scaled by
# |want| alone the kernel's CPU model is 4.8 tolerances off where dlog_a
# crosses 0, and 0.0016 scaled so; on the card expf decays put dh0 1.15
# off (the f32 plain version 1.19). At K3's tile
# edges and the backward's own (8 steps a warp, time blocks of 128), h0
# and d(h_last) each present and absent
RGLRU_BWD_EDGES = ((1, 1, 64, True), (2, 9, 40, False), (1, 127, 64, True), (2, 128, 32, False),
                   (1, 129, 96, True), (3, 255, 100, False), (1, 256, 96, True), (3, 257, 40, False),
                   (1, 845, 4096, True), (2, 1000, 96, False))
# gemma2-2b's paths, at its published widths (d 2304, 26 layers of local /
# global pairs, 8/4 heads x 256, softcap 50 on the attention and 30 on the
# logits, window 4096 on the local layers, d_ff 9216 gelu, vocab 256000,
# tied and scaled embed, sandwich norms), all 26 layers,
# 2,614,341,888 parameters: served from a stream in waves of 4 prompts
# past the window (4500 = 70 x 64 + 20, ragged for every K1 tile), so the
# local layers' prefill binds K1's window and their ring wraps; trained on
# phase_train's stream with adamw8bit
GEMMA2 = "gemma2-2b"
GEMMA2_LAYERS = 26
GEMMA2_PROMPT_LEN = 4500
GEMMA2_WINDOW, GEMMA2_CAP = 4096, 50.0
GEMMA2_TRAIN_ATTN = (TRAIN_BATCH, TRAIN_SEQ, 8, 4, 256)  # (B, S, H, Kv, D) of its training calls
GEMMA2_CONTEXT = (1, 8192, 8, 4, 256)  # its pretraining context, where the window binds
# gemma2-2b with bf16 activations drifts as mamba2 does: its random 26-layer
# stack, whose sandwich norms scale each block's output by 1 + w = 2, grows
# a 1e-3 embedding perturbation to 0.32 of the residual stream in bf16
# (0.087 in f32), and its served tokens trail the teacher-forced forward by
# up to 1.94 and 2.78 (two runs; 0 with f32 activations). Faults planted in
# the decode cache give 1.56 (the last prompt position's K and V zeroed) to
# 12.9 (the sandwich norms dropped), so in bf16 some hide under any slack
# the drift allows: the bf16 wave holds its decoded tokens at twice the
# worst drift seen, and an f32-activation twin holds every token at
# GREEDY_SLACK (scripts/torch_ssm_drift.py --model gemma2 on an H100 80GB
# HBM3 at 700 W; PERF.md, Findings)
GEMMA2_BF16_DRIFT_SLACK = 6.0
# qwen2-7b (d 3584, 28/4 heads x 128 with QKV bias, d_ff 18944, vocab
# 152064, untied), all 28 layers, 7,615,616,512 parameters: served from a
# stream through ContinuousLMEngine as yi-6b is, and trained with adamw8bit
QWEN2 = "qwen2-7b"
QWEN2_LAYERS = 28
QWEN2_TRAIN_ATTN = (TRAIN_BATCH, TRAIN_SEQ, 28, 4, 128)  # GQA 7: the backward's split takes G 1
# mistral-large-123b at its published widths (d 12288, 96/8 heads x 128,
# d_ff 28672, vocab 32768), cut in depth to MISTRAL_LAYERS of its 88
# layers: all 88 are about 246 GB in bf16, three cards' memory; 8 layers
# are 22.1 GB of weights and 1.6 GB of embed and unembed, and init draws
# each stacked leaf in f32 at once (w_in 11.3 GB while drawn). Served from
# a stream through ContinuousLMEngine as yi-6b is.
MISTRAL = "mistral-large-123b"
MISTRAL_LAYERS = 8
# qwen3-moe-30b-a3b at its published widths and all 48 layers (d 2048,
# 32/4 heads x 128, 128 experts top-8 of d_ff 768, vocab 151936, untied;
# 30.53 B parameters, 61.1 GB in bf16) with int8 weights
# (Policy(weights_int8=True): 29.9 GB of codes, the embeddings bf16),
# drawn from SEED one layer at a time, served through ContinuousLMEngine
# as yi-6b is at the published capacity factor of 1.25 (routes drop, and
# a call's capacity counts its own tokens: a prefill's, a decode step's
# 4 slots), then at MOE_PARITY_FACTOR, where no route drops (the phase
# counts them: moe.DROPS), held to the teacher-forced int8 forward
MOE = "qwen3-moe-30b-a3b"
# A token routes to an expert at most once, so a capacity of the call's
# token count drops nothing: a factor of n_experts / top_k (16 here; the
# JAX package's parity tests take 8.0 for reduced configs of 8 experts
# top-2, where 4 already suffices, tests/test_models.py:81-83). At 8.0 the
# random full-width model's router sends most tokens to a few experts: a
# 2 x 512 batch dropped 1539 routes, and the teacher-forced forwards'
# drops put the served tokens 0.5 from their greedy choice.
MOE_PARITY_FACTOR = 16.0
# int8 against bf16 on one batch at MOE_PARITY_FACTOR: the full width cut
# to MOE_BF16_LAYERS of 48 layers (16.2 GB in bf16, 8.8 GB in int8), held
# to tests/test_quantized_serving.py:36-40's total variation (0.05). Its
# argmax agreement (0.9 there, where reduced configs quantize no leaf)
# came to 0.847656 on the H100 (total variation 0.029017): random
# full-width logits over 151936 entries sit close together, and the codes'
# rounding flips near-ties among the router's top-8 too. The bound is set
# below that measurement (PERF.md, Findings).
MOE_BF16_LAYERS = 12
MOE_BF16_BATCH = (2, 512)
INT8_TV_MAX, INT8_AGREE_MIN = 0.05, 0.8
# the fp8 KV cache on the full-width int8 model: FP8_BATCH prompts of
# FP8_PROMPT tokens, prefill and FP8_STEPS teacher-forced decode steps on a
# float8_e4m3fn cache (contiguous, then paged) against the same on an f32
# cache; tests/test_quantized_serving.py:83's first-step agreement
FP8_BATCH, FP8_PROMPT, FP8_STEPS = 4, 512, 16
FP8_FIRST_AGREE_MIN = 0.5
# the paper loop (examples/torch_quickstart.py): copd-mlp at its own
# widths (5 -> 32 -> 4) on the synthetic HCOPD stream (220 records,
# validation 0.2), trained as tests/test_system.py:17 trains it and held
# to that test's gates; 16 requests served by 2 replicas
COPD_BATCH, COPD_EPOCHS, COPD_LR, COPD_REQUESTS = 10, 25, 1e-2, 16
COPD_PRED_TOL = 1e-5  # served probabilities against the port's forward on the CPU
# the transactional round serves logits, which tell the requests apart:
# each committed record must lie this close (relative to the largest
# logit) to exactly one request's logits on the CPU
COPD_LOGIT_TOL = 1e-5
SUP_MAX_STEPS, SUP_CRASH_AFTER = 40, 15  # the supervisor's configuration (tests/test_supervisor.py)
# yi-6b behind InferenceDeployment, as examples/serve_lm.py runs its LM:
# RAW int32 records of 1024 prompt tokens, 8 new tokens each, 2 prompts on
# each of 4 partitions a round, 2 replicas on a controlled clock
DEPLOY_PROMPT, DEPLOY_GEN, DEPLOY_PARTITIONS, DEPLOY_PER_PARTITION = 1024, 8, 4, 2
# qwen3-moe-30b-a3b's training path: its published widths (above), bf16,
# cut in depth to MOE_TRAIN_LAYERS of its 48 layers (a layer holds 623 M
# parameters, 604 M of them in its experts: 6 bytes a parameter of bf16
# weights, bf16 gradients and the 8-bit state make 3.7 GB a layer, and
# the backward keeps about 0.7 GB of MoE activations a layer at batch 4 x
# 1024), trained with adamw8bit on phase_train's stream at the published
# capacity factor of 1.25 (capacity 320 a call: a random router drops
# most routes, and the phase counts them). Its attention calls are
# TRAIN_ATTN's shape, (4, 1024, 32/4, 128). 12 layers peak at 56.7 GB
# allocated and 72.8 GB reserved on an H100 80GB HBM3 (79.18 GiB): 12.2
# GB free, where a layer more takes about 4.5 GB allocated and more
# reserved, so the depth stays 12. 15 ran out of memory in the backward
# (with autograd's adjoint of the combine, before moe._PadGather), fresh
# or after the earlier phases, at 55.7 GB allocated and 18.9-22.0 GB
# reserved but unallocated: the layers' expert gradients, 403 MB each,
# held until the stacked leaf's 5.62 GiB gradient is assembled, pin the
# freed activations' segments (PERF.md, Findings). Each stacked expert
# leaf, (12, 128, 2048, 768), holds
# 2,415,919,104 elements, past 2^31 (from 11 layers on): the 8-bit update
# and the norm are held on it (phase_opt8_past_2_31)
MOE_TRAIN_LAYERS = 12
# the trained first MoE layer's gradients: bf16 twice, the same bits; f32
# against a float64 run routed by the f32 run's top-k ids, each leaf's
# error relative to its largest element (sums of up to 4096 f32 products
# in another order: measured 2.1e-6 at most). The hidden states are
# standard normal plus one shared row of standard deviation
# MOE_GRAD_SHARED: independent rows alone spread over the experts and
# dropped no route at 1.25, where the shared part sends the tokens to
# the same few experts, as the trained model's hidden states do, so that
# routes drop and their adjoint reads the pad row
MOE_GRAD_TOL = 1e-4
MOE_GRAD_BATCH = (TRAIN_BATCH, TRAIN_SEQ)
MOE_GRAD_SHARED = 4.0
# the 8-bit update past element 2^31 of one expert leaf: the last
# OPT8_TAIL_ROWS rows of 768 (3 whole quantization blocks each) against
# the plain version run on them alone, bit for bit, after each of
# OPT8_TAIL_UPDATES clipped updates from the zero state
OPT8_TAIL_ROWS, OPT8_TAIL_UPDATES = 256, 2
# pixtral-12b at its published widths (d 5120, 32/8 heads x 128, d_ff
# 14336, vocab 131072, untied, rope theta 1e9; 12.2 B parameters, 24.5 GB
# in bf16) behind its patch frontend of 1024 positions, whose embeddings
# are drawn as JAX's make_batch draws them (standard normal): served at
# all 40 layers (prefill of the patches and each of PROMPT_LENS's prompts,
# batch 1, then PIXTRAL_DECODE greedy decode steps, each token held to
# the teacher-forced forward); trained with adamw8bit on phase_train's
# stream (each batch of 4 x 1024 tokens behind 4 x 1024 seeded patch
# embeddings: K1 at (4, 2048, 32/8, 128)), cut in depth to
# PIXTRAL_TRAIN_LAYERS of its 40 (6 bytes a parameter is 73 GB whole; 20
# layers peaked at 79.03 GB on an H100 80GB HBM3, about 2.9 GB a layer
# with the activations of 8192 positions; 18 peaked at 71.9 GB;
# PERF.md, Findings)
PIXTRAL = "pixtral-12b"
PIXTRAL_DECODE = 16
PIXTRAL_TRAIN_LAYERS = 18
PIXTRAL_TRAIN_ATTN = (TRAIN_BATCH, TRAIN_SEQ + 1024, 32, 8, 128)
# whisper-tiny at its published widths and full depth (d 384, 6/6 heads x
# 64, 4 encoder and 4 decoder layers, d_ff 1536 gelu, vocab 51865, tied,
# layer norms, learned positions; 37.8 M parameters without its table of
# 32768 learned positions) with openai/whisper's context for it
# (ModelDimensions: n_audio_ctx 1500, n_text_ctx 448). Served: each request
# behind its own 1500 x 384 frame embeddings, drawn standard normal as
# JAX's make_batch draws them; prompts of WHISPER_PROMPTS tokens at batch
# 1, each prefilled and decoded WHISPER_DECODE greedy steps (432 + 16 =
# 448), then WHISPER_BATCH requests of WHISPER_BATCH_PROMPT tokens
# prefilled together and decoded in lockstep; every token held to the
# teacher-forced forward. Trained with adamw8bit from a stream of
# 448-token transcripts at TRAIN_BATCH, each batch behind seeded frames.
# K1's calls: the encoder's bidirectional (B, 1500, 6/6, 64), the
# decoder's causal (B, Sq) and its cross (B, Sq over 1500), no mask
WHISPER = "whisper-tiny"
WHISPER_ENC = 1500
WHISPER_CTX = 448
WHISPER_PROMPTS = (4, 64, 224, 432)
WHISPER_DECODE = 16
WHISPER_BATCH, WHISPER_BATCH_PROMPT = 4, 224
WHISPER_HEADS = (6, 6, 64)  # (H, Kv, D)
WHISPER_LAYERS = 4  # its full depth: 4 decoder layers (and its 4 encoder layers)
# Activation recomputation (Policy.remat). phase_remat_grads: full-width
# layer groups of each kernel path that recomputes, (arch, layers, seq) at
# batch TRAIN_BATCH: yi-6b's two attention groups (K1), mamba2's two SSD
# groups (K2), recurrentgemma's one group of rec, rec, local (K3, and K1
# with the window at head dim 256), qwen3-moe's one layer at
# MOE_PARITY_FACTOR (no route drops), whisper-tiny at full depth (the
# encoder's bidirectional K1, the decoder's causal and cross); the loss and
# every gradient under "full" and "block" equal "none"'s to the bit
REMAT_MODELS = (("yi-6b", 2, TRAIN_SEQ), ("mamba2-2.7b", 2, TRAIN_SEQ), ("recurrentgemma-9b", 3, TRAIN_SEQ),
                ("qwen3-moe-30b-a3b", 1, TRAIN_SEQ), ("whisper-tiny", 4, 448))
# recurrentgemma-9b at all 38 layers under remat "full" (12 recomputed
# groups and a tail of two RG-LRU layers), phase_train's workload with
# adamw8bit: 8,578,412,544 parameters at 6 bytes are 51.5 GB, plus one
# group's activations, the tail's and the loss's logits chunk
RG_REMAT_LAYERS = 38
# pixtral-12b under remat "full", phase_train's pixtral workload: all 40
# layers (12,247,782,400 parameters at 6 bytes are 73.5 GB before any
# activation) fit with the allocator's expandable segments, peak 78.8 GB
# on an H100 80GB HBM3; with fixed segments 34 was the most (peak 68.7
# GB), 35-37 running out with up to 17.55 GiB reserved but unallocated
# (PERF.md, Findings)
PIXTRAL_REMAT_LAYERS = 40
# data parallelism on one card: dp_train_step over an NCCL group of world 1
# (a FileStore rendezvous), full-width yi-6b cut to DP_LAYERS, DP_STEPS
# steps of TRAIN_BATCH x TRAIN_SEQ with adamw8bit, uncompressed (the same
# bits as build_train_step) and int8-compressed
DP_LAYERS = 4
DP_STEPS = 3
# K1 at the calls one rank of a context-parallel mesh makes ("seq": the
# heads do not divide the model axis), each rank's query offset in turn:
# (arch, B, S, H, Kv, D, window, softcap, model axis); a rank holds S / tp
# queries over all S keys, causal
K1_OFFSET_CALLS = (
    ("whisper-tiny", TRAIN_BATCH, WHISPER_CTX, 6, 6, 64, None, None, 4),  # its decoder at model 4
    ("qwen2-7b", TRAIN_BATCH, 1024, 28, 4, 128, None, None, 8),  # 28 heads over 8: 128 queries a rank
    ("gemma2-2b", 1, 8192, 8, 4, 256, 4096, 50.0, 16),  # its context at model 16: the window binds late
)
# training on a mesh (phase_train_mesh): one NCCL rank a card. On one card
# the mesh is (1, 1): full-width yi-6b cut to MESH_LAYERS, MESH_STEPS steps
# of build_train_step(mesh=) against the mesh-free step, to the bit. On
# several cards (1, n): qwen3-moe-30b-a3b at all 48 layers (experts and
# heads split n ways, adamw8bit, the published capacity factor) and
# whisper-tiny ("seq": 6 heads over n), MESH_STEPS steps each
MESH_LAYERS = 16
MESH_STEPS = 2
MESH_MOE_STEPS = 3
MESH_DEADLINE_S = 900.0
MESH_LOSS_RTOL = 1e-3  # whisper-tiny's bf16 losses on the mesh against the mesh-free step's (6e-5)
# whisper-tiny's first f32 step on the mesh against the mesh-free step's:
# every gathered gradient leaf, its largest gap over its largest element
# (2.9e-6 on four H100s: only the order of the sums over ranks differs)
MESH_GRAD_RTOL = 1e-4
# serving on a mesh (serve_mesh_rank: the same spawned ranks, after the
# mesh's training). On one card yi-6b at all 32 layers on the (1, 1) mesh:
# a request of each PROMPT_LENS length through build_prefill_step, then
# MESH_DECODE greedy steps through build_serve_step, the mesh-free steps'
# bits. On n cards (1, n): mistral-large-123b at all 88 layers in bf16
# (heads 96/8, d_ff and vocab split n ways, each rank drawing its blocks a
# layer at a time), MESH_MISTRAL_PROMPTS prompts of MESH_MISTRAL_LEN
# tokens and MESH_DECODE greedy steps each, every token within
# MESH_MISTRAL_SLACK of the mesh forward's teacher-forced logits;
# gemma2-2b at all 26 layers in f32 with seq_axis="model" (the
# flash-decode over its caches' slices) on each of MESH_G2_RUNS, against
# the mesh-free model on rank 0 at MESH_G2_RTOL; qwen3-moe-30b-a3b at all
# 48 layers in int8 (its experts split n ways, placed by quantized_pspecs)
# on a request of each PROMPT_LENS length and MESH_DECODE greedy steps,
# against the mesh-free int8 model on rank 0, fed the mesh's tokens
MESH_DECODE = 16
MESH_MISTRAL_PROMPTS, MESH_MISTRAL_LEN = 4, 1024
# no f32 twin of 123 B parameters fits on four cards, so the served tokens
# are held at the slack of the f32 twins, GREEDY_SLACK: the mesh's bf16
# decode came 0.0469 from its own teacher-forced forward on four H100s
# (the 88 random layers' bf16 drift stays small, unlike gemma2's)
MESH_MISTRAL_SLACK = GREEDY_SLACK
MESH_G2_RUNS = ((8000, 32), (100, 32))  # (prompt, decode steps): slots of rank 3; ranks 1-3 empty
MESH_G2_CACHE = 8192
# of each step's largest logit and each cache leaf's largest element: in
# f32 the mesh sums the row-parallel products in another order (and the
# flash-decode merges per-rank softmax statistics), and random gemma2's 26
# layers amplify rounding (its bf16 drift needs a 6.0 slack); measured on
# four H100s 6.9e-4 (logits) and 5.4e-4 (caches) at 8000 tokens, 9.5e-5
# at 100 (the reduced model on the CPU: 4.5e-6)
MESH_G2_RTOL = 2e-3
# the int8 model on the mesh against the mesh-free one on rank 0, each
# step fed the mesh's greedy token: bf16 row-parallel sums in another order
# flip near-ties among the router's top-8 (and which routes the capacity
# of 1.25 drops), and random logits over 151936 entries sit close together
# (int8 against bf16 agrees on 0.8477 of argmaxes, INT8_AGREE_MIN); measured
# on four H100s: argmax agreement 0.8235 over 68 rows, largest gap 0.4453
MESH_MOE_AGREE_MIN, MESH_MOE_GAP_MAX = 0.7, 1.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


BWD_KERNELS = ("flash_attention", "ssd_scan", "rglru_scan")  # the modules with a backward kernel


def reset_counts(kernels: dict) -> None:
    """Every kernel's launch count to 0 (K1's, K2's and K3's backwards included)."""
    for mod in kernels.values():
        mod.LAUNCHES = 0
    for name in BWD_KERNELS:
        kernels[name].BWD_LAUNCHES = 0


def read_counts(kernels: dict) -> dict:
    out = {name: mod.LAUNCHES for name, mod in kernels.items()}
    for name in BWD_KERNELS:
        out[f"{name}_bwd"] = kernels[name].BWD_LAUNCHES
    return out


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls after one warm-up
    call, with Python's collector held off while it times: a pause of the
    host inside the window leaves the card idle between launches, and the
    events count that as the calls' time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    collecting = gc.isenabled()
    gc.disable()
    try:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
    finally:
        if collecting:
            gc.enable()
    return start.elapsed_time(end) / iters


_FLEX: dict = {}


def flex_library(qt, kt, vt, causal, window, cap, dot=None, q_offset=None) -> dict:
    """The library yardstick of a softcapped call: PyTorch's flex_attention,
    compiled, with ``cap tanh(score / cap)`` as its score_mod and the mask
    as its block mask over the unrepeated K/V (``enable_gqa``): the
    kernel's function. With ``q_offset`` the queries (Sq of them, over the
    Sk keys of ``kt``) sit at positions q_offset.., the offset a captured
    device tensor, so one compiled kernel serves every offset. Its
    forward, or with ``dot`` its backward (autograd of one forward, kept).
    Returns ``{"library_ms", "library"}``, or where it does not compile or
    run, ``{"library_ms": None, "library_refused"}``."""
    import torch

    try:
        import torch._inductor.config as inductor_config
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention

        if "fn" not in _FLEX:
            inductor_config.compile_threads = 1  # no pool of compile workers outliving the call
            _FLEX["fn"] = torch.compile(flex_attention, dynamic=False)
        fn, sq, sk = _FLEX["fn"], qt.shape[2], kt.shape[2]

        if q_offset is None:
            def mask_mod(b, h, q_idx, kv_idx):
                ok = kv_idx <= q_idx if causal else kv_idx >= 0
                return ok & (kv_idx > q_idx - window) if window else ok
        else:
            off = torch.tensor(q_offset, dtype=torch.int32, device="cuda")

            def mask_mod(b, h, q_idx, kv_idx):
                pos = q_idx + off
                ok = kv_idx <= pos if causal else kv_idx >= 0
                return ok & (kv_idx > pos - window) if window else ok

        def score_mod(score, b, h, q_idx, kv_idx):
            return cap * torch.tanh(score / cap)

        block_mask = create_block_mask(mask_mod, None, None, sq, sk, device="cuda")
        if dot is None:
            def call():
                return fn(qt, kt, vt, score_mod=score_mod, block_mask=block_mask, enable_gqa=True)
        else:
            leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
            out = fn(*leaves, score_mod=score_mod, block_mask=block_mask, enable_gqa=True)

            def call():
                return torch.autograd.grad(out, leaves, dot, retain_graph=True)
        return {"library_ms": time_ms(call, 20), "library": "flex_attention, torch.compile, tanh score_mod"}
    except Exception as e:  # noqa: BLE001  (any failure to compile or run is recorded, not fatal)
        why = str(e).strip().splitlines()[0][:300] if str(e).strip() else ""
        return {"library_ms": None, "library_refused": f"flex_attention: {type(e).__name__}: {why}"}


def check_attention(card, fa, ref, b, s, h, kv, d, dtype, causal, window, cap, gen, timed, sk=None):
    """Kernel vs plain version on one input (s queries over ``sk`` keys, s
    where None); with ``timed`` also times both and the library call.
    Raises if they disagree."""
    import torch
    import torch.nn.functional as F

    dt = getattr(torch, dtype)
    sk = s if sk is None else sk
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, sk, kv, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, sk, kv, d), generator=gen, device="cuda").to(dt)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rep = h // kv
    kr, vr = kt.repeat_interleave(rep, dim=1), vt.repeat_interleave(rep, dim=1)

    def kernel():
        return fa.flash_attention(qt, kt, vt, causal=causal, window=window, softcap=cap)

    def plain():
        return ref.mha(qt, kr, vr, causal=causal, window=window, softcap=cap)

    got, want = kernel().float(), plain().float()
    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = TOL[dtype]
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol + tol * want.abs()).all())
    row = {
        "b": b, "s": s, "sk": sk, "h": h, "kv": kv, "d": d, "dtype": dtype, "causal": causal,
        "window": window, "softcap": cap, "max_abs_err": float(err.max()), "tol": tol, "ok": ok,
    }
    if timed:
        row["ms"] = time_ms(kernel, 20)
        row["plain_ms"] = time_ms(plain, 5)
        row["library_ms"] = None
        if cap is not None:  # flex_attention with the cap as its score_mod, where it compiles
            row.update(flex_library(qt, kt, vt, causal, window, cap))
        elif window is None or (causal and window >= s):  # a window of S or more drops nothing
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(qt, kr, vr, is_causal=causal), 20
            )
        else:  # a boolean mask: not the flash backend, which takes no mask
            pos = torch.arange(s, device="cuda")
            keep = (pos[None, :] > pos[:, None] - window) & (pos[None, :] <= pos[:, None] if causal else True)
            row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=keep), 20)
        row["bound_ms"], row["bound_by"] = attention_bound(b, h, kv, s, d, dtype, causal, window, sk)
    print(f"[{card}] flash_attention {json.dumps(row)}", flush=True)
    if not ok:
        raise AssertionError(f"flash_attention disagrees with its plain version: {row}")
    return row


def phase_kernels(card, fa, ref):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    # yi-6b's attention (32 heads over 4 kv heads, hd 128); 1000 is ragged
    for s in (512, 1000, 2048):
        for dtype in ("float32", "bfloat16"):
            rows.append(check_attention(card, fa, ref, 1, s, 32, 4, 128, dtype, True, None, None, gen, False))
    for causal, window, cap in ((False, None, None), (True, 128, None), (True, None, 50.0)):
        for dtype in ("float32", "bfloat16"):
            rows.append(check_attention(card, fa, ref, 1, 1000, 32, 4, 128, dtype, causal, window, cap, gen, False))
    for causal, window in ((True, None), (False, 128)):  # head_dim 64, batch 2, ragged
        for dtype in ("float32", "bfloat16"):
            rows.append(check_attention(card, fa, ref, 2, 777, 8, 2, 64, dtype, causal, window, None, gen, False))
    # recurrentgemma's local attention: 16 heads over 1 kv head, hd 256,
    # window 128 and its own 2048 (whose skipped key tiles matter past S
    # 2048), ragged S; and the f32-activation run's call at the path's shape
    for s, window in ((1000, 128), (2500, 2048)):
        for dtype in ("float32", "bfloat16"):
            rows.append(check_attention(card, fa, ref, 1, s, 16, 1, 256, dtype, True, window, None, gen, False))
    rows.append(check_attention(card, fa, ref, WAVE_REQUESTS, RG_PROMPT_LEN, 16, 1, 256, "float32", True, 2048,
                                None, gen, False))
    # the serving paths' own calls: yi-6b's one per layer per request, bf16,
    # causal; recurrentgemma's one per local layer for the wave, bf16, window 2048
    main = [
        check_attention(card, fa, ref, 1, s, 32, 4, 128, "bfloat16", True, None, None, gen, True)
        for s in PROMPT_LENS
    ]
    rg_main = check_attention(card, fa, ref, WAVE_REQUESTS, RG_PROMPT_LEN, 16, 1, 256, "bfloat16", True, 2048,
                              None, gen, True)
    # the yi-6b deployment's prefill: one partition's prompts a call, bf16, causal
    deploy_main = check_attention(card, fa, ref, DEPLOY_PER_PARTITION, DEPLOY_PROMPT, 32, 4, 128, "bfloat16", True,
                                  None, None, gen, True)
    # gemma2-2b's attention (8 heads over 4 kv heads, hd 256, softcap 50): a
    # ragged S with and without a window that binds, f32 and bf16; then its
    # wave's own calls, timed: its local layers' (window 4096, which S 4500
    # passes) and its global layers'
    for window in (None, 128):
        for dtype in ("float32", "bfloat16"):
            rows.append(check_attention(card, fa, ref, 1, 1000, 8, 4, 256, dtype, True, window, GEMMA2_CAP, gen, False))
    # ... the f32-activation twin's call at the wave's shape (its local layers')
    rows.append(check_attention(card, fa, ref, WAVE_REQUESTS, GEMMA2_PROMPT_LEN, 8, 4, 256, "float32", True,
                                GEMMA2_WINDOW, GEMMA2_CAP, gen, False))
    family = {GEMMA2: [
        check_attention(card, fa, ref, WAVE_REQUESTS, GEMMA2_PROMPT_LEN, 8, 4, 256, "bfloat16", True, window,
                        GEMMA2_CAP, gen, True)
        for window in (GEMMA2_WINDOW, None)
    ]}
    # qwen2-7b's (28 heads over 4, hd 128), mistral's (96 over 8, hd 128) and
    # qwen3-moe's (32 over 4, hd 128) serving calls: one a layer a request,
    # at each prompt length, bf16, causal
    for arch, h, kv in ((QWEN2, 28, 4), (MISTRAL, 96, 8), (MOE, 32, 4)):
        family[arch] = [check_attention(card, fa, ref, 1, s, h, kv, 128, "bfloat16", True, None, None, gen, True)
                        for s in PROMPT_LENS]
    # pixtral-12b's prefills (32 heads over 8, hd 128): its 1024 patch
    # positions before each prompt, one a layer a request, bf16, causal
    family[PIXTRAL] = [check_attention(card, fa, ref, 1, 1024 + s, 32, 8, 128, "bfloat16", True, None, None, gen,
                                       True) for s in PROMPT_LENS]
    return rows, main, rg_main, deploy_main, family


def check_attention_bwd(card, fa, ref, b, s, h, kv, d, dtype, causal, window, gen, timed, cap=None, sk=None):
    """K1's backward kernel against autograd through the plain version on
    one input (s queries over ``sk`` keys, s where None): dq, dk, dv (dk,
    dv summed over each kv group), each held to
    its largest element (BWD_TOL). With ``timed`` also times the kernel,
    the plain backward (autograd of ``ref.mha``, its graph built once) and
    SDPA's backward on pre-repeated K/V as a yardstick where the mask is
    causal alone (a window of S or more drops nothing); where the backend
    refuses the call, ``library_refused`` says why. With a softcap ``cap``
    the yardstick is flex_attention's backward (``flex_library``); where
    that refuses, SDPA's backward without the cap, which is not the same
    function, goes to ``library_sdpa_without_cap_ms``. Raises if they
    disagree."""
    import torch
    import torch.nn.functional as F

    dt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    sk = s if sk is None else sk
    q, k, v, do = randn(b, s, h, d), randn(b, sk, kv, d), randn(b, sk, kv, d), randn(b, s, h, d)
    qt, kt, vt, dot = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), do.transpose(1, 2)
    rep = h // kv
    out, lse = fa.flash_attention(qt, kt, vt, causal=causal, window=window, softcap=cap, return_lse=True)

    def kernel():
        return fa.flash_attention_bwd(qt, kt, vt, out, dot, lse, causal=causal, window=window, softcap=cap)

    leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
    plain_out = ref.mha(leaves[0], leaves[1].repeat_interleave(rep, 1), leaves[2].repeat_interleave(rep, 1),
                        causal=causal, window=window, softcap=cap)

    def plain():
        return torch.autograd.grad(plain_out, leaves, dot, retain_graph=True)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    tol = BWD_TOL[dtype]
    rel = [float((g.float() - w.float()).abs().max() / w.float().abs().max()) for g, w in zip(got, want)]
    ok = all(bool(torch.isfinite(g).all()) for g in got) and max(rel) <= tol
    row = {
        "b": b, "s": s, "sk": sk, "h": h, "kv": kv, "d": d, "dtype": dtype, "causal": causal, "window": window,
        "softcap": cap, "rel_err_dq_dk_dv": rel, "max_abs_err": max(float((g.float() - w.float()).abs().max())
                                                    for g, w in zip(got, want)),
        "tol": tol, "ok": ok,
    }
    if timed:
        row["ms"] = time_ms(kernel, 20)
        row["plain_ms"] = time_ms(plain, 3)
        row["library_ms"] = None
        if cap is not None:
            row.update(flex_library(qt, kt, vt, causal, window, cap, dot))
        if row["library_ms"] is None and (window is None or (causal and window >= s)):
            lq, lk, lv = (t.detach().requires_grad_(True)
                          for t in (qt, kt.repeat_interleave(rep, 1), vt.repeat_interleave(rep, 1)))
            try:
                s_out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
                sdpa_ms = time_ms(lambda: torch.autograd.grad(s_out, (lq, lk, lv), dot, retain_graph=True), 20)
                row["library_sdpa_without_cap_ms" if cap is not None else "library_ms"] = sdpa_ms
            except RuntimeError as e:  # no SDPA backend takes the call
                row["library_refused"] = str(e).splitlines()[0][:300]
        row["bound_ms"], row["bound_by"] = attention_bwd_bound(b, h, kv, s, d, dtype, causal, window, sk)
    print(f"[{card}] flash_attention_bwd {json.dumps(row)}", flush=True)
    if not ok:
        raise AssertionError(f"flash_attention_bwd disagrees with its plain version: {row}")
    return row


def check_attention_bwd_determinism(card, fa, b, s, h, kv, d, gen, calls: int = 3, window: int | None = None,
                                    cap: float | None = None, causal: bool = True, sk: int | None = None):
    """K1's backward called ``calls`` times on one bf16 input (causal unless
    said, s queries over ``sk`` keys): dq, dk and dv the same to the bit
    every time (its GQA split adds partial sums in a fixed order, with no
    atomics). Raises if not."""
    import torch

    sk = s if sk is None else sk
    q, do = (torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16().transpose(1, 2) for _ in "qo")
    k, v = (torch.randn((b, sk, kv, d), generator=gen, device="cuda").bfloat16().transpose(1, 2) for _ in "kv")
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window, softcap=cap, return_lse=True)

    def call():
        return fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window, softcap=cap)

    first = call()
    same = all(all(torch.equal(x, y) for x, y in zip(first, call())) for _ in range(calls - 1))
    row = {"b": b, "s": s, "sk": sk, "h": h, "kv": kv, "d": d, "dtype": "bfloat16", "causal": causal,
           "window": window, "softcap": cap, "calls": calls, "bit_identical": same, "ok": same}
    print(f"[{card}] flash_attention_bwd determinism {json.dumps(row)}", flush=True)
    if not same:
        raise AssertionError(f"flash_attention_bwd gave other bits on the same input: {row}")
    return row


def phase_kernels_bwd(card, fa, ref):
    """K1's backward and its forward's row log-sum-exp, beside the serving
    checks: the training shape in f32 and bf16, head dim 64, a ragged S,
    windows with and without the causal mask, GQA 1 / 2 / 8; the lse
    against torch.logsumexp of the plain scores; the forward's output with
    and without lse, to the bit. Then the training path's own forward and
    backward calls, timed, and the backward's determinism at that shape.
    Then head dim 256 (recurrentgemma's local attention, GQA 16/1): a
    ragged S and a window that binds, in f32 and bf16, its training call
    (RG_TRAIN_ATTN, window RG_WINDOW, which S 1024 does not reach) in f32
    and, forward and backward, timed in bf16, and the backward's bits on
    three calls with and without a window that binds. Then gemma2-2b's
    softcap at head dim 256 and qwen2-7b's GQA 7 (``family``, timed)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    b, s, h, kv, d = TRAIN_ATTN
    rows = [check_attention_bwd(card, fa, ref, b, s, h, kv, d, "float32", True, None, gen, False)]
    for bb, ss, hh, kk, dd, causal, window in ((2, 777, 8, 2, 64, True, None), (1, 1000, 32, 4, 128, True, 128),
                                              (1, 300, 4, 4, 64, False, 50), (2, 513, 8, 1, 128, True, None)):
        for dtype in ("float32", "bfloat16"):
            rows.append(check_attention_bwd(card, fa, ref, bb, ss, hh, kk, dd, dtype, causal, window, gen, False))
    lse_rows = []
    for bb, ss, hh, kk, dd, dtype, window in ((b, s, h, kv, d, "bfloat16", None), (2, 777, 8, 2, 64, "float32", 100)):
        q, k, v = (torch.randn((bb, ss, n, dd), generator=gen, device="cuda").to(getattr(torch, dtype)).transpose(1, 2)
                   for n in (hh, kk, kk))
        out, lse = fa.flash_attention(q, k, v, causal=True, window=window, return_lse=True)
        same = torch.equal(out, fa.flash_attention(q, k, v, causal=True, window=window))
        sc = ref.scores(q, k.repeat_interleave(hh // kk, 1), causal=True, window=window)
        lse_err = float((lse - torch.logsumexp(sc, -1) * LOG2E).abs().max())
        lse_rows.append({"shape": [bb, ss, hh, kk, dd], "dtype": dtype, "window": window, "bit_identical": same,
                         "lse_max_abs_err": lse_err, "tol": LSE_TOL})
        print(f"[{card}] flash_attention lse {json.dumps(lse_rows[-1])}", flush=True)
        if not same or not lse_err <= LSE_TOL:
            raise AssertionError(f"K1's lse output is off: {lse_rows[-1]}")
    fwd_main = check_attention(card, fa, ref, b, s, h, kv, d, "bfloat16", True, None, None, gen, True)
    bwd_main = check_attention_bwd(card, fa, ref, b, s, h, kv, d, "bfloat16", True, None, gen, True)
    rows.append(check_attention_bwd_determinism(card, fa, b, s, h, kv, d, gen))
    # head dim 256: 300 = 4 x 64 + 44 is ragged for every tile; window 100
    # binds inside a 64-key tile; non-causal with a window over 2 kv heads
    for bb, ss, hh, kk, causal, window in ((1, 300, 16, 1, True, None), (2, 777, 16, 1, True, 100),
                                           (1, 300, 8, 2, False, 50)):
        for dtype in ("float32", "bfloat16"):
            rows.append(check_attention_bwd(card, fa, ref, bb, ss, hh, kk, 256, dtype, causal, window, gen, False))
    b, s, h, kv, d = RG_TRAIN_ATTN
    rows.append(check_attention_bwd(card, fa, ref, b, s, h, kv, d, "float32", True, RG_WINDOW, gen, False))
    rg_fwd_main = check_attention(card, fa, ref, b, s, h, kv, d, "bfloat16", True, RG_WINDOW, None, gen, True)
    rg_bwd_main = check_attention_bwd(card, fa, ref, b, s, h, kv, d, "bfloat16", True, RG_WINDOW, gen, True)
    rows.append(check_attention_bwd_determinism(card, fa, b, s, h, kv, d, gen, window=RG_WINDOW))
    rows.append(check_attention_bwd_determinism(card, fa, 2, 777, h, kv, d, gen, window=100))
    # gemma2-2b's softcap (50) at head dim 256: the rows above with it, f32
    # and bf16; its training call (GEMMA2_TRAIN_ATTN, causal; its local
    # layers' window of 4096 is past S 1024) in f32 and, forward and
    # backward, timed in bf16, and timed without the cap beside it (what the
    # cap costs); its pretraining context (GEMMA2_CONTEXT), where the window
    # binds, timed; the backward's bits on three calls
    for bb, ss, hh, kk, causal, window in ((1, 300, 16, 1, True, None), (2, 777, 16, 1, True, 100),
                                           (1, 300, 8, 2, False, 50)):
        for dtype in ("float32", "bfloat16"):
            rows.append(check_attention_bwd(card, fa, ref, bb, ss, hh, kk, 256, dtype, causal, window, gen, False,
                                            cap=GEMMA2_CAP))
    b, s, h, kv, d = GEMMA2_TRAIN_ATTN
    rows.append(check_attention_bwd(card, fa, ref, b, s, h, kv, d, "float32", True, None, gen, False, cap=GEMMA2_CAP))
    family = {
        "gemma2_fwd": check_attention(card, fa, ref, b, s, h, kv, d, "bfloat16", True, None, GEMMA2_CAP, gen, True),
        "gemma2_bwd": check_attention_bwd(card, fa, ref, b, s, h, kv, d, "bfloat16", True, None, gen, True,
                                          cap=GEMMA2_CAP),
        "gemma2_bwd_without_cap": check_attention_bwd(card, fa, ref, b, s, h, kv, d, "bfloat16", True, None, gen, True),
    }
    rows.append(check_attention_bwd_determinism(card, fa, b, s, h, kv, d, gen, cap=GEMMA2_CAP))
    b, s, h, kv, d = GEMMA2_CONTEXT
    family["gemma2_context_bwd"] = check_attention_bwd(card, fa, ref, b, s, h, kv, d, "bfloat16", True, GEMMA2_WINDOW,
                                                       gen, True, cap=GEMMA2_CAP)
    # qwen2-7b's training call: GQA 7, whose split is 1 (7 is prime and
    # above GQA_SPLIT), forward and backward timed, and its bits
    b, s, h, kv, d = QWEN2_TRAIN_ATTN
    family["qwen2_fwd"] = check_attention(card, fa, ref, b, s, h, kv, d, "bfloat16", True, None, None, gen, True)
    family["qwen2_bwd"] = check_attention_bwd(card, fa, ref, b, s, h, kv, d, "bfloat16", True, None, gen, True)
    rows.append(check_attention_bwd_determinism(card, fa, b, s, h, kv, d, gen))
    # pixtral-12b's training call: 1024 patch positions and 1024 tokens,
    # GQA 4, forward and backward timed, and its bits (qwen3-moe's training
    # call is TRAIN_ATTN's shape: the rows above time it)
    b, s, h, kv, d = PIXTRAL_TRAIN_ATTN
    family["pixtral_fwd"] = check_attention(card, fa, ref, b, s, h, kv, d, "bfloat16", True, None, None, gen, True)
    family["pixtral_bwd"] = check_attention_bwd(card, fa, ref, b, s, h, kv, d, "bfloat16", True, None, gen, True)
    rows.append(check_attention_bwd_determinism(card, fa, b, s, h, kv, d, gen))
    return rows, lse_rows, fwd_main, bwd_main, rg_fwd_main, rg_bwd_main, family


def phase_whisper_kernels(card, fa, ref):
    """K1 and K1's backward at whisper-tiny's calls (6/6 heads of 64),
    each held to its plain version at TOL / BWD_TOL and the timed ones
    beside their bounds and SDPA (which takes Sq != Sk and no mask, forward
    and backward). Serving: the encoder's bidirectional call at batch 1 and
    at WHISPER_BATCH, and for each prompt its decoder's causal call and its
    cross call over the 1500 frames, batch 1 and the batched requests'.
    Training: the encoder's (TRAIN_BATCH, 1500) call, the decoder's causal
    (TRAIN_BATCH, 448) and its cross (448 over 1500), forward and
    backward, f32 untimed and bf16 timed. Then Sq > Sk (2000 queries over
    1500 keys) forward and backward, and the backward's bits on three calls
    at the three training calls. Returns (untimed rows, {"serve": forward
    rows, "train_fwd": forward rows, "train_bwd": backward rows})."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    h, kv, d = WHISPER_HEADS
    enc, ctx, tb = WHISPER_ENC, WHISPER_CTX, TRAIN_BATCH
    rows = []
    serve = [check_attention(card, fa, ref, b, enc, h, kv, d, "bfloat16", False, None, None, gen, True)
             for b in (1, WHISPER_BATCH)]
    for b, sq in [(1, n) for n in WHISPER_PROMPTS] + [(WHISPER_BATCH, WHISPER_BATCH_PROMPT)]:
        serve.append(check_attention(card, fa, ref, b, sq, h, kv, d, "bfloat16", True, None, None, gen, True))
        serve.append(check_attention(card, fa, ref, b, sq, h, kv, d, "bfloat16", False, None, None, gen, True,
                                     sk=enc))
    calls = ((enc, False, None), (ctx, True, None), (ctx, False, enc))  # (Sq, causal, Sk): encoder, self, cross
    for sq, causal, sk in calls:
        rows.append(check_attention(card, fa, ref, tb, sq, h, kv, d, "float32", causal, None, None, gen, False, sk=sk))
        rows.append(check_attention_bwd(card, fa, ref, tb, sq, h, kv, d, "float32", causal, None, gen, False, sk=sk))
    train_fwd = [check_attention(card, fa, ref, tb, sq, h, kv, d, "bfloat16", causal, None, None, gen, True, sk=sk)
                 for sq, causal, sk in calls]
    train_bwd = [check_attention_bwd(card, fa, ref, tb, sq, h, kv, d, "bfloat16", causal, None, gen, True, sk=sk)
                 for sq, causal, sk in calls]
    for dtype in ("float32", "bfloat16"):  # more queries than keys
        rows.append(check_attention(card, fa, ref, 2, 2000, h, kv, d, dtype, False, None, None, gen, False, sk=enc))
        rows.append(check_attention_bwd(card, fa, ref, 2, 2000, h, kv, d, dtype, False, None, gen, False, sk=enc))
    for sq, causal, sk in calls:
        rows.append(check_attention_bwd_determinism(card, fa, tb, sq, h, kv, d, gen, causal=causal, sk=sk))
    return rows, {"serve": serve, "train_fwd": train_fwd, "train_bwd": train_bwd}


def load_example(name: str):
    """A module of examples/ (no package) by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_train(card, kernels: dict, arch: str = "yi-6b", layers: int = TRAIN_LAYERS, opt_name: str = "adamw",
                whole: tuple[str, str] | None = None, seq: int = TRAIN_SEQ, remat: str = "none"):
    """Train full-width ``arch`` (``layers`` of its layers, bf16) from a
    stream: a seeded Markov corpus of TRAIN_SEQS x ``seq`` tokens
    ingested as RAW records into a 4-partition topic (validation_rate
    TRAIN_VAL_RATE) and announced for a registered model, configuration
    and deployment; ``TrainingJob(streaming=True)`` with ``opt_name``
    (AdamW or adamw8bit) on a warm-up + cosine schedule takes TRAIN_STEPS
    steps of TRAIN_BATCH and runs its streaming eval. Checks finite,
    falling losses, the first near ln(vocab) (TRAIN_LOSS0_BAND), K1's
    launches forward and backward (one an attention or local-attention
    layer a step, two an ``encdec`` layer, one an encoder layer; the
    forward once more an eval batch), K2's (the same,
    an SSD layer), K3's (the same, an RG-LRU layer), the 8-bit update's (one a leaf a step with adamw8bit, none with AdamW) and
    the norm's (one a leaf and one to finish, a step, with adamw8bit; none
    with AdamW, whose clip is eager), and the registry's result. A patch
    frontend's batches each take TRAIN_BATCH x frontend_len seeded patch
    embeddings (standard normal, bf16) from ``loss_fn``, an encoder's
    TRAIN_BATCH x enc_seq seeded frames; an MoE's dropped
    routes are counted (``moe.DROPS``). Under ``remat`` "full" or "block"
    (``Policy.remat``) each layer group's forward (and every encoder
    layer's) runs once more in each step's backward, and K1's, K2's and
    K3's forward launches count it. It records the bytes earlier phases
    still hold (``base_bytes``) and this phase's own when its first step
    starts (``state_bytes``: the parameters, the optimizer state and the
    fed batches). Returns the phase's numbers and the
    trained first layer's weights, part by part (``{"mixer": {...}, ...}``;
    an encoder's first layer's under "encoder"; with ``whole``, (part,
    leaf), that stacked leaf whole under "whole")."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core import LogConfig, Registry, StreamLog
    from repro_torch.data import ingest
    from repro_torch.data.formats import RawCodec
    from repro_torch.models import moe
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy
    from repro_torch.train import TrainingJob, adamw, adamw8bit, cosine_schedule
    from repro_torch.train.optimizer import tree_leaves

    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
    make_opt = {"adamw": adamw, "adamw8bit": adamw8bit}[opt_name]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    state_bytes = []  # this phase's bytes when its first step starts: the state and the fed batches
    model = StreamModel(cfg, Policy(remat=remat), device="cuda", generator=None)
    log, reg = StreamLog(), Registry()
    spec = reg.register_model(f"{arch}-train")
    dep = reg.deploy(reg.create_configuration([spec.model_id]).config_id, "train")
    corpus = load_example("torch_train_lm").synth_corpus(TRAIN_SEQS, cfg.vocab, seq=seq, seed=SEED)
    log.create_topic("corpus", LogConfig(num_partitions=4))
    msg = ingest(log, "corpus", RawCodec("int32", (seq,), "int32", ()),
                 {"data": corpus, "label": np.zeros(TRAIN_SEQS, np.int32)}, dep.deployment_id,
                 validation_rate=TRAIN_VAL_RATE)
    losses, stamps, eval_calls = [], [], [0]
    patch_gen = torch.Generator(device="cuda").manual_seed(SEED + 9)

    def loss_fn(p, batch):
        if not state_bytes:
            state_bytes.append(torch.cuda.memory_allocated() - base)
        inputs = {"tokens": batch["data"]}
        if cfg.frontend == "patches":  # JAX's make_batch: standard normal patch embeddings
            shape = (batch["data"].shape[0], cfg.frontend_len, cfg.d_model)
            inputs["patch_embeds"] = torch.randn(shape, generator=patch_gen, device="cuda").to(torch.bfloat16)
        if cfg.enc_dec:  # the same law for an encoder's frame embeddings
            shape = (batch["data"].shape[0], cfg.enc_seq, cfg.d_model)
            inputs["frames"] = torch.randn(shape, generator=patch_gen, device="cuda").to(torch.bfloat16)
        loss, metrics = model.loss(p, inputs)
        if torch.is_grad_enabled():
            losses.append(metrics["loss"].detach())
            stamps.append(time.perf_counter())  # the step's start: the job syncs on each step's loss
        else:
            eval_calls[0] += 1
        return loss, metrics

    job = TrainingJob(log, reg, dep.deployment_id, spec.model_id, loss_fn=loss_fn, init_fn=model.init,
                      opt=make_opt(cosine_schedule(3e-4, TRAIN_WARMUP, TRAIN_STEPS)), seed=SEED, device="cuda")
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if cfg.moe is not None:
        moe.DROPS = torch.zeros((), dtype=torch.int64, device="cuda")
    reset_counts(kernels)
    t_start = time.perf_counter()
    try:
        res = job.run(batch_size=TRAIN_BATCH, max_steps=TRAIN_STEPS, streaming=True)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        counts = read_counts(kernels)
        drops = None if moe.DROPS is None else int(moe.DROPS)
    finally:
        moe.DROPS = None
    peak, peak_reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()

    losses = [float(x) for x in losses]
    n_params = sum(p.numel() for p in model.parameters())
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]  # steps 1 .. n-1; step 0 builds
    steady = sorted(step_ms[1:]) if len(step_ms) > 1 else step_ms
    med_ms = steady[len(steady) // 2]
    tokens = TRAIN_BATCH * seq  # the trained tokens (a patch frontend's positions aside)
    n_eval = int(round(TRAIN_SEQS * TRAIN_VAL_RATE)) // min(TRAIN_BATCH, int(round(TRAIN_SEQS * TRAIN_VAL_RATE)))
    n_leaves = len(tree_leaves(model.param_tree()))
    kinds = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    n_attn, n_ssm, n_rec = sum(k in ("attn", "local") for k in kinds), kinds.count("ssm"), kinds.count("rec")
    n_encdec, n_enc = kinds.count("encdec"), cfg.enc_layers if cfg.enc_dec else 0
    assert n_attn + n_encdec + n_ssm + n_rec == cfg.n_layers, f"no training path for {cfg.pattern}"

    def calls(ks: list, enc: int) -> tuple[int, int, int]:
        """K1's, K2's and K3's calls in one forward of the layers ``ks`` and
        ``enc`` encoder layers (an encdec layer's self and cross attention)."""
        return sum(k in ("attn", "local") for k in ks) + 2 * ks.count("encdec") + enc, ks.count("ssm"), ks.count("rec")

    k1 = calls(kinds, n_enc)[0]
    # recomputed each step: the layer groups (not the tail) and the encoder
    again = calls(kinds[:model.n_groups * len(cfg.pattern)], n_enc) if remat in ("block", "full") else (0, 0, 0)
    want = {
        "flash_attention": k1 * (TRAIN_STEPS + n_eval) + again[0] * TRAIN_STEPS, "flash_attention_bwd": k1 * TRAIN_STEPS,
        "ssd_scan": n_ssm * (TRAIN_STEPS + n_eval) + again[1] * TRAIN_STEPS, "ssd_scan_bwd": n_ssm * TRAIN_STEPS,
        "rglru_scan": n_rec * (TRAIN_STEPS + n_eval) + again[2] * TRAIN_STEPS, "rglru_scan_bwd": n_rec * TRAIN_STEPS,
        "adamw8bit": n_leaves * TRAIN_STEPS if opt_name == "adamw8bit" else 0,
        # the clip's norm: a launch a leaf and one to finish, a step
        "grad_norm": (n_leaves + 1) * TRAIN_STEPS if opt_name == "adamw8bit" else 0,
    }
    band = TRAIN_LOSS0_BAND[arch]
    out = {
        "arch": arch, "layers": cfg.n_layers, "remat": remat,
        "kinds": {"attention": n_attn, "ssm": n_ssm, "rec": n_rec, "encdec": n_encdec, "encoder": n_enc},
        "optimizer": opt_name, "leaves": n_leaves, "params": n_params,
        "steps": res.steps, "batch": TRAIN_BATCH, "seq": seq,
        "losses": losses, "eval_loss": res.eval_metrics.get("loss"), "eval_batches": eval_calls[0],
        "step_ms": step_ms, "median_step_ms": med_ms, "tokens_per_s": tokens / (med_ms / 1e3),
        "run_s": t_end - t_start, "setup_s": setup_s, "peak_bytes": peak, "peak_reserved_bytes": peak_reserved,
        "base_bytes": base, "state_bytes": state_bytes[0],
        "launches": counts,
        "want_launches": want, "records": msg.total_msg, "loss_band": list(band),
        "frontend_len": cfg.frontend_len if cfg.frontend == "patches" else 0, "dropped_routes": drops,
    }
    if cfg.moe is not None:  # of TRAIN_STEPS + eval forwards' routes, top_k a token a layer
        routes = cfg.n_layers * cfg.moe.top_k * TRAIN_BATCH * seq * (TRAIN_STEPS + n_eval)
        out["routes"] = routes
        print(f"[{card}] {arch} moe.DROPS: {drops} of {routes} routes dropped at capacity factor "
              f"{cfg.moe.capacity_factor}", flush=True)
    print(f"[{card}] {arch} training: {cfg.n_layers} of {configs.get(arch).n_layers} layers, {n_params} params "
          f"bf16, {opt_name}, remat {remat}, batch {TRAIN_BATCH} x {seq}, {res.steps} steps in "
          f"{t_end - t_start:.3f} s", flush=True)
    print(f"[{card}] losses {['%.4f' % x for x in losses]}, eval {out['eval_loss']}", flush=True)
    print(f"[{card}] step ms {['%.1f' % x for x in step_ms]}, median {med_ms:.3f} ms, "
          f"{out['tokens_per_s']:.1f} tokens/s", flush=True)
    print(f"[{card}] peak device memory {peak} bytes ({peak_reserved} reserved); launches {json.dumps(counts)}",
          flush=True)
    assert len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), losses
    assert band[0] <= losses[0] <= band[1], (losses[0], band)
    assert losses[-1] < losses[0], f"the loss did not fall: {losses}"
    assert np.isfinite(out["eval_loss"]) and eval_calls[0] == n_eval, (out["eval_loss"], eval_calls[0])
    assert counts == want, f"launches {counts}, want {want}"
    results = reg.results_for(dep.deployment_id)
    assert len(results) == 1 and results[0].metrics["loss"] == res.metrics["loss"], results
    trained = {part: {k: v[0].detach().clone() for k, v in sub.items()}
               for part, sub in model.tree["slots"]["s0"].items()}
    if cfg.enc_dec:
        trained["encoder"] = {part: {k: v[0].detach().clone() for k, v in sub.items()}
                              for part, sub in model.tree["encoder"]["slots"]["s0"].items()}
    if whole is not None:
        trained["whole"] = model.tree["slots"]["s0"][whole[0]][whole[1]].detach()
    del job, res, model
    return out, trained


def phase_train_full(card, kernels: dict):
    """phase_train's workload on yi-6b at all FULL_LAYERS layers, trained
    with adamw8bit: its gates, the 8-bit update's kernel launched once a
    leaf a step and the norm kernel once a leaf and once more a step."""
    out, _ = phase_train(card, kernels, layers=FULL_LAYERS, opt_name="adamw8bit")
    return out


def phase_train_mamba2(card, kernels: dict):
    """phase_train's workload on full-width mamba2-2.7b, all MAMBA2_LAYERS
    layers, trained with adamw8bit: its gates, K2 forward a layer a step
    and an eval batch, K2's backward a layer a step, K1 never, the 8-bit
    and norm kernels once a leaf a step (the norm once more). Returns the
    phase's numbers and the trained first layer's weights, part by part."""
    return phase_train(card, kernels, arch="mamba2-2.7b", layers=MAMBA2_LAYERS, opt_name="adamw8bit")


def phase_train_recurrentgemma(card, kernels: dict):
    """phase_train's workload on full-width recurrentgemma-9b, cut in depth
    to RG_TRAIN_LAYERS, trained with adamw8bit: its gates, K3 forward an
    RG-LRU layer a step and an eval batch and K3's backward an RG-LRU
    layer a step, K1 forward (window 2048, head dim 256) a local layer a
    step and an eval batch and its backward a local layer a step, K2
    never, the 8-bit and norm kernels once a leaf a step (the norm once
    more). Returns the phase's numbers and the trained first layer's
    weights, part by part (its RG-LRU mixer among them)."""
    return phase_train(card, kernels, arch="recurrentgemma-9b", layers=RG_TRAIN_LAYERS, opt_name="adamw8bit")


# the dry run (src/repro_torch/launch/dryrun.py) of three of the training
# phases' own cells, TRAIN_BATCH x TRAIN_SEQ with adamw8bit on a (1, 1)
# mesh: yi-6b at FULL_LAYERS (K1, its backward, the 8-bit update, the norm),
# mamba2 at MAMBA2_LAYERS (K2 and its backward's scratch), recurrentgemma
# at RG_TRAIN_LAYERS (K3, its backward, K1 at head dim 256); its
# predictions against what those phases measured: the argument bytes
# within DRYRUN_ARG_RTOL of the bytes the phase held when its first step
# started, argument + temp within DRYRUN_PEAK_RTOL of the phase's peak
DRYRUN_CELLS = (("yi-6b", FULL_LAYERS), ("mamba2-2.7b", MAMBA2_LAYERS), ("recurrentgemma-9b", RG_TRAIN_LAYERS))
DRYRUN_ARG_RTOL = 0.01
DRYRUN_PEAK_RTOL = 0.10
DRYRUN_TIMEOUT_S = 600.0
# run as its own process: the dry run's fake process group is process-wide.
# A cell: [name, arch, layers, kind, batch, seq, mesh shape over ("data",
# "model")]; a train cell takes adamw8bit and no microbatching, every cell
# Policy.for_mesh, as the phases on the card do
DRYRUN_CODE = """
import dataclasses, json, sys, time
import repro_torch.configs as configs
from repro_torch.launch import dryrun
from repro_torch.models.policy import Policy
from repro_torch.train.optimizer import adamw8bit

out = {}
for name, arch, layers, kind, batch, seq, shape in json.loads(sys.argv[1]):
    t0 = time.perf_counter()
    mesh = dryrun.dry_mesh(shape, ("data", "model"))
    cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
    cell = configs.ShapeCell(name, seq, batch, kind)
    kw = {"opt": adamw8bit(3e-4), "microbatches": 1} if kind == "train" else {}
    counter, meta = dryrun.lower_cell(arch, name, mesh, cfg=cfg, shape=cell, policy=Policy.for_mesh(mesh), **kw)
    out[name] = {**dryrun.analyze(counter, mesh, meta), "collectives": counter.collectives,
                 "accounting_s": time.perf_counter() - t0}
print(json.dumps(out))
"""


def start_dryrun(cells: list) -> tuple[subprocess.Popen, float]:
    """The dry run of ``cells`` (DRYRUN_CODE's) in a process of its own on
    the CPU (the meta device needs no card), started at once so that it
    runs beside the card's phases; :func:`dryrun_result` collects it."""
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.Popen([sys.executable, "-c", DRYRUN_CODE, json.dumps(cells)], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def dryrun_result(started: tuple) -> dict:
    """A dry-run process's records by cell name; raises if it failed or
    ran past DRYRUN_TIMEOUT_S."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=max(DRYRUN_TIMEOUT_S - (time.perf_counter() - t0), 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"the dry run did not end within {DRYRUN_TIMEOUT_S} s")
    assert proc.returncode == 0, f"the dry run failed ({proc.returncode}):\n{err[-4000:]}"
    return json.loads(out.strip().splitlines()[-1])


def dryrun_row(card, name: str, pred: dict, state_bytes: int, peak_bytes: int, step_ms: float | None = None) -> dict:
    """One cell's predictions against the card: the argument bytes against
    ``state_bytes`` (the bytes held when the step starts) within
    DRYRUN_ARG_RTOL, argument + temp against ``peak_bytes`` within
    DRYRUN_PEAK_RTOL (each less what earlier work held); with ``step_ms``
    the predicted operations over it as TFLOP/s (printed, no gate)."""
    mem = pred["memory_analysis"]
    args, peak = mem["argument_size_in_bytes"], mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    row = {
        "cell": name, "predicted_argument_bytes": args, "measured_state_bytes": state_bytes,
        "argument_rel_err": (args - state_bytes) / state_bytes, "predicted_peak_bytes": peak,
        "measured_peak_bytes": peak_bytes, "peak_rel_err": (peak - peak_bytes) / peak_bytes,
        "predicted_flops": pred["flops_per_device"], "predicted_bytes": pred["bytes_accessed_per_device"],
        "predicted_transcendentals": pred["transcendentals"], "median_step_ms": step_ms,
        "tflops_per_s": None if step_ms is None else pred["flops_per_device"] / (step_ms / 1e3) / 1e12,
        "kernels": {k: v["calls"] for k, v in pred["kernels"].items()}, "accounting_s": pred["accounting_s"],
    }
    row["ok"] = abs(row["argument_rel_err"]) <= DRYRUN_ARG_RTOL and abs(row["peak_rel_err"]) <= DRYRUN_PEAK_RTOL
    rate = "" if step_ms is None else (f"; {row['predicted_flops']:.4e} flops a step over the median "
                                       f"{step_ms:.3f} ms: {row['tflops_per_s']:.1f} TFLOP/s")
    print(f"[{card}] dry run {name}: arguments {args} predicted, {state_bytes} held "
          f"({row['argument_rel_err']:+.4%}); argument + temp {peak} predicted, peak {peak_bytes} "
          f"({row['peak_rel_err']:+.4%}){rate}; accounted in {row['accounting_s']:.1f} s", flush=True)
    return row


def check_scratch_mirrors(card) -> dict:
    """The meta branches' scratch sizes (what the dry run allocates for a
    kernel) against the C functions the card path asks: K1's backward's
    (``repro_flash_attention_bwd_scratch``) at every GQA ratio of 1-16
    and head dim 64 / 128 / 256 at the training calls' sizes, K2's
    backward's (``repro_ssd_scan_bwd_scratch``) at mamba2's training call
    and others, in bf16 and f32, and the norm's partial sums a leaf
    (``repro_grad_sumsq_parts``). Raises on a difference."""
    import torch

    from repro_torch.kernels import flash_attention as fa, grad_norm as gn, ssd_scan as ss

    _, fa_scratch, _ = fa._bwd_kernel()
    _, ss_scratch, _ = ss._bwd_kernel()
    lib = gn._kernel()
    n = 0
    for dt, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        for d in (64, 128, 256):
            for h, kv in ((32, 4), (16, 1), (28, 4), (8, 4), (6, 6), (96, 8), (12, 4), (5, 1)):
                for b, s, sk in ((4, 1024, 1024), (1, 777, 1500)):
                    want = fa_scratch(code, b, h, kv, s, sk, d)
                    got = fa._bwd_scratch_floats(dt, b, h, kv, s, sk, d)
                    assert got == want, ("flash_attention_bwd scratch", dt, b, h, kv, s, sk, d, got, want)
                    n += 1
        for b, h, g, s, p, nn, q in ((4, 80, 1, 1024, 64, 128, 256), (2, 80, 1, 1000, 64, 128, 256),
                                     (3, 24, 2, 500, 32, 64, 128), (1, 6, 3, 77, 16, 16, 16)):
            want, got = ss_scratch(b, h, g, s, p, nn, q, code), ss._bwd_scratch_floats(b, h, g, s, p, nn, q, dt)
            assert got == want, ("ssd_scan_bwd scratch", dt, b, h, g, s, p, nn, q, got, want)
            n += 1
    for numel in (1, 4096, 65535, 65536, 65537, 4096 * 11008, 32 * 4096 * 11008, 64000 * 4096, 1 << 31):
        want, got = lib.repro_grad_sumsq_parts(numel), gn._parts(numel)
        assert got == want, ("grad_norm parts", numel, got, want)
        n += 1
    print(f"[{card}] dry run: the meta branches' scratch sizes equal the card path's at {n} shapes", flush=True)
    return {"checked": n}


def phase_dryrun(card, started: tuple, measured: dict) -> dict:
    """The dry run's predictions for DRYRUN_CELLS (``start_dryrun``'s
    process) against the training phases that ran those cells on the card
    (``measured``: arch -> phase_train's numbers), with no rerun
    (:func:`dryrun_row`: the bytes the phase held when its first step
    started, its peak, its median step), and the meta branches' scratch
    sizes against the card path's. Raises on a miss or when the dry run
    fails."""
    preds = dryrun_result(started)
    rows = {}
    for arch, layers in DRYRUN_CELLS:
        got = measured[arch]
        assert got["layers"] == layers and got["optimizer"] == "adamw8bit", (arch, got["layers"], got["optimizer"])
        rows[arch] = dryrun_row(card, f"{arch} {layers} layers", preds[arch], got["state_bytes"],
                                got["peak_bytes"] - got["base_bytes"], got["median_step_ms"])
    result = {"cells": rows, "scratch": check_scratch_mirrors(card), "wall_s": time.perf_counter() - started[1]}
    bad = {a: r for a, r in rows.items() if not r["ok"]}
    assert not bad, f"the dry run missed the card: {bad}"
    return result


def phase_train_moe_grads(card, trained: dict) -> dict:
    """The trained qwen3-moe model's first MoE layer (``trained["moe"]``:
    its f32 router and bf16 experts) on a batch of MOE_GRAD_BATCH random
    hidden states (a shared row among them: routes drop) at the published
    capacity factor: the gradients of a fixed random projection of
    ``moe_ffn``'s output plus its aux loss with respect to x, the router
    and the three expert leaves. In bf16 (the
    training path's dtypes) computed twice: the same bits. In f32 against
    the same function run in float64 and routed by the f32 run's top-k ids
    (``moe_routes``): each leaf's error relative to its largest element
    within MOE_GRAD_TOL. Times one bf16 forward + backward of the layer."""
    import math

    import torch

    from repro_torch import configs
    from repro_torch.models import moe

    mp = configs.get(MOE).moe
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    b, s = MOE_GRAD_BATCH
    d = trained["moe"]["w_in"].shape[1]
    shared = torch.randn((d,), generator=gen, device="cuda") * MOE_GRAD_SHARED
    x = (torch.randn((b, s, d), generator=gen, device="cuda") + shared).to(torch.bfloat16)
    proj = torch.randn((b, s, d), generator=gen, device="cuda")

    def grads(dtype, routes=None):
        leaves = {"x": x, **trained["moe"]}
        t = {k: (v if dtype is None else v.to(dtype)).detach().requires_grad_(True) for k, v in leaves.items()}
        out, aux = moe.moe_ffn({k: t[k] for k in trained["moe"]}, t["x"], mp, routes=routes)
        g = torch.autograd.grad((out * proj.to(out.dtype)).sum() + aux, list(t.values()))
        return dict(zip(t, g))

    moe.DROPS = torch.zeros((), dtype=torch.int64, device="cuda")
    try:
        first = grads(None)
        drops = int(moe.DROPS)
    finally:
        moe.DROPS = None
    again = grads(None)
    torch.cuda.synchronize()
    same = all(torch.equal(first[k], again[k]) for k in first)
    ms = time_ms(lambda: grads(None), 3)
    del first, again
    routes = moe.moe_routes({k: v.float() for k, v in trained["moe"].items()}, x.float(), mp)
    got = grads(torch.float32)
    want = grads(torch.float64, routes)
    torch.cuda.synchronize()
    rel = {k: float((got[k].double() - want[k]).abs().max() / want[k].abs().max()) for k in got}
    row = {"shape": [b, s, d], "experts": mp.n_experts, "top_k": mp.top_k, "capacity_factor": mp.capacity_factor,
           "capacity": moe._capacity(mp, b * s), "bf16_bit_identical": same, "f32_vs_f64_rel_err": rel,
           "tol": MOE_GRAD_TOL, "dropped_routes": drops, "routes": b * s * mp.top_k, "bf16_fwd_bwd_ms": ms}
    print(f"[{card}] {MOE} first MoE layer gradients {json.dumps(row)}", flush=True)
    assert same, f"the MoE's bf16 gradients changed on a repeated call: {row}"
    assert drops > 0, f"no route dropped: the pad row's adjoint went unchecked {row}"
    assert all(math.isfinite(e) and e <= MOE_GRAD_TOL for e in rel.values()), row
    return row


def phase_opt8_past_2_31(card, leaf) -> dict:
    """The 8-bit update and the norm on one whole stacked expert leaf of the
    trained tree (``leaf``, bf16, past 2^31 elements): OPT8_TAIL_UPDATES
    clipped updates from the zero state with seeded bf16 gradients of
    standard deviation 1e-3, each followed by the last OPT8_TAIL_ROWS
    trailing rows held bit for bit against ``ref.adamw8bit_update`` run on
    those rows alone (p, m codes and scales, v codes and scales); the
    norm kernel's norm of each gradient held to a float64 sum taken in
    chunks (NORM_RTOL). Then times the update (kernel, plain version, the
    bound) and the norm (kernel, ``torch.linalg.vector_norm``, the bound)
    on the leaf."""
    import torch

    from repro_torch.kernels import adamw8bit as k8
    from repro_torch.kernels import grad_norm as gn
    from repro_torch.kernels import ref
    from repro_torch.train import adamw8bit

    p = leaf
    n = p.shape[-1]
    rows = p.numel() // n
    first_row = rows - OPT8_TAIL_ROWS
    assert p.numel() > 2 ** 31 and first_row * n >= 2 ** 31, (tuple(p.shape), first_row)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    st = adamw8bit(1e-3).init({"p": p})
    state = [st["m"]["p"]["codes"], st["m"]["p"]["scales"], st["v"]["p"]["codes"], st["v"]["p"]["scales"]]

    def tail(t):
        return t.reshape((rows,) + tuple(t.shape[p.dim() - 1:]))[first_row:]

    want = [tail(t).clone() for t in (p, *state)]
    checks, launches0, norm_launches0 = [], k8.LAUNCHES, gn.LAUNCHES
    with torch.no_grad():
        for step in range(1, OPT8_TAIL_UPDATES + 1):
            g = torch.randn(p.shape, generator=gen, device="cuda", dtype=torch.bfloat16).mul_(1e-3)
            norm, scale = gn.global_norm([g], OPT8_MAX_NORM)
            f64 = torch.zeros((), dtype=torch.float64, device="cuda")
            for chunk in g.view(-1).split(1 << 28):
                f64 += chunk.double().square().sum()
            f64 = f64.sqrt()
            g_tail = tail(g).clone()
            k8.adamw8bit_update(p, g, *state, **opt8_scalars(step), clip_scale=scale)
            ref.adamw8bit_update(want[0], g_tail, *want[1:], **opt8_scalars(step), clip_scale=scale)
            torch.cuda.synchronize()
            equal = {name: bool(torch.equal(tail(got), w)) for name, got, w in zip(
                ("p", "m_codes", "m_scales", "v_codes", "v_scales"), (p, *state), want)}
            checks.append({"step": step, "bit_equal": equal, "norm": float(norm), "norm_f64": float(f64),
                           "norm_rel_err": float((norm.double() - f64).abs() / f64), "scale": float(scale)})
            del g_tail
        bound_ms, bound_by = opt8_bound([p])
        norm_bound_ms, norm_bound_by = norm_bound([g])
        kw = {**opt8_scalars(OPT8_TAIL_UPDATES + 1), "clip_scale": scale}
        out = {
            "shape": list(p.shape), "elements": p.numel(), "tail_rows": OPT8_TAIL_ROWS, "first_tail_element": first_row * n,
            "checks": checks, "check_launches": k8.LAUNCHES - launches0, "norm_check_launches": gn.LAUNCHES - norm_launches0,
            "ms": time_ms(lambda: k8.adamw8bit_update(p, g, *state, **kw), 3),
            "plain_ms": time_ms(lambda: ref.adamw8bit_update(p, g, *state, **kw), 1),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "norm_ms": time_ms(lambda: gn.global_norm([g], OPT8_MAX_NORM), 5),
            "norm_plain_ms": time_ms(lambda: ref.global_norm([g], OPT8_MAX_NORM), 1),
            "norm_library_ms": time_ms(lambda: torch.linalg.vector_norm(g), 5),
            "norm_bound_ms": norm_bound_ms, "norm_bound_by": norm_bound_by,
        }
    out["ok"] = all(all(c["bit_equal"].values()) and c["norm_rel_err"] <= NORM_RTOL for c in checks)
    print(f"[{card}] adamw8bit and grad_norm past 2^31 on a {tuple(p.shape)} expert leaf ({p.numel()} elements, "
          f"rows from element {first_row * n}): {json.dumps(checks)}; update {out['ms']:.3f} ms (plain "
          f"{out['plain_ms']:.3f}, bound {bound_ms:.3f}), norm {out['norm_ms']:.3f} ms (vector_norm "
          f"{out['norm_library_ms']:.3f}, bound {norm_bound_ms:.3f})", flush=True)
    assert out["ok"], f"the 8-bit update or the norm past 2^31 disagrees: {checks}"
    del g, state, want
    return out


def phase_serve_pixtral(card, kernels: dict) -> dict:
    """pixtral-12b at its published widths and all 40 layers, bf16 weights
    from SEED: for each of PROMPT_LENS's prompts (seeded tokens, batch 1)
    behind frontend_len seeded patch embeddings (standard normal, as JAX's
    make_batch draws them), ``prefill`` of the patches and the prompt,
    then PIXTRAL_DECODE greedy ``decode_step``s. Checks K1 launched once a
    layer a prefill and never in decode, every token finite and in the
    vocab, and each within GREEDY_SLACK of the greedy choice of the
    teacher-forced ``forward`` over the patches, the prompt and the tokens
    before it. Returns the numbers."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy

    t0 = time.perf_counter()
    cfg = configs.get(PIXTRAL)
    model = StreamModel(cfg, Policy(), device="cuda", generator=SEED)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    reqs = [(torch.from_numpy(rng.integers(0, cfg.vocab, n).astype(np.int64)).cuda(),
             torch.randn((1, cfg.frontend_len, cfg.d_model), generator=gen, device="cuda")) for n in PROMPT_LENS]
    model.prefill(reqs[0][0][None, :64], 64 + cfg.frontend_len, patch_embeds=reqs[0][1])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    prefill_ms, decode_s, served = [], 0.0, []
    for prompt, patches in reqs:
        t_a = time.perf_counter()
        logits, cache = model.prefill(prompt[None], cfg.frontend_len + len(prompt) + PIXTRAL_DECODE,
                                      patch_embeds=patches)
        tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        toks = [tok]
        for _ in range(PIXTRAL_DECODE):
            step_logits, cache = model.decode_step(cache, tok)
            tok = step_logits[:, 0].argmax(-1)[:, None]
            toks.append(tok)
        gen_toks = torch.cat(toks, dim=1)[0]
        torch.cuda.synchronize()
        decode_s += time.perf_counter() - t_b
        prefill_ms.append((t_b - t_a) * 1e3)
        served.append(gen_toks)
        del cache
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    worst = 0.0
    for (prompt, patches), gen_toks in zip(reqs, served):
        assert ((gen_toks >= 0) & (gen_toks < cfg.vocab_padded)).all(), gen_toks
        seq = torch.cat([prompt, gen_toks[:-1]])
        logits = model(seq[None], patches)[0, cfg.frontend_len + len(prompt) - 1:]
        assert bool(torch.isfinite(logits).all())
        gap = logits.max(-1).values - logits.gather(-1, gen_toks[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        del logits
    want = {name: 0 for name in counts}
    want["flash_attention"] = cfg.n_layers * len(reqs)
    decode_tokens = len(reqs) * PIXTRAL_DECODE
    out = {
        "arch": PIXTRAL, "layers": cfg.n_layers, "params": n_params, "frontend_len": cfg.frontend_len,
        "prompt_lens": list(PROMPT_LENS), "decode_steps": PIXTRAL_DECODE, "prefill_ms": prefill_ms,
        "decode_tokens": decode_tokens, "decode_s": decode_s, "decode_tokens_per_s": decode_tokens / decode_s,
        "peak_bytes": peak, "setup_s": setup_s, "launches": counts["flash_attention"], "all_launches": counts,
        "greedy_worst_gap": worst, "slack": GREEDY_SLACK,
    }
    print(f"[{card}] {PIXTRAL} full width: {cfg.n_layers} layers, {n_params} params bf16, {cfg.frontend_len} patch "
          f"positions, set-up {setup_s:.3f} s; prefill ms {['%.3f' % x for x in prefill_ms]} at "
          f"{[cfg.frontend_len + n for n in PROMPT_LENS]} positions; decode {decode_tokens} tokens in {decode_s:.4f} s "
          f"({out['decode_tokens_per_s']:.3f} tokens/s); peak {peak} bytes; launches {json.dumps(counts)}; greedy gap "
          f"worst {worst:.4f}", flush=True)
    assert counts == want, f"launches {counts}, want {want}"
    assert worst <= GREEDY_SLACK, f"served tokens trail the forward's greedy choice by {worst}"
    del model
    return out


def phase_serve_whisper(card, kernels: dict) -> dict:
    """whisper-tiny at its published widths and full depth, bf16 weights
    from SEED, each request behind its own WHISPER_ENC x d seeded frame
    embeddings (standard normal, as JAX's make_batch draws them): for each
    of WHISPER_PROMPTS's prompts (seeded tokens, batch 1) ``prefill`` of
    the frames and the prompt, then WHISPER_DECODE greedy ``decode_step``s
    (the learned position from the cache); then WHISPER_BATCH requests of
    WHISPER_BATCH_PROMPT tokens prefilled together and decoded in lockstep.
    Checks K1 launched 12 times a prefill (the encoder's 4 bidirectional
    calls, the decoder's 4 causal and 4 cross calls) and never in decode,
    every token finite and in the vocab and within GREEDY_SLACK of the
    greedy choice of the teacher-forced ``forward`` over the frames, the
    prompt and the tokens before it. Returns the numbers."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy

    t0 = time.perf_counter()
    cfg = configs.get(WHISPER)
    model = StreamModel(cfg, Policy(), device="cuda", generator=SEED)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)

    def frames(b):
        return torch.randn((b, cfg.enc_seq, cfg.d_model), generator=gen, device="cuda")

    reqs = [(torch.from_numpy(rng.integers(0, cfg.vocab, (1, n)).astype(np.int64)).cuda(), frames(1))
            for n in WHISPER_PROMPTS]
    reqs.append((torch.from_numpy(rng.integers(0, cfg.vocab, (WHISPER_BATCH, WHISPER_BATCH_PROMPT))
                                  .astype(np.int64)).cuda(), frames(WHISPER_BATCH)))
    model.prefill(reqs[1][0], WHISPER_CTX, frames=reqs[1][1])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    prefill_ms, decode_s, served, per_prefill = [], [], [], []
    for prompt, fr in reqs:
        before = kernels["flash_attention"].LAUNCHES
        t_a = time.perf_counter()
        logits, cache = model.prefill(prompt, prompt.shape[1] + WHISPER_DECODE, frames=fr)
        tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        per_prefill.append(kernels["flash_attention"].LAUNCHES - before)
        toks = [tok]
        for _ in range(WHISPER_DECODE):
            step_logits, cache = model.decode_step(cache, tok)
            tok = step_logits[:, 0].argmax(-1)[:, None]
            toks.append(tok)
        gen_toks = torch.cat(toks, dim=1)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t_b)
        prefill_ms.append((t_b - t_a) * 1e3)
        served.append(gen_toks)
        del cache
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    worst = 0.0
    for (prompt, fr), gen_toks in zip(reqs, served):
        assert ((gen_toks >= 0) & (gen_toks < cfg.vocab_padded)).all(), gen_toks
        seq = torch.cat([prompt, gen_toks[:, :-1]], dim=1)
        logits = model(seq, frames=fr)[:, prompt.shape[1] - 1:]
        assert bool(torch.isfinite(logits).all())
        gap = logits.max(-1).values - logits.gather(-1, gen_toks[..., None])[..., 0]
        worst = max(worst, float(gap.max()))
        del logits
    calls = cfg.enc_layers + 2 * cfg.n_layers  # K1 a prefill: the encoder's, the decoder's self and cross
    want = {name: 0 for name in counts}
    want["flash_attention"] = calls * len(reqs)
    decode_tokens = [prompt.shape[0] * WHISPER_DECODE for prompt, _ in reqs]
    out = {
        "arch": WHISPER, "layers": [cfg.enc_layers, cfg.n_layers], "params": n_params, "frames": cfg.enc_seq,
        "prompt_lens": list(WHISPER_PROMPTS) + [WHISPER_BATCH_PROMPT], "batch": [1] * len(WHISPER_PROMPTS)
        + [WHISPER_BATCH], "decode_steps": WHISPER_DECODE, "prefill_ms": prefill_ms, "decode_s": decode_s,
        "decode_tokens": decode_tokens, "decode_tokens_per_s": [n / t for n, t in zip(decode_tokens, decode_s)],
        "peak_bytes": peak, "setup_s": setup_s, "launches": counts["flash_attention"], "launches_per_prefill":
        per_prefill, "all_launches": counts, "greedy_worst_gap": worst, "slack": GREEDY_SLACK,
    }
    print(f"[{card}] {WHISPER} full width: {cfg.enc_layers} + {cfg.n_layers} layers, {n_params} params bf16, "
          f"{cfg.enc_seq} frames, set-up {setup_s:.3f} s; prefill ms (the encoder included) "
          f"{['%.3f' % x for x in prefill_ms]} at batch x prompt {list(zip(out['batch'], out['prompt_lens']))}; "
          f"decode tokens/s {['%.1f' % x for x in out['decode_tokens_per_s']]}; peak {peak} bytes; K1 a prefill "
          f"{per_prefill}; launches {json.dumps(counts)}; greedy gap worst {worst:.4f}", flush=True)
    assert counts == want and per_prefill == [calls] * len(reqs), f"launches {counts} {per_prefill}, want {want}"
    assert worst <= GREEDY_SLACK, f"served tokens trail the forward's greedy choice by {worst}"
    del model
    return out


def phase_whisper_grads(card, ref, trained: dict) -> dict:
    """The trained whisper-tiny's first encoder layer and first decoder
    layer: the gradients of a fixed random projection of each attention's
    output with respect to random inputs and the weights, through K1
    forward + backward, against the same computation through the plain
    version on the card: the encoder's bidirectional self attention at
    (TRAIN_BATCH, 1500), the decoder's causal self attention at
    (TRAIN_BATCH, 448) and its cross attention of 448 queries over 1500
    encoder states. Each leaf's error relative to its largest element,
    within K1's bf16 tolerance."""
    import math

    import torch

    from repro_torch import configs
    from repro_torch.kernels.ops import attention_op
    from repro_torch.models import layers as L

    cfg = configs.get(WHISPER)
    h, kv, _ = WHISPER_HEADS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def one(tag, mixer, kind, sq, sk):
        ap = cfg.attn_params(kind)
        leaves = {"x": randn(TRAIN_BATCH, sq, cfg.d_model), **{k: mixer[k] for k in ("wq", "wk", "wv", "wo")}}
        if ap.cross:
            leaves["src"] = randn(TRAIN_BATCH, sk, cfg.d_model)
        proj = randn(TRAIN_BATCH, sq, cfg.d_model)
        causal = ap.causal and not ap.cross

        def grads(kernel: bool):
            t = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
            src = t["src"] if ap.cross else t["x"]
            q, k, v = L._proj(t["x"], t["wq"]), L._proj(src, t["wk"]), L._proj(src, t["wv"])
            if kernel:
                out = attention_op(q, k, v, causal=causal)
            else:
                qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                out = ref.mha(qt, kt.repeat_interleave(h // kv, 1), vt.repeat_interleave(h // kv, 1),
                              causal=causal).transpose(1, 2)
            y = L._out_proj(out, t["wo"])
            g = torch.autograd.grad((y.float() * proj.float()).sum(), list(t.values()))
            return dict(zip(t, g))

        got, want = grads(True), grads(False)
        torch.cuda.synchronize()
        rel = {k: float((got[k].float() - want[k].float()).abs().max() / want[k].float().abs().max()) for k in got}
        row = {"layer": tag, "kind": kind, "shape": [TRAIN_BATCH, sq, sk, h, kv], "causal": causal, "rel_err": rel,
               "tol": BWD_TOL["bfloat16"]}
        print(f"[{card}] {WHISPER} {tag} gradients, kernel vs plain {json.dumps(row)}", flush=True)
        assert all(math.isfinite(e) and e <= BWD_TOL["bfloat16"] for e in rel.values()), row
        return row

    return {"rows": [
        one("encoder layer 0 self", trained["encoder"]["mixer"], "bidir", WHISPER_ENC, WHISPER_ENC),
        one("decoder layer 0 self", trained["mixer"], "attn", WHISPER_CTX, WHISPER_CTX),
        one("decoder layer 0 cross", trained["cross"], "cross", WHISPER_CTX, WHISPER_ENC),
    ]}


def phase_remat_grads(card, kernels: dict) -> dict:
    """REMAT_MODELS' full-width layer groups in bf16 from SEED, each on one
    seeded batch (an encoder's frames drawn standard normal): the loss and
    every gradient leaf by ``torch.autograd.grad`` under ``Policy.remat``
    "none", "full" and "block", held to the bit. Prints each mode's K1, K2
    and K3 launches forward and backward, its peak memory and forward +
    backward time, and how many tensors and bytes "block"'s selective
    policy saved (``model.block_policy``'s MUST_SAVE outputs)."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy
    from repro_torch.train.optimizer import tree_leaves

    out = {}
    block_policy = model_mod.block_policy
    for arch, layers, seq in REMAT_MODELS:
        cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=MOE_PARITY_FACTOR))
        model = StreamModel(cfg, Policy(), device="cuda", generator=SEED)
        model.requires_grad_(True)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
        batch = {"tokens": torch.randint(0, cfg.vocab, (TRAIN_BATCH, seq), generator=gen, device="cuda")}
        if cfg.enc_dec:
            batch["frames"] = torch.randn((TRAIN_BATCH, cfg.enc_seq, cfg.d_model), generator=gen,
                                          device="cuda").to(torch.bfloat16)
        paths = ["/".join(p) for p in tree_paths(model.param_tree())]
        rows, first = {}, None
        for mode in ("none", "full", "block"):
            model.policy = dataclasses.replace(model.policy, remat=mode)
            saved = [0, 0]

            def recording(ctx, op, *args, **kwargs):
                policy = block_policy(ctx, op, *args, **kwargs)
                # the forward's saves (older torch asks the policy again in
                # the recompute); mm(a, b) / addmm(c, a, b)
                if policy == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                    saved[0] += 1
                    saved[1] += args[-2].shape[0] * args[-1].shape[1] * args[-2].element_size()
                return policy

            model_mod.block_policy = recording
            moe.DROPS = torch.zeros((), dtype=torch.int64, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(kernels)
            t0 = time.perf_counter()
            try:
                params = model.param_tree()
                loss, _ = model.loss(params, batch)
                grads = torch.autograd.grad(loss, tree_leaves(params))
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                counts = read_counts(kernels)
                drops = int(moe.DROPS)
            finally:
                model_mod.block_policy = block_policy
                moe.DROPS = None
            row = {"loss": float(loss), "ms": ms, "peak_bytes": torch.cuda.max_memory_allocated(),
                   "launches": {k: counts[k] for k in ("flash_attention", "flash_attention_bwd", "ssd_scan",
                                                       "ssd_scan_bwd", "rglru_scan", "rglru_scan_bwd")},
                   "dropped_routes": drops, "block_saved_tensors": saved[0], "block_saved_bytes": saved[1]}
            if first is None:
                first = (loss.detach(), grads)
            else:
                row["loss_bits_equal"] = bool(torch.equal(loss.detach(), first[0]))
                row["unequal_leaves"] = [p for p, a, b in zip(paths, grads, first[1]) if not torch.equal(a, b)]
            rows[mode] = row
            del loss, grads
        n_groups, tail = model.n_groups, model.tail
        out[arch] = {"layers": layers, "seq": seq, "groups": n_groups, "tail": tail, "leaves": len(paths),
                     "modes": rows}
        print(f"[{card}] remat {arch} ({layers} layers: {n_groups} groups, tail {tail}; batch {TRAIN_BATCH} x "
              f"{seq}) {json.dumps(rows)}", flush=True)
        del model, first
        gc.collect()
        torch.cuda.empty_cache()
        for mode in ("full", "block"):
            r = rows[mode]
            assert r["loss_bits_equal"] and not r["unequal_leaves"], f"{arch} {mode}: {r}"
            assert all(r["launches"][k] >= rows["none"]["launches"][k] for k in r["launches"]), (arch, rows)
        assert all(r["dropped_routes"] == 0 for r in rows.values()), (arch, rows)
        assert rows["block"]["block_saved_tensors"] > 0 and rows["full"]["block_saved_tensors"] == 0, rows
    return out


def phase_train_recurrentgemma_remat(card, kernels: dict) -> dict:
    """phase_train's workload on full-width recurrentgemma-9b at all
    RG_REMAT_LAYERS layers under remat "full", trained with adamw8bit: its
    gates (finite, falling losses), K3 and K1 forward once more for each
    grouped layer a step (the two tail layers are not recomputed)."""
    out, _ = phase_train(card, kernels, arch="recurrentgemma-9b", layers=RG_REMAT_LAYERS, opt_name="adamw8bit",
                         remat="full")
    return out


def phase_train_pixtral_remat(card, kernels: dict) -> dict:
    """phase_train's pixtral workload (each batch behind 1024 seeded patch
    embeddings a sequence) at PIXTRAL_REMAT_LAYERS of its 40 layers under
    remat "full", trained with adamw8bit, the caching allocator on
    expandable segments for this phase alone (fixed segments fragment past
    34 layers)."""
    import torch

    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        out, _ = phase_train(card, kernels, arch=PIXTRAL, layers=PIXTRAL_REMAT_LAYERS, opt_name="adamw8bit",
                             remat="full")
    finally:
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    return out


def phase_train_dp(card, kernels: dict) -> dict:
    """``dp_train_step`` on one card: an NCCL process group of world 1 (a
    FileStore rendezvous in a temporary directory), full-width yi-6b cut to
    DP_LAYERS, DP_STEPS steps of one seeded TRAIN_BATCH x TRAIN_SEQ batch
    with adamw8bit, each run from the same seeded state. Uncompressed: the
    same parameter bits and losses as build_train_step's (the f32 mean of
    one rank is its gradient). Compressed (int8): finite, falling losses.
    ``int8_encode`` of one trained gradient leaf on the card gives the CPU's
    codes and scales to the bit. Times each mode's steps and the encode +
    decode over the whole gradient tree. World 1 runs the NCCL calls and
    the int8 arithmetic on the card; it reduces across no second card."""
    import dataclasses
    import datetime
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy
    from repro_torch.train import adamw8bit, build_train_step, dp_train_step, make_state
    from repro_torch.train.compression import int8_decode, int8_encode
    from repro_torch.train.optimizer import tree_leaves

    cfg = dataclasses.replace(configs.get("yi-6b"), n_layers=DP_LAYERS)
    model = StreamModel(cfg, Policy(), device="cuda", generator=None)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    batch = {"tokens": torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ), generator=gen, device="cuda")}
    store = tempfile.mkdtemp(prefix="dp_store_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store, "store"), 1), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        def run(mode: str):
            opt = adamw8bit(3e-4)
            state = make_state(model, opt, torch.Generator(device="cuda").manual_seed(SEED))
            if mode == "single":
                step = build_train_step(model, opt)[0]
            else:
                step = dp_train_step(lambda p, b: model.loss(p, b), opt, compress=mode == "compressed")
            losses, step_ms = [], []
            for _ in range(DP_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, met = step(state, batch)
                losses.append(float(met["loss"]))
                step_ms.append((time.perf_counter() - t0) * 1e3)
            return state, losses, step_ms

        reset_counts(kernels)
        state, single_losses, single_ms = run("single")
        single = [p.detach().clone() for p in tree_leaves(state["params"])]
        state, plain_losses, plain_ms = run("uncompressed")
        same_bits = all(torch.equal(a, b) for a, b in zip(single, tree_leaves(state["params"])))
        del single
        state, comp_losses, comp_ms = run("compressed")
        torch.cuda.synchronize()
        counts = read_counts(kernels)
        params = state["params"]
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        del loss
        wq = grads[[i for i, p in enumerate(tree_paths(params)) if p == ("slots", "s0", "mixer", "wq")][0]]
        codes, scales = int8_encode(wq)
        cpu_codes, cpu_scales = int8_encode(wq.cpu())
        encode_bits = bool(torch.equal(codes.cpu(), cpu_codes) and torch.equal(scales.cpu(), cpu_scales))
        codec_ms = time_ms(lambda: [int8_decode(*int8_encode(g), g.shape, g.dtype) for g in grads], 5)
        grad_bytes = sum(g.numel() * g.element_size() for g in grads)
        del grads
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    n_leaves = len(tree_leaves(model.param_tree()))
    k1 = DP_LAYERS * DP_STEPS * 3  # three runs
    want = {"flash_attention": k1, "flash_attention_bwd": k1, "ssd_scan": 0, "ssd_scan_bwd": 0, "rglru_scan": 0,
            "rglru_scan_bwd": 0, "adamw8bit": n_leaves * DP_STEPS * 3, "grad_norm": (n_leaves + 1) * DP_STEPS * 3}
    out = {"layers": DP_LAYERS, "steps": DP_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "world": 1,
           "backend": "nccl", "params": sum(p.numel() for p in model.parameters()),
           "single_losses": single_losses, "uncompressed_losses": plain_losses, "compressed_losses": comp_losses,
           "single_step_ms": single_ms, "uncompressed_step_ms": plain_ms, "compressed_step_ms": comp_ms,
           "uncompressed_same_bits_as_single": same_bits, "int8_encode_same_bits_as_cpu": encode_bits,
           "encode_leaf": list(wq.shape), "codec_ms": codec_ms, "grad_bytes": grad_bytes,
           "launches": counts, "want_launches": want}
    print(f"[{card}] data parallel (world 1, nccl) yi-6b {DP_LAYERS} layers {json.dumps(out)}", flush=True)
    del model, state, params, wq
    assert same_bits and plain_losses == single_losses, out
    assert all(np.isfinite(comp_losses)) and comp_losses[-1] < comp_losses[0], comp_losses
    assert encode_bits, out
    assert counts == want, f"launches {counts}, want {want}"
    return out


def offset_mask(sq: int, sk: int, q_offset: int, window: int | None):
    """The (Sq, Sk) boolean mask of a causal call whose queries sit at
    positions q_offset..: what SDPA takes as ``attn_mask``."""
    import torch

    qp = torch.arange(sq, device="cuda")[:, None] + q_offset
    kp = torch.arange(sk, device="cuda")[None, :]
    keep = kp <= qp
    return keep & (kp > qp - window) if window else keep


def check_offset_call(card, fa, ref, arch, b, s, h, kv, d, window, cap, tp, dtype, gen, timed):
    """K1 forward and backward at one rank's call of a context-parallel
    mesh, for each of the tp offsets in turn: S / tp queries from r S / tp
    over all S keys, causal (and the window and softcap where given).
    Each against the plain version with the offset (TOL, BWD_TOL), each
    the same bits on a repeated call; with ``timed`` the kernel, the plain
    version, the library call and both bounds: SDPA with the explicit
    boolean mask, or with a softcap flex_attention with the offset in its
    mask (``flex_library``; SDPA without the cap, another function, only
    beside it as ``library_sdpa_without_cap_ms``). Returns (forward rows,
    backward rows); raises where one fails."""
    import torch
    import torch.nn.functional as F

    dt = getattr(torch, dtype)
    blk, rep = s // tp, h // kv

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    kt, vt = randn(b, s, kv, d).transpose(1, 2), randn(b, s, kv, d).transpose(1, 2)
    kr, vr = kt.repeat_interleave(rep, 1), vt.repeat_interleave(rep, 1)
    fwd_rows, bwd_rows = [], []
    for r in range(tp):
        off = r * blk
        qt, dot = randn(b, blk, h, d).transpose(1, 2), randn(b, blk, h, d).transpose(1, 2)
        kw = dict(causal=True, window=window, softcap=cap, q_offset=off)

        def fwd():
            return fa.flash_attention(qt, kt, vt, return_lse=True, **kw)

        out, lse = fwd()
        again = fwd()
        same_fwd = bool(torch.equal(out, again[0]) and torch.equal(lse, again[1]))
        want = ref.mha(qt, kr, vr, **kw).float()
        err = (out.float() - want).abs()
        tol = TOL[dtype]
        ok_fwd = bool(torch.isfinite(out).all()) and bool((err <= tol + tol * want.abs()).all()) and same_fwd

        def bwd():
            return fa.flash_attention_bwd(qt, kt, vt, out, dot, lse, **kw)

        got = bwd()
        same_bwd = all(bool(torch.equal(x, y)) for x, y in zip(got, bwd()))
        leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
        plain_out = ref.mha(leaves[0], leaves[1].repeat_interleave(rep, 1), leaves[2].repeat_interleave(rep, 1), **kw)

        def plain_bwd():
            return torch.autograd.grad(plain_out, leaves, dot, retain_graph=True)

        wantg = plain_bwd()
        rel = [float((g.float() - w.float()).abs().max() / w.float().abs().max()) for g, w in zip(got, wantg)]
        unseen = off + blk < s  # keys past the last query: dk = dv = 0
        zeros = not unseen or not (got[1][:, :, off + blk:].any() or got[2][:, :, off + blk:].any())
        ok_bwd = all(bool(torch.isfinite(g).all()) for g in got) and max(rel) <= BWD_TOL[dtype] and same_bwd and zeros
        base = {"arch": arch, "b": b, "sq": blk, "sk": s, "q_offset": off, "h": h, "kv": kv, "d": d, "dtype": dtype,
                "causal": True, "window": window, "softcap": cap, "tp": tp}
        frow = dict(base, max_abs_err=float(err.max()), tol=tol, same_bits_on_repeat=same_fwd, ok=ok_fwd)
        brow = dict(base, rel_err_dq_dk_dv=rel, max_abs_err=max(float((g.float() - w.float()).abs().max())
                                                                for g, w in zip(got, wantg)),
                    tol=BWD_TOL[dtype], same_bits_on_repeat=same_bwd, unseen_keys_zero=zeros, ok=ok_bwd)
        if timed:
            keep = offset_mask(blk, s, off, window)
            frow["ms"] = time_ms(fwd, 20)
            frow["plain_ms"] = time_ms(lambda: ref.mha(qt, kr, vr, **kw), 5)
            sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=keep), 20)
            lq, lk, lv = (t.detach().requires_grad_(True) for t in (qt, kr, vr))
            s_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=keep)
            sdpa_bwd = time_ms(lambda: torch.autograd.grad(s_out, (lq, lk, lv), dot, retain_graph=True), 20)
            if cap is None:
                frow["library_ms"], brow["library_ms"] = sdpa_fwd, sdpa_bwd
            else:
                frow.update(flex_library(qt, kt, vt, True, window, cap, q_offset=off))
                brow.update(flex_library(qt, kt, vt, True, window, cap, dot, q_offset=off))
                frow["library_sdpa_without_cap_ms"], brow["library_sdpa_without_cap_ms"] = sdpa_fwd, sdpa_bwd
            brow["ms"] = time_ms(bwd, 20)
            brow["plain_ms"] = time_ms(plain_bwd, 3)
            frow["bound_ms"], frow["bound_by"] = attention_bound(b, h, kv, blk, d, dtype, True, window, s, off)
            brow["bound_ms"], brow["bound_by"] = attention_bwd_bound(b, h, kv, blk, d, dtype, True, window, s, off)
            del s_out, lq, lk, lv
        del plain_out, leaves, wantg, got
        print(f"[{card}] flash_attention q_offset {json.dumps(frow)}", flush=True)
        print(f"[{card}] flash_attention_bwd q_offset {json.dumps(brow)}", flush=True)
        if not (ok_fwd and ok_bwd):
            raise AssertionError(f"K1 with a query offset disagrees with its plain version: {frow} {brow}")
        fwd_rows.append(frow)
        bwd_rows.append(brow)
    return fwd_rows, bwd_rows


def phase_k1_offset(card, fa, ref) -> dict:
    """K1 and its backward at the calls a rank of a context-parallel mesh
    makes at full width (K1_OFFSET_CALLS: whisper-tiny's decoder at model
    4, qwen2-7b at model 8, gemma2-2b's 8192-token context at model 16,
    whose window of 4096 binds at the later offsets), every offset, in
    bf16 (timed) and f32 (checked); then, at each call's S with offset 0,
    the forward's and the backward's bits with and without the argument.
    Returns {arch: {"fwd": rows, "bwd": rows}} (bf16 rows timed, f32 rows
    under "f32")."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    out = {}
    for arch, b, s, h, kv, d, window, cap, tp in K1_OFFSET_CALLS:
        fwd, bwd = check_offset_call(card, fa, ref, arch, b, s, h, kv, d, window, cap, tp, "bfloat16", gen, True)
        f32 = check_offset_call(card, fa, ref, arch, b, s, h, kv, d, window, cap, tp, "float32", gen, False)
        q, k, v, do = (torch.randn((b, s, n, d), generator=gen, device="cuda").bfloat16().transpose(1, 2)
                       for n in (h, kv, kv, h))
        kw = dict(causal=True, window=window, softcap=cap)
        o0, l0 = fa.flash_attention(q, k, v, return_lse=True, **kw)
        o1, l1 = fa.flash_attention(q, k, v, return_lse=True, q_offset=0, **kw)
        g0 = fa.flash_attention_bwd(q, k, v, o0, do, l0, **kw)
        g1 = fa.flash_attention_bwd(q, k, v, o0, do, l0, q_offset=0, **kw)
        same = bool(torch.equal(o0, o1) and torch.equal(l0, l1)) and all(bool(torch.equal(x, y)) for x, y in zip(g0, g1))
        print(f"[{card}] K1 {arch} offset 0 at S {s}: the bits of the call without an offset: {same}", flush=True)
        assert same, arch
        out[arch] = {"fwd": fwd, "bwd": bwd, "f32": {"fwd": f32[0], "bwd": f32[1]}, "offset0_same_bits": same}
        del q, k, v, do, o0, o1, l0, l1, g0, g1
    return out


def recording(opt):
    """``opt`` that keeps a copy of its first update's gradients (leaf
    order). Returns (optimizer, list of the copies)."""
    from repro_torch.train import Optimizer
    from repro_torch.train.optimizer import tree_leaves

    seen = []

    def update(grads, state, params, **kw):
        if not seen:
            seen.append([g.detach().clone() for g in tree_leaves(grads)])
        return opt.update(grads, state, params, **kw)

    return Optimizer(opt.init, update, opt.state_pspecs), seen


def mesh_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of phase_train_mesh (a process of its own on card
    ``rank``): an NCCL process group of ``world`` through a FileStore,
    then on one card yi-6b's mesh-free and (1, 1)-mesh steps, on several
    qwen3-moe-30b-a3b and whisper-tiny on (1, world). Writes its numbers to
    ``out_dir/rank<rank>.json``; an exception writes its text there too
    and exits non-zero."""
    import contextlib
    import dataclasses
    import datetime
    import os
    import traceback

    import torch
    import torch.distributed as dist

    out = {"rank": rank, "world": world}
    path = Path(out_dir) / f"rank{rank}.json"
    try:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store, "store"), world), rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=MESH_DEADLINE_S),
                                device_id=torch.device(f"cuda:{rank}"))
        from repro_torch import configs
        from repro_torch.kernels import adamw8bit as k8, flash_attention as fa, grad_norm, rglru_scan, ssd_scan
        from repro_torch.launch import make_mesh
        from repro_torch.launch.dryrun import Counter
        from repro_torch.models import moe
        from repro_torch.models import sharding as SH
        from repro_torch.models.model import StreamModel
        from repro_torch.models.policy import Policy
        from repro_torch.train import adamw8bit, build_train_step, make_state
        from repro_torch.train.optimizer import tree_leaves

        kernels = {"flash_attention": fa, "ssd_scan": ssd_scan, "rglru_scan": rglru_scan, "adamw8bit": k8,
                   "grad_norm": grad_norm}
        dev = f"cuda:{rank}"

        def batch_of(cfg, rows, seq, seed):
            gen = torch.Generator(device=dev).manual_seed(seed)
            b = {"tokens": torch.randint(0, cfg.vocab, (rows, seq), generator=gen, device=dev)}
            if cfg.enc_dec:
                b["frames"] = torch.randn((rows, cfg.enc_seq, cfg.d_model), generator=gen, device=dev).bfloat16()
            return b

        def train(model, opt, state, batch, steps, mesh=None, inventory=False):
            """``steps`` steps; with ``inventory`` the first one's collectives
            counted by the dry run's mode (its collectives alone)."""
            step, _ = build_train_step(model, opt, mesh=mesh)
            reset_counts(kernels)
            fa.OFFSET_LAUNCHES = fa.BWD_OFFSET_LAUNCHES = 0
            torch.cuda.reset_peak_memory_stats()
            losses, ms = [], []
            first = Counter(collectives_only=True)
            for i in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with first if inventory and i == 0 else contextlib.nullcontext():
                    state, met = step(state, batch)
                losses.append(float(met["loss"]))
                ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            counts = read_counts(kernels)
            counts["flash_attention_offset"] = fa.OFFSET_LAUNCHES
            counts["flash_attention_bwd_offset"] = fa.BWD_OFFSET_LAUNCHES
            res = {"losses": losses, "step_ms": ms, "launches": counts, "peak_bytes": torch.cuda.max_memory_allocated()}
            if inventory:
                res["collectives"] = first.collectives
            return state, res

        if world == 1:  # yi-6b: the mesh-free step, then the (1, 1) mesh's, from the same seed
            cfg = dataclasses.replace(configs.get("yi-6b"), n_layers=MESH_LAYERS)
            batch = batch_of(cfg, TRAIN_BATCH, TRAIN_SEQ, SEED + 23)
            model = StreamModel(cfg, Policy(), device=dev, generator=None)
            opt = adamw8bit(3e-4)
            state, free = train(model, opt, make_state(model, opt, SEED), batch, MESH_STEPS)
            want = [p.detach().to("cpu", copy=True) for p in tree_leaves(state["params"])]
            del model, opt, state
            torch.cuda.empty_cache()
            mesh = make_mesh((1, 1), ("data", "model"), device=dev)
            model = StreamModel(cfg, Policy.for_mesh(mesh), generator=None, mesh=mesh)
            opt = adamw8bit(3e-4)
            state, meshed = train(model, opt, make_state(model, opt, SEED), batch, MESH_STEPS, mesh)
            same = meshed["losses"] == free["losses"] and all(
                torch.equal(p.detach().cpu(), w) for p, w in zip(tree_leaves(state["params"]), want))
            out["yi-6b"] = {"layers": MESH_LAYERS, "mesh": [1, 1], "steps": MESH_STEPS, "mesh_free": free,
                            "on_mesh": meshed, "same_bits": same, "params": sum(p.numel() for p in want)}
            del model, opt, state, want
            torch.cuda.empty_cache()
        else:
            mesh = make_mesh((1, world), ("data", "model"), device=dev)
            cfg = configs.get(MOE)  # the published capacity factor
            base = torch.cuda.memory_allocated()
            model = StreamModel(cfg, Policy.for_mesh(mesh), generator=None, mesh=mesh)
            opt = adamw8bit(3e-4)
            state = make_state(model, opt, SEED)
            batch = batch_of(cfg, TRAIN_BATCH, TRAIN_SEQ, SEED + 23)
            state_bytes = torch.cuda.memory_allocated() - base  # the step's arguments: state and batch
            moe.DROPS = torch.zeros((), dtype=torch.int64, device=dev)
            state, res = train(model, opt, state, batch, MESH_MOE_STEPS, mesh, inventory=True)
            res["base_bytes"], res["state_bytes"] = base, state_bytes
            del batch
            res["dropped_routes"] = int(moe.DROPS)
            moe.DROPS = None
            res["local_params"] = sum(p.numel() for p in tree_leaves(state["params"]))
            out[MOE] = dict(res, layers=cfg.n_layers, mesh=[1, world], capacity_factor=cfg.moe.capacity_factor)
            del model, opt, state
            torch.cuda.empty_cache()
            # whisper-tiny on (1, world): "seq" attention (6 heads over world); the
            # mesh-free step on rank 0 from the gathered weights is its reference
            cfg = configs.get(WHISPER)
            model = StreamModel(cfg, Policy.for_mesh(mesh), generator=None, mesh=mesh)
            opt = adamw8bit(3e-4)
            state = make_state(model, opt, SEED)
            dense = SH.gather_tree(state["params"], model.param_pspecs(), mesh)
            batch = batch_of(cfg, TRAIN_BATCH, WHISPER_CTX, SEED + 29)
            state, res = train(model, opt, state, batch, MESH_STEPS, mesh)
            del model, opt, state
            if rank == 0:
                ref_model = StreamModel(cfg, Policy(), device=dev, generator=None)
                ref_model.load_params(dense)
                ref_opt = adamw8bit(3e-4)
                ref_state = {"params": ref_model.param_tree(), "opt": ref_opt.init(ref_model.param_tree())}
                for p in tree_leaves(ref_state["params"]):
                    p.requires_grad_(True)
                counts = res["launches"]
                _, free = train(ref_model, ref_opt, ref_state, batch, MESH_STEPS)
                res["launches"] = counts
                res["mesh_free_losses"] = free["losses"]
                del ref_model, ref_opt, ref_state
            out[WHISPER] = dict(res, mesh=[1, world])
            del dense
            # one f32 step: the gathered gradients against the mesh-free step's on rank 0
            f32 = dict(param_dtype="float32", compute_dtype="float32", kv_cache_dtype="float32")
            model = StreamModel(cfg, Policy.for_mesh(mesh, **f32), generator=None, mesh=mesh)
            opt, seen = recording(adamw8bit(3e-4))
            state = make_state(model, opt, SEED)
            specs = model.param_pspecs()
            dense = SH.gather_tree(state["params"], specs, mesh)
            batch = dict(batch, frames=batch["frames"].float())
            build_train_step(model, opt, mesh=mesh)[0](state, batch)
            grads = [SH.gather(g, sp, mesh) for g, sp in zip(seen[0], tree_leaves(specs))]
            del model, opt, state, seen
            if rank == 0:
                ref_model = StreamModel(cfg, Policy(**f32), device=dev, generator=None)
                ref_model.load_params(dense)
                ref_opt, ref_seen = recording(adamw8bit(3e-4))
                ref_state = {"params": ref_model.param_tree(), "opt": ref_opt.init(ref_model.param_tree())}
                for p in tree_leaves(ref_state["params"]):
                    p.requires_grad_(True)
                build_train_step(ref_model, ref_opt)[0](ref_state, batch)
                rel = [float((g - w).abs().max() / max(float(w.abs().max()), 1e-30)) for g, w in zip(grads, ref_seen[0])]
                worst = max(range(len(rel)), key=rel.__getitem__)
                out[WHISPER]["f32_grad_rel"] = {"max": rel[worst], "leaf": worst, "leaves": len(rel),
                                                "median": sorted(rel)[len(rel) // 2]}
                del ref_model, ref_opt, ref_state, ref_seen
            del dense, grads
            torch.cuda.empty_cache()
        dist.barrier()
        t0 = time.perf_counter()
        out["serve"] = serve_mesh_rank(rank, world, dev, kernels)
        dist.barrier()
        out["serve"]["wall_s"] = time.perf_counter() - t0
        dist.destroy_process_group()
        out["ok"] = True
    except BaseException as e:  # noqa: BLE001  (the parent reads why the rank failed)
        out["ok"] = False
        out["error"] = f"{type(e).__name__}: {e}\n{traceback.format_exc()[-4000:]}"
        path.write_text(json.dumps(out))
        raise
    path.write_text(json.dumps(out))


def serve_mesh_rank(rank: int, world: int, dev: str, kernels: dict) -> dict:
    """Serving on the mesh, in mesh_rank's process (its NCCL group up): on
    one card yi-6b's (1, 1) steps against the mesh-free steps, to the bit;
    on several mistral-large-123b, gemma2-2b and qwen3-moe-30b-a3b on
    (1, n). Each model's main path runs with the launch counts set to 0
    just before and read just after. Returns the rank's numbers."""
    import contextlib
    import gc as gc_

    import torch

    from repro_torch import configs
    from repro_torch.launch import make_mesh
    from repro_torch.launch.dryrun import Counter
    from repro_torch.models import sharding as SH
    from repro_torch.models.layers import cache_bits
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy
    from repro_torch.serve import build_prefill_step, build_serve_step

    def tokens_of(cfg, n, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(0, cfg.vocab, (1, n), generator=gen, device=dev)

    def greedy(model, mesh, prompt, steps, feed=None, s_cache=None, cache_dtype=None, inventory=None):
        """A prefill (``build_prefill_step``'s bf16 cache, or one of
        ``cache_dtype`` through ``prefill``) and ``steps`` decode steps,
        each fed its greedy token (or ``feed``'s); the logits of each, the
        tokens, the cache, ms. With ``inventory`` (a dry-run ``Counter``)
        the prefill runs under it."""
        s_cache = s_cache or prompt.shape[1] + steps
        pre = build_prefill_step(model, s_cache, mesh)
        if cache_dtype is not None:
            pre = lambda b: model.prefill(b["tokens"], s_cache, cache_dtype=cache_dtype)  # noqa: E731
        step = build_serve_step(model, mesh)
        step = step[0] if mesh is not None else step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with inventory or contextlib.nullcontext():
            lg, cache = pre({"tokens": prompt})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, toks = [lg], []
        for i in range(steps):
            tok = lg.argmax(-1)[:, None] if feed is None else feed[:, i:i + 1]
            toks.append(tok)
            lg, cache = step(cache, tok, prompt.shape[1] + i)
            lg = lg[:, 0]
            logits.append(lg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return {"logits": torch.stack(logits), "tokens": torch.cat(toks, 1), "cache": cache,
                "prefill_ms": (t1 - t0) * 1e3, "decode_ms": (t2 - t1) * 1e3 / max(steps, 1)}

    def free():
        gc_.collect()
        torch.cuda.empty_cache()

    out = {}
    if world == 1:  # yi-6b at all 32 layers: the (1, 1) mesh's steps against the mesh-free steps
        cfg = configs.get("yi-6b")
        mesh = make_mesh((1, 1), ("data", "model"), device=dev)
        meshed = StreamModel(cfg, Policy.for_mesh(mesh), generator=SEED, mesh=mesh)
        prompts = [tokens_of(cfg, n, SEED + 60 + i) for i, n in enumerate(PROMPT_LENS)]
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        runs = [greedy(meshed, mesh, p, MESH_DECODE) for p in prompts]
        counts = read_counts(kernels)
        peak = torch.cuda.max_memory_allocated()
        del meshed
        free()
        plain = StreamModel(cfg, Policy(), device=dev, generator=SEED)
        same = True
        for p, r in zip(prompts, runs):
            want = greedy(plain, None, p, MESH_DECODE)
            same &= bool(torch.equal(r["logits"], want["logits"]) and torch.equal(r["tokens"], want["tokens"]))
            for sec, slots in want["cache"].items():
                for name, st in slots.items():
                    same &= all(bool(torch.equal(cache_bits(v), cache_bits(r["cache"][sec][name][k])))
                                for k, v in st.items())
        del plain, runs
        free()
        out["yi-6b"] = {"layers": cfg.n_layers, "mesh": [1, 1], "prompts": list(PROMPT_LENS), "same_bits": same,
                        "launches": counts, "peak_bytes": peak}
        return out

    mesh = make_mesh((1, world), ("data", "model"), device=dev)
    # mistral-large-123b at all 88 layers, bf16: each rank its blocks, drawn a layer at a time
    cfg = configs.get(MISTRAL)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = StreamModel(cfg, Policy.for_mesh(mesh), generator=SEED, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    prompts = [tokens_of(cfg, MESH_MISTRAL_LEN, SEED + 70 + i) for i in range(MESH_MISTRAL_PROMPTS)]
    state_bytes = torch.cuda.memory_allocated() - base  # the prefill's arguments: the weights and the prompts
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()  # the first prompt's peak, for the dry run's prefill cell
    first = Counter(collectives_only=True)
    runs = [greedy(model, mesh, prompts[0], MESH_DECODE, inventory=first)]
    first_peak = torch.cuda.max_memory_allocated() - base
    runs += [greedy(model, mesh, p, MESH_DECODE) for p in prompts[1:]]
    counts = read_counts(kernels)
    worst = 0.0
    for p, r in zip(prompts, runs):  # each served token against the mesh forward's teacher-forced logits
        seq = torch.cat([p, r["tokens"][:, :-1]], 1)
        fl = model(seq)[0, p.shape[1] - 1:]
        assert bool(torch.isfinite(fl).all()) and bool(torch.isfinite(r["logits"]).all())
        gap = fl.max(-1).values - fl.gather(-1, r["tokens"][0][:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        del fl
    out[MISTRAL] = {"layers": cfg.n_layers, "mesh": [1, world], "init_s": init_s, "init_peak_bytes": init_peak,
                    "local_params": sum(p.numel() for p in model.parameters()), "launches": counts,
                    "prefill_ms": [r["prefill_ms"] for r in runs], "decode_ms": [r["decode_ms"] for r in runs],
                    "worst_gap": worst, "peak_bytes": max(init_peak, torch.cuda.max_memory_allocated()),
                    "base_bytes": base, "state_bytes": state_bytes, "first_prompt_peak_bytes": first_peak,
                    "prefill_collectives": first.collectives}
    del model, runs
    free()
    # gemma2-2b at all 26 layers in f32 with seq_axis="model": flash-decode on the card
    cfg = configs.get(GEMMA2)
    f32 = dict(param_dtype="float32", compute_dtype="float32", kv_cache_dtype="float32")
    plain = StreamModel(cfg, Policy(**f32), device=dev, generator=SEED)
    meshed = StreamModel(cfg, Policy.for_mesh(mesh, seq_axis="model", **f32), generator=None, mesh=mesh)
    meshed.load_params(SH.shard_tree(plain.param_tree(), meshed.param_pspecs(), mesh))
    if rank:
        del plain
    free()
    g2 = {"mesh": [1, world], "runs": []}
    for n, steps in MESH_G2_RUNS:
        prompt, feed = tokens_of(cfg, n, SEED + 80 + n), tokens_of(cfg, steps, SEED + 81 + n)
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        got = greedy(meshed, mesh, prompt, steps, feed=feed, s_cache=MESH_G2_CACHE, cache_dtype=torch.float32)
        run = {"prompt": n, "steps": steps, "launches": read_counts(kernels), "prefill_ms": got["prefill_ms"],
               "decode_ms": got["decode_ms"], "peak_bytes": torch.cuda.max_memory_allocated()}
        dense = meshed.gather_caches(got["cache"], 1)
        if rank == 0:
            want = greedy(plain, None, prompt, steps, feed=feed, s_cache=MESH_G2_CACHE, cache_dtype=torch.float32)
            rel = (got["logits"] - want["logits"]).abs().amax(-1) / want["logits"].abs().amax(-1)
            run["logit_rel"] = [float(x) for x in rel[:, 0]]
            cache_rel = 0.0
            for sec, slots in want["cache"].items():
                for name, st in slots.items():
                    for k, v in st.items():
                        if k != "pos":
                            d = float((dense[sec][name][k] - v).abs().max() / max(float(v.abs().max()), 1e-30))
                            cache_rel = max(cache_rel, d)
            run["cache_rel"] = cache_rel
            del want
        g2["runs"].append(run)
        del got, dense
        free()
    out[GEMMA2] = g2
    del meshed
    if rank == 0:
        del plain
    free()
    # qwen3-moe-30b-a3b at all 48 layers in int8, placed by quantized_pspecs
    cfg = configs.get(MOE)
    torch.cuda.reset_peak_memory_stats()
    meshed = StreamModel(cfg, Policy.for_mesh(mesh, weights_int8=True), generator=SEED, mesh=mesh)
    _, specs = build_serve_step(meshed, mesh)
    mp = {"mesh": [1, world], "local_bytes": model_bytes(meshed)}
    plain = StreamModel(cfg, Policy(weights_int8=True), device=dev, generator=SEED) if rank == 0 else None
    same_codes = True  # each leaf's first layer gathered by its spec against the mesh-free codes
    for part, sub in meshed.param_tree()["slots"]["s0"].items():
        for k, leaf in sub.items():
            leaves = leaf.items() if isinstance(leaf, dict) else [(None, leaf)]
            for q, t in leaves:
                sp = specs["slots"]["s0"][part][k]
                sp = sp[q] if q else sp
                dense = SH.gather(t[0], SH.layer_specs(sp), mesh)
                if rank == 0:
                    ref = plain.param_tree()["slots"]["s0"][part][k]
                    same_codes &= bool(torch.equal(dense, (ref[q] if q else ref)[0]))
                del dense
    mp["same_codes"] = same_codes
    prompts = [tokens_of(cfg, n, SEED + 90 + i) for i, n in enumerate(PROMPT_LENS)]
    reset_counts(kernels)
    runs = [greedy(meshed, mesh, p, MESH_DECODE) for p in prompts]
    mp["launches"] = read_counts(kernels)
    mp["prefill_ms"] = [r["prefill_ms"] for r in runs]
    mp["decode_ms"] = [r["decode_ms"] for r in runs]
    mp["peak_bytes"] = torch.cuda.max_memory_allocated()
    if rank == 0:
        agree, rows, gap = 0, 0, 0.0
        for p, r in zip(prompts, runs):
            for key in ("cache",):
                r.pop(key)
            want = greedy(plain, None, p, MESH_DECODE, feed=r["tokens"])
            agree += int((want["logits"].argmax(-1) == r["logits"].argmax(-1)).sum())
            rows += want["logits"].shape[0] * want["logits"].shape[1]
            gap = max(gap, float((want["logits"] - r["logits"]).abs().max()))
            del want
        mp["argmax_agree"] = agree / rows
        mp["max_logit_gap"] = gap
    out[MOE] = mp
    del meshed, plain, runs
    free()
    return out


def check_serve_mesh(card, ranks: list, world: int) -> None:
    """Print and check serve_mesh_rank's numbers (in phase_train_mesh)."""
    import numpy as np

    from repro_torch import configs

    if world == 1:
        yi = ranks[0]["serve"]["yi-6b"]
        print(f"[{card}] serving mesh (1, 1) yi-6b 32 layers: same bits as mesh-free {yi['same_bits']}, K1 "
              f"{yi['launches']['flash_attention']}, peak {yi['peak_bytes']} bytes, {ranks[0]['serve']['wall_s']:.1f} s",
              flush=True)
        assert yi["same_bits"], yi
        assert yi["launches"]["flash_attention"] == 32 * len(PROMPT_LENS), yi["launches"]
        return
    for r in ranks:
        sv = r["serve"]
        m, g2, mp = sv[MISTRAL], sv[GEMMA2], sv[MOE]
        print(f"[{card}] serving mesh (1, {world}) rank {r['rank']}: mistral 88 layers K1 "
              f"{m['launches']['flash_attention']}, init {m['init_s']:.1f} s (peak {m['init_peak_bytes']}), peak "
              f"{m['peak_bytes']} bytes, prefill ms {np.round(m['prefill_ms'], 1).tolist()}, decode ms/step "
              f"{np.round(m['decode_ms'], 2).tolist()}, worst gap {m['worst_gap']:.4f}; gemma2 "
              f"{[(x['prompt'], x['launches']['flash_attention'], x.get('logit_rel') and max(x['logit_rel']), x.get('cache_rel')) for x in g2['runs']]}; "
              f"qwen3-moe int8 K1 {mp['launches']['flash_attention']}, same codes {mp['same_codes']}, peak "
              f"{mp['peak_bytes']}, agree {mp.get('argmax_agree')}, gap {mp.get('max_logit_gap')}; "
              f"{sv['wall_s']:.1f} s", flush=True)
        assert m["launches"]["flash_attention"] == configs.get(MISTRAL).n_layers * MESH_MISTRAL_PROMPTS, m["launches"]
        assert m["worst_gap"] <= MESH_MISTRAL_SLACK, m["worst_gap"]
        for x in g2["runs"]:
            assert x["launches"]["flash_attention"] == configs.get(GEMMA2).n_layers, x["launches"]
        assert mp["launches"]["flash_attention"] == configs.get(MOE).n_layers * len(PROMPT_LENS), mp["launches"]
    r0 = ranks[0]["serve"]
    for x in r0[GEMMA2]["runs"]:
        assert max(x["logit_rel"]) <= MESH_G2_RTOL and x["cache_rel"] <= MESH_G2_RTOL, x
    assert r0[MOE]["same_codes"], r0[MOE]
    assert r0[MOE]["argmax_agree"] >= MESH_MOE_AGREE_MIN and r0[MOE]["max_logit_gap"] <= MESH_MOE_GAP_MAX, r0[MOE]


def phase_train_mesh(card, kernels: dict) -> dict:
    """Training on a device mesh: one NCCL rank a card
    (``torch.multiprocessing``, spawned; rendezvous through a FileStore in
    a temporary directory; every rank joined by MESH_DEADLINE_S, killed
    past it, and a rank's failure fails the phase). On one card
    (mesh_rank): full-width yi-6b cut to MESH_LAYERS, MESH_STEPS steps with
    adamw8bit on the (1, 1) mesh give the mesh-free step's losses and
    parameters to the bit. On several: qwen3-moe-30b-a3b at all 48 layers
    and whisper-tiny on (1, n), finite, falling losses (qwen3-moe's first
    in its band), whisper's within MESH_LOSS_RTOL of the mesh-free step
    on rank 0 and its first f32 step's gathered gradients within
    MESH_GRAD_RTOL of the mesh-free step's, K1's launches with an offset
    counted. Returns the ranks' numbers."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from repro_torch import configs

    world = torch.cuda.device_count()
    dry = None
    if world > 1:  # the dry run of the mesh's qwen3-moe training and mistral prefill, beside the ranks
        dry = start_dryrun([
            ["moe-train-mesh", MOE, configs.get(MOE).n_layers, "train", TRAIN_BATCH, TRAIN_SEQ, [1, world]],
            ["mistral-prefill-mesh", MISTRAL, configs.get(MISTRAL).n_layers, "prefill", 1, MESH_MISTRAL_LEN,
             [1, world]]])
    store, out_dir = tempfile.mkdtemp(prefix="mesh_store_"), tempfile.mkdtemp(prefix="mesh_out_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=mesh_rank, args=(r, world, store, out_dir)) for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        end = time.monotonic() + MESH_DEADLINE_S
        for p in procs:
            p.join(max(end - time.monotonic(), 0.1))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        ranks = []
        for r in range(world):
            f = Path(out_dir) / f"rank{r}.json"
            ranks.append(json.loads(f.read_text()) if f.exists() else {"rank": r, "ok": False, "error": "no result"})
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store, ignore_errors=True)
        shutil.rmtree(out_dir, ignore_errors=True)
    wall_s = time.perf_counter() - t0
    failed = [r for r in ranks if not r.get("ok")] + [{"rank": r, "error": "past the deadline"} for r in late]
    out = {"world": world, "ranks_ran": [r["rank"] for r in ranks if r.get("ok")], "wall_s": wall_s, "ranks": ranks}
    for r in ranks:
        runs = {k: v.get("on_mesh", v) for k, v in r.items() if isinstance(v, dict)}
        summary = {k: {kk: v[kk] for kk in ("losses", "step_ms", "peak_bytes", "launches") if kk in v}
                   for k, v in runs.items()}
        print(f"[{card}] mesh rank {r['rank']} of {world}: ok {r.get('ok')} {json.dumps(summary)}", flush=True)
    assert not failed, f"mesh ranks failed: {failed}"
    if world == 1:
        yi = ranks[0]["yi-6b"]
        print(f"[{card}] mesh (1, 1) yi-6b {MESH_LAYERS} layers: losses {yi['on_mesh']['losses']}, mesh-free "
              f"{yi['mesh_free']['losses']}, same bits {yi['same_bits']}, peak {yi['on_mesh']['peak_bytes']} bytes, "
              f"step ms {yi['on_mesh']['step_ms']}", flush=True)
        assert yi["same_bits"], yi
        assert yi["on_mesh"]["launches"]["flash_attention"] == MESH_LAYERS * MESH_STEPS, yi["on_mesh"]["launches"]
    else:
        for r in ranks:
            m, w = r[MOE], r[WHISPER]
            band = TRAIN_LOSS0_BAND[MOE]
            assert all(np.isfinite(m["losses"])) and band[0] <= m["losses"][0] <= band[1], m["losses"]
            assert m["losses"][-1] < m["losses"][0] and all(np.isfinite(w["losses"])), (m["losses"], w["losses"])
            assert m["launches"]["flash_attention"] == configs.get(MOE).n_layers * MESH_MOE_STEPS, m["launches"]
        w0 = ranks[0][WHISPER]
        gaps = [abs(a - b) / abs(b) for a, b in zip(w0["losses"], w0["mesh_free_losses"])]
        print(f"[{card}] mesh (1, {world}) whisper-tiny losses {w0['losses']} against mesh-free "
              f"{w0['mesh_free_losses']} (relative {gaps}); f32 first-step gradients against mesh-free "
              f"{w0['f32_grad_rel']}; qwen3-moe losses {ranks[0][MOE]['losses']}", flush=True)
        assert max(gaps) <= MESH_LOSS_RTOL, gaps
        assert w0["f32_grad_rel"]["max"] <= MESH_GRAD_RTOL, w0["f32_grad_rel"]
    check_serve_mesh(card, ranks, world)
    if dry is not None:
        out["dryrun"] = check_mesh_dryrun(card, dryrun_result(dry), ranks[0])
    return out


def check_mesh_dryrun(card, preds: dict, rank0: dict) -> dict:
    """The dry run's (1, n) cells against rank 0 of the mesh phase
    (:func:`dryrun_row`): qwen3-moe-30b-a3b's training (the state and batch
    held when the first step starts, the training's peak, the median
    step) and mistral-large-123b's prefill (its weights and prompts, the
    first prompt's peak: its prefill and decode steps; the dry run's cache
    holds the prompt's 1024 slots where the card's holds MESH_DECODE more,
    a few MB); and rank 0's real collective inventory (each kind's calls
    and result bytes, counted by the dry run's mode over the first
    training step and the first prefill) equal to the fake group's.
    Raises on a miss."""
    moe_run, mistral = rank0[MOE], rank0["serve"][MISTRAL]
    steady = sorted(moe_run["step_ms"][1:])
    rows = {
        "moe-train-mesh": dryrun_row(card, "qwen3-moe-30b-a3b 48 layers (1, n) train", preds["moe-train-mesh"],
                                     moe_run["state_bytes"], moe_run["peak_bytes"] - moe_run["base_bytes"],
                                     steady[len(steady) // 2]),
        "mistral-prefill-mesh": dryrun_row(card, "mistral-large-123b 88 layers (1, n) prefill",
                                           preds["mistral-prefill-mesh"], mistral["state_bytes"],
                                           mistral["first_prompt_peak_bytes"]),
    }
    for name, real in (("moe-train-mesh", moe_run["collectives"]),
                       ("mistral-prefill-mesh", mistral["prefill_collectives"])):
        fake = preds[name]["collectives"]
        rows[name]["collectives_equal"] = fake == real
        print(f"[{card}] dry run {name}: collectives on the fake group {json.dumps(fake)}, on rank 0 "
              f"{json.dumps(real)}", flush=True)
    bad = {k: r for k, r in rows.items() if not (r["ok"] and r["collectives_equal"])}
    assert not bad, f"the dry run missed the mesh: {bad}"
    return rows


def mesh_paths(card, fa, ref, mesh: dict, k1_offset: dict, train_fwd_main: dict, bwd_main: dict, serve_rows: list):
    """K1's and its backward's ``by_path`` entries of the mesh phase and of
    the offset calls: each offset call's timed rows with the launches a
    main path made with an offset (whisper-tiny's on a mesh of several
    cards; none runs qwen2-7b's or gemma2-2b's yet), and the mesh's own
    training calls (yi-6b's on one card: train_fwd_main's shape; on n
    cards qwen3-moe's per-rank call, timed here) and serving calls (yi-6b's
    prefills on one card: ``serve_rows``, its serving calls; on n cards
    each model's per-rank prefill calls, timed here) with their launches,
    summed over the ranks. Returns (forward paths, backward paths)."""
    import torch

    world, ranks = mesh["world"], mesh["ranks"]

    def total(arch, key):  # over the ranks
        return sum((r[arch]["on_mesh"] if world == 1 else r[arch])["launches"][key] for r in ranks)

    fwd, bwd = {}, {}
    for arch, *_ in K1_OFFSET_CALLS:
        n_f = total(WHISPER, "flash_attention_offset") if arch == WHISPER and world > 1 else 0
        n_b = total(WHISPER, "flash_attention_bwd_offset") if arch == WHISPER and world > 1 else 0
        fwd[f"{arch}-seq-offsets"] = path_summary(n_f, k1_offset[arch]["fwd"])
        bwd[f"{arch}-seq-offsets"] = path_summary(n_b, k1_offset[arch]["bwd"])
    def served(arch):  # the serving phase's K1 launches, over the ranks (and gemma2's runs)
        runs = [r["serve"][arch] for r in ranks]
        return sum(sum(x["launches"]["flash_attention"] for x in s.get("runs", [s])) for s in runs)

    if world == 1:
        fwd["yi-6b-mesh"] = path_summary(total("yi-6b", "flash_attention"), [train_fwd_main])
        bwd["yi-6b-mesh"] = path_summary(total("yi-6b", "flash_attention_bwd"), [bwd_main])
        fwd["yi-6b-serve-mesh"] = path_summary(served("yi-6b"), serve_rows)
    else:
        rows = serve_mesh_rows(card, fa, ref, world)
        for arch in (MISTRAL, GEMMA2, MOE):
            fwd[f"{arch}{'-int8' if arch == MOE else ''}-serve-mesh"] = path_summary(served(arch), rows[arch])
        gen = torch.Generator(device="cuda").manual_seed(SEED + 43)
        b, s, h, kv, d = TRAIN_ATTN
        row = check_attention(card, fa, ref, b, s, h // world, kv // world, d, "bfloat16", True, None, None, gen, True)
        brow = check_attention_bwd(card, fa, ref, b, s, h // world, kv // world, d, "bfloat16", True, None, gen, True)
        fwd[f"{MOE}-mesh"] = path_summary(total(MOE, "flash_attention"), [row])
        bwd[f"{MOE}-mesh"] = path_summary(total(MOE, "flash_attention_bwd"), [brow])
        fwd[f"{WHISPER}-mesh"] = path_summary(total(WHISPER, "flash_attention"), k1_offset[WHISPER]["fwd"])
        bwd[f"{WHISPER}-mesh"] = path_summary(total(WHISPER, "flash_attention_bwd"), k1_offset[WHISPER]["bwd"])
    return fwd, bwd


def serve_mesh_rows(card, fa, ref, world: int) -> dict:
    """K1 at one rank's prefill calls of the serving mesh on ``world``
    cards, each timed beside its plain version and library call:
    mistral's (1, 1024, 96/n over 8/n, 128), gemma2's long prompt's local
    (window 4096) and global calls (8/n over 4/n, 256, f32, cap 50) and
    qwen3-moe's at each PROMPT_LENS length (32/n over 4/n, 128)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 47)
    return {
        MISTRAL: [check_attention(card, fa, ref, 1, MESH_MISTRAL_LEN, 96 // world, 8 // world, 128, "bfloat16", True,
                                  None, None, gen, True)],
        GEMMA2: [check_attention(card, fa, ref, 1, MESH_G2_RUNS[0][0], 8 // world, 4 // world, 256, "float32", True,
                                 w, 50.0, gen, True) for w in (4096, None)],
        MOE: [check_attention(card, fa, ref, 1, n, 32 // world, 4 // world, 128, "bfloat16", True, None, None, gen,
                              True) for n in PROMPT_LENS],
    }


def opt8_scalars(step: int) -> dict:
    """The 8-bit update's keyword arguments at ``step`` (lr 3e-4, b1 0.9,
    b2 0.95): lr and the bias corrections as 0-d f32 host tensors."""
    import torch

    b1, b2 = 0.9, 0.95
    stepf = torch.tensor(step, dtype=torch.float32)
    return dict(lr=torch.tensor(3e-4, dtype=torch.float32), bc1=1 - torch.tensor(b1, dtype=torch.float32) ** stepf,
                bc2=1 - torch.tensor(b2, dtype=torch.float32) ** stepf, b1=b1, b2=b2, eps=1e-8, weight_decay=0.01)


def opt8_compare(got: list, want: list, dtype: str, **where) -> dict:
    """The gate on one update: (p, m codes, m scales, v codes, v scales)
    from the kernel against the plain version's. p within OPT8_RTOL, m
    codes and scales equal, v codes at most 1 apart on at most
    OPT8_V_SHARE of entries."""
    import torch

    err = float((got[0].float() - want[0].float()).abs().max())
    p_ok = bool(torch.allclose(got[0].float(), want[0].float(), rtol=OPT8_RTOL[dtype], atol=1e-7))
    m_ok = torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    dv = (got[3].int() - want[3].int()).abs()
    share = float((dv > 0).float().mean())
    v_ok = int(dv.max()) <= 1 and share <= OPT8_V_SHARE
    return {**where, "dtype": dtype, "p_max_abs_err": err, "p_bit_equal": bool(torch.equal(got[0], want[0])),
            "m_equal": m_ok, "v_codes_apart_share": share,
            "v_scales_max_abs_err": float((got[4] - want[4]).abs().max()), "ok": p_ok and m_ok and v_ok}


def check_norm_tree(gn, ref, grads: list, flat) -> dict:
    """The norm kernel over the tree's grads against ``ref.global_norm``
    (within NORM_RTOL), the same bits on a repeated call, and its times:
    the kernel's (20 calls), the plain version's (2), and one library call
    that computes the norm of the same bytes, ``torch.linalg.vector_norm``
    of the flat buffer the grads are views of (20; a yardstick, never
    called by the port)."""
    import torch

    norm, scale = gn.global_norm(grads, OPT8_MAX_NORM)
    norm2, scale2 = gn.global_norm(grads, OPT8_MAX_NORM)
    want_norm, want_scale = ref.global_norm(grads, OPT8_MAX_NORM)
    torch.cuda.synchronize()
    rel = float((norm - want_norm).abs() / want_norm)
    rel_scale = float((scale - want_scale).abs() / want_scale)
    bound_ms, bound_by = norm_bound(grads)
    out = {
        "norm": float(norm), "plain_norm": float(want_norm), "scale": float(scale), "plain_scale": float(want_scale),
        "max_abs_err": float((norm - want_norm).abs()), "rel_err": rel, "scale_rel_err": rel_scale, "rtol": NORM_RTOL,
        "bit_identical": bool(torch.equal(norm, norm2) and torch.equal(scale, scale2)),
        "bytes": sum(g.numel() * g.element_size() for g in grads),
        "ms": time_ms(lambda: gn.global_norm(grads, OPT8_MAX_NORM), 20),
        "plain_ms": time_ms(lambda: ref.global_norm(grads, OPT8_MAX_NORM), 2),
        "library_ms": time_ms(lambda: torch.linalg.vector_norm(flat), 20),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    out["ok"] = rel <= NORM_RTOL and rel_scale <= NORM_RTOL and out["bit_identical"]
    return out


def check_opt8_tree(label: str, k8, ref, gen, gn=None) -> dict:
    """The 8-bit update over the whole FULL_LAYERS-layer yi-6b tree
    (``opt8_tree``), one call of ``k8``'s wrapper a leaf at the shapes the
    training path gives it: times the kernel (20 calls after a warm-up),
    then holds one more update of each leaf (step 2's scalars, from the
    state the timing left) against ``ref.adamw8bit_update`` on clones of
    that leaf, then times the plain version, and computes the bound. With
    ``gn`` (the norm's wrapper) every update takes the clip scale that
    ``gn`` computes from the grads (below 1), the norm is checked and timed
    (``check_norm_tree``), and so is the optimizer phase, the norm and the
    12 updates (10 calls); without it the updates take g as given (the
    call an older checkout's wrapper takes too)."""
    import torch

    torch.cuda.empty_cache()
    names, params, grads, states, flat = opt8_tree(gen)
    norm, clip = None, {}
    if gn is not None:
        norm = check_norm_tree(gn, ref, grads, flat)
        clip = {"clip_scale": gn.global_norm(grads, OPT8_MAX_NORM)[1]}
    kw = {**opt8_scalars(1), **clip}

    def kernel_tree():
        for p, g, st in zip(params, grads, states):
            k8.adamw8bit_update(p, g, *st, **kw)

    def plain_tree():
        for p, g, st in zip(params, grads, states):
            ref.adamw8bit_update(p, g, *st, **kw)

    def optimizer_phase():
        scale = gn.global_norm(grads, OPT8_MAX_NORM)[1]
        for p, g, st in zip(params, grads, states):
            k8.adamw8bit_update(p, g, *st, **{**kw, "clip_scale": scale})

    with torch.no_grad():
        ms = time_ms(kernel_tree, 20)
        rows = []
        for name, p, g, st in zip(names, params, grads, states):
            want = [p.clone(), *(t.clone() for t in st)]
            k8.adamw8bit_update(p, g, *st, **opt8_scalars(2), **clip)
            ref.adamw8bit_update(want[0], g, *want[1:], **opt8_scalars(2), **clip)
            torch.cuda.synchronize()
            rows.append(opt8_compare([p, *st], want, str(p.dtype).removeprefix("torch."), leaf=name,
                                     shape=list(p.shape), step=2))
            del want
        plain_ms = time_ms(plain_tree, 2)
        optimizer_ms = time_ms(optimizer_phase, 10) if gn is not None else None
    bound_ms, bound_by = opt8_bound(params)
    out = {
        "label": label, "checks": rows, "max_abs_err": max(r["p_max_abs_err"] for r in rows),
        "v_codes_apart_share": max(r["v_codes_apart_share"] for r in rows), "leaves": len(params),
        "params": sum(p.numel() for p in params), "bytes": sum(opt8_bytes(p) for p in params), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "clipped": gn is not None, "optimizer_ms": optimizer_ms, "norm": norm,
        "ok": all(r["ok"] for r in rows) and (norm is None or norm["ok"]),
    }
    del params, grads, states, flat
    return out


def opt8_tree(gen) -> tuple[list, list, list, list, object]:
    """The FULL_LAYERS-layer yi-6b tree at full width (random bf16 params
    from SEED): its leaves' names and params, bf16 grads of standard
    deviation 1e-3 from ``gen`` (their global norm is about 78, so a clip
    at OPT8_MAX_NORM scales them), each leaf's zero 8-bit state as (m
    codes, m scales, v codes, v scales), and the flat buffer the grads are
    views of."""
    import torch

    from repro_torch import configs
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy
    from repro_torch.train import adamw8bit
    from repro_torch.train.optimizer import tree_leaves

    model = StreamModel(configs.get("yi-6b"), Policy(), device="cuda", generator=SEED)
    names = [".".join(path) for path in tree_paths(model.param_tree())]
    params = tree_leaves(model.param_tree())
    flat = torch.empty(sum(p.numel() for p in params), dtype=torch.bfloat16, device="cuda")
    grads, at = [], 0
    for p in params:
        g = flat[at:at + p.numel()].view(p.shape)
        g.copy_(torch.randn(p.shape, generator=gen, device="cuda", dtype=torch.float32) * 1e-3)
        grads.append(g)
        at += p.numel()
    states = []
    for p in params:
        st = adamw8bit(1e-3).init({"p": p})
        states.append([st["m"]["p"]["codes"], st["m"]["p"]["scales"], st["v"]["p"]["codes"], st["v"]["p"]["scales"]])
    return names, params, grads, states, flat


def tree_paths(tree, prefix=()) -> list:
    """The key paths of a nested dict's leaves, in JAX's order (sorted keys)."""
    if isinstance(tree, dict):
        return [path for k in sorted(tree) for path in tree_paths(tree[k], prefix + (k,))]
    return [prefix]


def phase_optimizer_kernel(card):
    """The 8-bit update's kernel and the norm kernel against their plain
    versions on the card, at OPT8_SHAPES in bf16 and f32, OPT8_UPDATES
    updates each from the zero state at step 1 (both trajectories run
    apart and are held after each update), with the first 256-block's
    gradient zero and every update clipped: the norm kernel's scale of that
    gradient (its norm held to the plain version's within NORM_RTOL), fed
    to both; then over the whole FULL_LAYERS-layer yi-6b tree (its 12
    leaves, one launch each, at the training path's shapes:
    ``check_opt8_tree``), timed and held leaf by leaf against the plain
    version, with the norm and the optimizer phase."""
    import numpy as np
    import torch

    from repro_torch.kernels import adamw8bit as k8
    from repro_torch.kernels import grad_norm as gn
    from repro_torch.kernels import ref
    from repro_torch.train import adamw8bit

    rows, norm_errs = [], []
    launches0, norm_launches0 = k8.LAUNCHES, gn.LAUNCHES
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)

    def quantized(st):
        return [st["m"]["p"]["codes"], st["m"]["p"]["scales"], st["v"]["p"]["codes"], st["v"]["p"]["scales"]]

    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for shape in OPT8_SHAPES:
            p = (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(dt)
            st = adamw8bit(1e-3).init({"p": p})
            got = [p.clone(), *quantized(st)]
            want = [p.clone(), *(t.clone() for t in quantized(st))]
            for step in range(1, OPT8_UPDATES + 1):
                g = (torch.randn(shape, generator=gen, device="cuda") * 1e-3).to(dt)
                g.view(-1, shape[-1])[0, :256] = 0
                norm, scale = gn.global_norm([g], OPT8_MAX_NORM)
                want_norm = ref.global_norm([g], OPT8_MAX_NORM)[0]
                norm_errs.append(float((norm - want_norm).abs() / want_norm))
                assert norm_errs[-1] <= NORM_RTOL and float(scale) < 1, (shape, dtype, norm_errs[-1], float(scale))
                k8.adamw8bit_update(got[0], g, *got[1:], **opt8_scalars(step), clip_scale=scale)
                ref.adamw8bit_update(want[0], g, *want[1:], **opt8_scalars(step), clip_scale=scale)
                torch.cuda.synchronize()
                row = opt8_compare(got, want, dtype, shape=list(shape), step=step, clip_scale=float(scale))
                rows.append(row)
                assert row["ok"], f"adamw8bit kernel vs plain: {row}"
            del p, st, got, want, g
    checks, norm_checks = k8.LAUNCHES - launches0, gn.LAUNCHES - norm_launches0
    print(f"[{card}] adamw8bit kernel vs plain: {len(rows)} clipped updates agree, "
          f"p max abs err {max(r['p_max_abs_err'] for r in rows):.3g}, "
          f"p bit-equal in {sum(r['p_bit_equal'] for r in rows)}, v codes apart on at most "
          f"{max(r['v_codes_apart_share'] for r in rows):.3g} of entries; their norms within "
          f"{max(norm_errs):.3g} of the plain version's", flush=True)

    tree = check_opt8_tree(card, k8, ref, gen, gn)
    for row in tree["checks"]:
        assert row["ok"], f"adamw8bit kernel vs plain on the {FULL_LAYERS}-layer tree: {row}"
    norm = tree["norm"]
    assert norm["ok"], f"the norm kernel vs plain on the {FULL_LAYERS}-layer tree: {norm}"
    print(f"[{card}] adamw8bit over the {FULL_LAYERS}-layer tree ({tree['leaves']} leaves, {tree['params']} params, "
          f"{tree['bytes']} bytes), clipped: kernel {tree['ms']:.4f} ms, plain {tree['plain_ms']:.4f} ms, "
          f"bound {tree['bound_ms']:.4f} ms ({tree['bound_by']}), {tree['bound_ms'] / tree['ms']:.1%} of it; "
          f"each leaf held to the plain version: p max abs err {tree['max_abs_err']:.3g}, p bit-equal in "
          f"{sum(r['p_bit_equal'] for r in tree['checks'])} of {len(tree['checks'])}", flush=True)
    print(f"[{card}] global norm over the tree ({norm['bytes']} bytes): kernel {norm['ms']:.4f} ms, plain "
          f"{norm['plain_ms']:.4f} ms, torch.linalg.vector_norm {norm['library_ms']:.4f} ms, bound "
          f"{norm['bound_ms']:.4f} ms ({norm['bound_by']}), {norm['bound_ms'] / norm['ms']:.1%} of it; norm "
          f"{norm['norm']:.6g} (plain {norm['plain_norm']:.6g}, rel err {norm['rel_err']:.3g}), scale "
          f"{norm['scale']:.6g}, bit-identical on a repeated call {norm['bit_identical']}; the optimizer phase "
          f"(norm + {tree['leaves']} updates) {tree['optimizer_ms']:.4f} ms", flush=True)
    assert np.isfinite(tree["ms"]) and tree["ms"] > 0
    out = {
        "checks": rows, "check_launches": checks, "norm_check_launches": norm_checks, "norm_rel_errs": norm_errs,
        "tree_checks": tree["checks"], "norm": norm, "optimizer_ms": tree["optimizer_ms"],
        "max_abs_err": max(r["p_max_abs_err"] for r in rows + tree["checks"]),
        "v_codes_apart_share": max(r["v_codes_apart_share"] for r in rows + tree["checks"]),
        "ok": all(r["ok"] for r in rows + tree["checks"]) and norm["ok"],
    }
    for key in ("leaves", "params", "bytes", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
        out[key] = tree[key]
    return out


def phase_train_grads(card, ref, mixer: dict, arch: str = "yi-6b", kind: str = "attn", attn=TRAIN_ATTN):
    """The trained model's first attention layer (``mixer``: its wq, wk,
    wv, wo, and qwen2's bq, bk, bv; a layer of ``kind``, with its window
    and softcap) at the training shape ``attn``: the gradients of a fixed
    random projection of its output with respect to a random x and the
    weights, through K1 forward + backward, against the same computation
    through the plain version on the card; each leaf's error relative to
    its largest element, within K1's bf16 tolerance."""
    import math

    import torch

    from repro_torch import configs
    from repro_torch.kernels.ops import attention_op
    from repro_torch.models import layers as L

    cfg = configs.get(arch)
    ap = cfg.attn_params(kind)
    b, s, h, kv, hd = attn
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    d = cfg.d_model
    leaves = {"x": randn(b, s, d), **{k: mixer[k] for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv") if k in mixer}}
    proj = randn(b, s, d)
    positions = torch.arange(s, device="cuda")

    def grads(kernel: bool):
        t = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
        q, k, v = L._project_qkv(t, t["x"], ap, positions)
        if kernel:
            out = attention_op(q, k, v, causal=True, window=ap.window, softcap=ap.softcap)
        else:
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            out = ref.mha(qt, kt.repeat_interleave(h // kv, 1), vt.repeat_interleave(h // kv, 1),
                          window=ap.window, softcap=ap.softcap).transpose(1, 2)
        y = L._out_proj(out, t["wo"])
        g = torch.autograd.grad((y.float() * proj.float()).sum(), list(t.values()))
        return dict(zip(t, g))

    got, want = grads(True), grads(False)
    torch.cuda.synchronize()
    rel = {k: float((got[k].float() - want[k].float()).abs().max() / want[k].float().abs().max()) for k in got}
    row = {"arch": arch, "kind": kind, "shape": list(attn), "window": ap.window, "softcap": ap.softcap, "rel_err": rel,
           "tol": BWD_TOL["bfloat16"]}
    print(f"[{card}] {arch} {kind} attention layer gradients, kernel vs plain {json.dumps(row)}", flush=True)
    assert all(math.isfinite(e) and e <= BWD_TOL["bfloat16"] for e in rel.values()), row
    return row


def check_ssd(card, ref, b, s, h, p, n, g, chunk, dtype, state, gen, timed, model_decays=False):
    """K2 vs its plain version on one input (model layout, grouped B/C);
    with ``timed`` also times both. Raises if they disagree.

    ``state`` is None (no initial state), "zero" (a zero f32 state, as the
    serving path's cache hands it) or "random". Both y and the final state
    are held to two criteria: the tests' error relative to
    max(|want|.max(), 1) below SSD_TOL, and, element by element,
    |got - want| <= SSD_TOL * (rms(want) + |want|), so that an error as
    large as a typical output fails wherever it lands. In bf16, dt is drawn
    on the bf16 grid: there the plain version's x * dt (dt rounded first,
    ``ref.py:62``) and the kernel's (the f32 product rounded once,
    ``ssd_scan.py:117``) are the same number, and what is left to differ is
    the kernel's own arithmetic and the rounding of y. Off the grid the two
    orders alone differ by about the tolerance."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ops import ssd_op

    wdt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x, bm, cm = randn(b, s, h, p).to(wdt), randn(b, s, g, n).to(wdt), randn(b, s, g, n).to(wdt)
    dt = F.softplus(randn(b, s, h)).to(wdt).float()
    # the model's decays (A_log = log(linspace(1, 16, H))), else the tests' draw
    A = -torch.linspace(1.0, 16.0, h, device="cuda") if model_decays else -torch.exp(randn(h))
    st0 = None
    if state == "zero":
        st0 = torch.zeros((b, h, n, p), device="cuda")
    elif state == "random":
        st0 = randn(b, h, n, p)
    rep = h // g
    br = bm.transpose(1, 2).repeat_interleave(rep, 1)
    cr = cm.transpose(1, 2).repeat_interleave(rep, 1)

    def kernel():
        return ssd_op(x, dt, A, bm, cm, st0, chunk=chunk)

    def plain():
        return ref.ssd(x.transpose(1, 2), dt.transpose(1, 2), A, br, cr, st0)

    y, st = kernel()
    yr, sr = plain()
    torch.cuda.synchronize()
    tol = SSD_TOL[dtype]
    row = {
        "b": b, "s": s, "h": h, "p": p, "n": n, "g": g, "chunk": chunk, "dtype": dtype,
        "init_state": state, "model_decays": model_decays, "tol": tol,
    }
    ok, errs = True, []
    for name, got, want in (("y", y.float(), yr.transpose(1, 2).float()), ("state", st, sr)):
        err = (got - want).abs()
        scale = float(want.square().mean().sqrt())
        errs.append(float(err.max()))
        row[f"rel_err_{name}"] = float(err.max()) / max(float(want.abs().max()), 1.0)
        row[f"scale_{name}"] = scale
        row[f"el_err_{name}"] = float((err / (scale + want.abs())).max())
        ok = ok and bool(torch.isfinite(got).all())
        ok = ok and row[f"rel_err_{name}"] < tol and row[f"el_err_{name}"] <= tol
    row["max_abs_err"], row["ok"] = max(errs), ok
    if timed:
        row["ms"] = time_ms(kernel, 20)
        row["plain_ms"] = time_ms(plain, 2)
        row["library_ms"] = None  # no single PyTorch call computes the SSD scan
        row["bound_ms"], row["bound_by"] = ssd_bound(b, h, g, s, p, n, chunk, dtype, st0 is not None)
    print(f"[{card}] ssd_scan {json.dumps(row)}", flush=True)
    if not ok:
        raise AssertionError(f"ssd_scan disagrees with its plain version: {row}")
    return row


def phase_ssd_kernel(card, ref):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    for b, s, h, p, n, g, chunk in SSD_SWEEP:
        for dtype in ("float32", "bfloat16"):
            rows.append(check_ssd(card, ref, b, s, h, p, n, g, chunk, dtype, "random", gen, False))
    # the teacher-forced forward's own shape
    rows.append(check_ssd(card, ref, 1, SSM_PROMPT_LEN + 15, 80, 64, 128, 1, 256, "bfloat16",
                          None, gen, False, model_decays=True))
    # the serving path's calls: one per layer, the wave's 4 prompts, the
    # model's decays, the zero initial state from the cache; in f32 as the
    # f32-activation run gives it, and in bf16, timed
    rows.append(check_ssd(card, ref, WAVE_REQUESTS, SSM_PROMPT_LEN, 80, 64, 128, 1, 256, "float32",
                          "zero", gen, False, model_decays=True))
    main = check_ssd(card, ref, WAVE_REQUESTS, SSM_PROMPT_LEN, 80, 64, 128, 1, 256, "bfloat16",
                     "zero", gen, True, model_decays=True)
    return rows, main


SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dst0")


def check_ssd_bwd(card, K, ref, b, s, h, p, n, g, chunk, dtype, state, gen, timed, model_decays=False):
    """K2's backward against the plain version (``ref.ssd_bwd``, autograd
    through ``ref.ssd``) on one input in the model's layout: every
    gradient (dx, ddt, dA, dB, dC and, with ``state``, d(initial state),
    for a random initial state and d(final state)) within SSD_TOL of its
    largest element, finite, and the same bits on a second call. With
    ``timed`` also times both. dt is drawn on the bf16 grid in bf16, as in
    check_ssd. Raises if they disagree."""
    import torch
    import torch.nn.functional as F

    wdt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x, bm, cm = randn(b, s, h, p).to(wdt), randn(b, s, g, n).to(wdt), randn(b, s, g, n).to(wdt)
    dt = F.softplus(randn(b, s, h)).to(wdt).float()
    A = -torch.linspace(1.0, 16.0, h, device="cuda") if model_decays else -torch.exp(randn(h))
    dy = randn(b, s, h, p).to(wdt)
    st0, dsf = (randn(b, h, n, p), randn(b, h, n, p)) if state else (None, None)
    args = (x.transpose(1, 2), dt.transpose(1, 2), A, bm.transpose(1, 2), cm.transpose(1, 2), st0,
            dy.transpose(1, 2), dsf)

    def kernel():
        return K.ssd_scan_bwd(*args, chunk=chunk)

    def plain():
        return ref.ssd_bwd(*args)

    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    tol = SSD_TOL[dtype]
    pairs = [(name, gv.float(), wv.float()) for name, gv, wv in zip(SSD_GRADS, got, want) if wv is not None]
    rel = {name: float((gv - wv).abs().max() / wv.abs().max()) for name, gv, wv in pairs}
    same = all(torch.equal(u, v) for u, v in zip(got, again) if u is not None)
    ok = all(bool(torch.isfinite(gv).all()) for _, gv, _ in pairs) and max(rel.values()) <= tol and same
    row = {
        "b": b, "s": s, "h": h, "p": p, "n": n, "g": g, "chunk": chunk, "dtype": dtype, "state": state,
        "model_decays": model_decays, "rel_err": rel, "tol": tol, "bit_identical": same,
        "max_abs_err": max(float((gv - wv).abs().max()) for _, gv, wv in pairs), "ok": ok,
    }
    del got, again, want, pairs
    if timed:
        row["ms"] = time_ms(kernel, 10)
        row["plain_ms"] = time_ms(plain, 1)
        row["library_ms"] = None  # no single PyTorch call computes the SSD scan's gradients
        row["bound_ms"], row["bound_by"] = ssd_bwd_bound(b, h, g, s, p, n, chunk, dtype, state)
    print(f"[{card}] ssd_scan_bwd {json.dumps(row)}", flush=True)
    if not ok:
        raise AssertionError(f"ssd_scan_bwd disagrees with its plain version: {row}")
    return row


def phase_ssd_kernel_bwd(card, K, ref):
    """K2's backward at SSD_SWEEP's shapes in f32 and bf16 with a random
    initial state and d(final state); then the training path's own call
    (SSD_TRAIN, bf16, the model's decays, no state), timed, with K2's
    forward at that call timed beside it. Returns (rows, the backward's
    timed row, the forward's timed row)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rows = []
    for b, s, h, p, n, g, chunk in SSD_SWEEP:
        for dtype in ("float32", "bfloat16"):
            rows.append(check_ssd_bwd(card, K, ref, b, s, h, p, n, g, chunk, dtype, True, gen, False))
    b, s, h, p, n, g, chunk = SSD_TRAIN
    main = check_ssd_bwd(card, K, ref, b, s, h, p, n, g, chunk, "bfloat16", False, gen, True, model_decays=True)
    gc.collect()
    torch.cuda.empty_cache()
    fwd = check_ssd(card, ref, b, s, h, p, n, g, chunk, "bfloat16", None, gen, True, model_decays=True)
    return rows, main, fwd


def phase_train_ssm_grads(card, ref, mixer: dict):
    """The trained mamba2's first mixer layer (``mixer``: its weights) at
    the training shape: the gradients of a fixed random projection of its
    output with respect to a random x and every weight of the layer,
    through K2 forward + backward (``ssd_op`` under grad), against the
    same computation with the plain ``ref.ssd`` in the scan's place; each
    leaf's error relative to its largest element, within K2's bf16
    tolerance."""
    import math
    from unittest import mock

    import torch

    from repro_torch import configs
    from repro_torch.models import ssm as M

    cfg = configs.get("mamba2-2.7b")
    sp = cfg.ssm
    b, s = TRAIN_BATCH, TRAIN_SEQ
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    leaves = {"x": randn(b, s, cfg.d_model), **mixer}
    proj = randn(b, s, cfg.d_model)

    def plain_ssd_op(x, dt, A, Bm, Cm, init_state=None, *, chunk):
        rep = x.shape[2] // Bm.shape[2]
        y, st = ref.ssd(x.transpose(1, 2), dt.float().transpose(1, 2), A.float(),
                        Bm.transpose(1, 2).repeat_interleave(rep, 1), Cm.transpose(1, 2).repeat_interleave(rep, 1),
                        init_state)
        return y.transpose(1, 2), st

    def grads(kernel: bool):
        t = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
        p = {k: v for k, v in t.items() if k != "x"}
        with mock.patch.object(M, "ssd_op", M.ssd_op if kernel else plain_ssd_op):
            y, _ = M.ssm_mixer(p, t["x"], sp, norm_eps=cfg.norm_eps)
        g = torch.autograd.grad((y.float() * proj.float()).sum(), list(t.values()))
        return dict(zip(t, g))

    got = grads(True)
    gc.collect()
    torch.cuda.empty_cache()
    want = grads(False)
    torch.cuda.synchronize()
    rel = {k: float((got[k].float() - want[k].float()).abs().max() / want[k].float().abs().max()) for k in got}
    row = {"shape": [b, s, cfg.d_model], "rel_err": rel, "tol": SSD_TOL["bfloat16"]}
    print(f"[{card}] mamba2 mixer layer gradients, kernel vs plain {json.dumps(row)}", flush=True)
    assert all(math.isfinite(e) and e <= SSD_TOL["bfloat16"] for e in rel.values()), row
    return row


def serving_setup(arch: str = "yi-6b", layers: int | None = None, policy=None):
    """The served workload: full-width ``arch`` (yi-6b, qwen2-7b,
    mistral-large-123b or qwen3-moe-30b-a3b; ``layers`` of its layers where
    given) with random weights from SEED (bf16, or int8 under ``policy``)
    behind ``serving_engine``'s engine and topic. Returns (cfg, model,
    engine, log, requests)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy

    cfg = configs.get(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = StreamModel(cfg, Policy() if policy is None else policy, device="cuda", generator=SEED)
    return (cfg, model) + serving_engine(cfg, model)


def serving_engine(cfg, model):
    """A ContinuousLMEngine over ``model`` (4 slots, blocks of BLOCK),
    warmed up by one short request, and a request topic holding one
    request per PROMPT_LENS entry. Returns (engine, log, requests)."""
    import numpy as np

    from repro_torch.core.log import StreamLog
    from repro_torch.serve.lm_engine import ContinuousLMEngine, Request, encode_request, tenant_key

    max_blocks = -(-(max(PROMPT_LENS) + MAX_NEW - 1) // BLOCK)
    engine = ContinuousLMEngine(
        model, n_slots=4, n_blocks=4 * max_blocks + 1, block_size=BLOCK,
        max_blocks=max_blocks, device="cuda",
    )
    rng = np.random.default_rng(SEED)
    # warm-up request outside the measured run (library handles, allocator)
    engine.submit(Request(-1, rng.integers(0, cfg.vocab, 64).astype(np.int32), 2))
    engine.run_until_drained()
    engine.first_token_s.clear()

    log = StreamLog()
    log.create_topic("lm-requests")
    reqs = [
        Request(i, rng.integers(0, cfg.vocab, n).astype(np.int32), MAX_NEW, tenant=i % 2)
        for i, n in enumerate(PROMPT_LENS)
    ]
    for r in reqs:
        log.produce("lm-requests", encode_request(r), key=tenant_key(r.tenant))
    return engine, log, reqs


def phase_serve(card, kernels: dict, arch: str = "yi-6b", layers: int | None = None):
    """Serve ``serving_setup(arch, layers)``'s topic through the
    ContinuousLMEngine and check what comes back (``serve_requests``).
    Returns (numbers, cfg, model)."""
    import torch

    t0 = time.perf_counter()
    cfg, model, engine, log, reqs = serving_setup(arch, layers)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[{card}] {arch} full width: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{n_params} params bf16, set-up and warm-up {setup_s:.3f} s", flush=True)
    out = serve_requests(card, kernels, arch, cfg, model, engine, log, reqs)
    out["params"] = n_params
    del engine  # the model stays for the serving group's phase
    return out, cfg, model


def serve_requests(card, kernels: dict, tag: str, cfg, model, engine, log, reqs, greedy: bool = True) -> dict:
    """Serve the request topic through ``engine`` and check what comes
    back: every request once, its tenant, MAX_NEW tokens each, K1 launched
    once a layer a request (the prefills) and nothing else, and with
    ``greedy`` each served token within GREEDY_SLACK of the teacher-forced
    forward's greedy choice. Returns the numbers."""
    import torch

    from repro_torch.serve.lm_engine import decode_completion, serve_stream

    torch.cuda.reset_peak_memory_stats()

    reset_counts(kernels)
    t_start = time.perf_counter()
    served = serve_stream(engine, log, "lm-requests", "lm-completions")
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = kernels["flash_attention"].LAUNCHES
    others = {name: n for name, n in read_counts(kernels).items() if name != "flash_attention"}
    assert not any(others.values()), others

    peak = torch.cuda.max_memory_allocated()
    got = {}
    batch = log.read("lm-completions", 0, 0, 64)
    for buf in batch.values:
        rid, tenant, gen = decode_completion(buf)
        assert tenant == rid % 2, (rid, tenant)
        got[rid] = gen
    assert served == len(reqs) and sorted(got) == [r.req_id for r in reqs], (served, sorted(got))
    for r in reqs:
        g = got[r.req_id]
        assert len(g) == MAX_NEW and ((g >= 0) & (g < cfg.vocab_padded)).all(), (r.req_id, g)
    want_launches = cfg.n_layers * len(reqs)
    assert launches == want_launches, f"flash_attention launched {launches}, want {want_launches}"

    # each served token must be a greedy choice of the teacher-forced
    # forward, up to bf16 near-ties
    worst = None
    if greedy:
        worst = greedy_worst_gap(model, reqs, got)
        assert worst <= GREEDY_SLACK, f"served tokens trail the forward's greedy choice by {worst}"

    firsts = [engine.first_token_s[r.req_id] for r in reqs]
    ttft = [(t - t_start) * 1e3 for t in firsts]
    prefill = [(b - a) * 1e3 for a, b in zip([t_start] + firsts[:-1], firsts)]
    decode_tokens = len(reqs) * (MAX_NEW - 1)
    decode_s = t_end - max(firsts)
    out = {
        "arch": cfg.name, "layers": cfg.n_layers,
        "requests": len(reqs), "prompt_lens": list(PROMPT_LENS), "max_new": MAX_NEW,
        "prefill_ms": prefill, "ttft_ms": ttft, "decode_tokens": decode_tokens,
        "decode_s": decode_s, "decode_tokens_per_s": decode_tokens / decode_s,
        "total_s": t_end - t_start, "peak_bytes": peak, "launches": launches,
        "greedy_worst_gap": worst,
    }
    for i, r in enumerate(reqs):
        print(f"[{card}] {tag} request {r.req_id}: prompt {len(r.prompt)}, prefill {prefill[i]:.3f} ms, "
              f"TTFT {ttft[i]:.3f} ms", flush=True)
    print(f"[{card}] {tag} decode {decode_tokens} tokens in {decode_s:.4f} s: "
          f"{decode_tokens / decode_s:.3f} tokens/s", flush=True)
    print(f"[{card}] {tag} peak device memory {peak} bytes; flash_attention launches {launches}"
          + (f"; greedy gap worst {worst:.4f}" if greedy else ""), flush=True)
    return out


def greedy_worst_gap(model, reqs, got: dict) -> float:
    """How far the served tokens trail the greedy choice of the
    teacher-forced full-sequence forward (prefill attention through the
    kernel, against decode attention through the paged cache): the
    largest gap in logits over every token of every request."""
    import numpy as np
    import torch

    worst = 0.0
    for r in reqs:
        seq = np.concatenate([r.prompt, got[r.req_id][:-1]])
        logits = model(torch.from_numpy(seq[None].astype(np.int64)).cuda())[0, len(r.prompt) - 1:]
        assert bool(torch.isfinite(logits).all())
        served_tok = torch.from_numpy(got[r.req_id].astype(np.int64)).cuda()
        gap = logits.max(-1).values - logits.gather(-1, served_tok[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        del logits
    return worst


def model_bytes(model) -> dict:
    """A model's bytes on the card: int8 codes, their f32 scales, and the
    float leaves (embed, unembed and what ``quantize_params`` leaves)."""
    bufs = dict(model.named_buffers())
    codes = sum(b.numel() for n, b in bufs.items() if n.endswith(".q8"))
    scales = sum(b.numel() * b.element_size() for n, b in bufs.items() if n.endswith(".scale"))
    floats = sum(p.numel() * p.element_size() for p in model.parameters())
    return {"codes": codes, "scales": scales, "float_leaves": floats, "total": codes + scales + floats}


def set_capacity_factor(model, factor: float):
    """The model's MoE capacity factor (no weight depends on it); returns
    the config it runs under."""
    import dataclasses

    model.cfg = dataclasses.replace(model.cfg, moe=dataclasses.replace(model.cfg.moe, capacity_factor=factor))
    return model.cfg


def phase_serve_moe(card, kernels: dict):
    """qwen3-moe-30b-a3b at all 48 layers with int8 weights (the fp8 KV
    cache in its policy) behind the ContinuousLMEngine: first at the
    published capacity factor (``serve_requests`` without the greedy check:
    a call's capacity counts its own tokens, so a prefill, a decode step of
    the slots and a teacher-forced forward drop different routes), then
    with the same weights at MOE_PARITY_FACTOR, where no route can drop
    (the phase counts them in the serve and the teacher-forced forwards),
    every served token within GREEDY_SLACK of the teacher-forced int8
    forward's greedy choice. Returns (numbers, cfg, model at
    MOE_PARITY_FACTOR: kept for ``phase_fp8_cache``)."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.policy import Policy

    t0 = time.perf_counter()
    cfg, model, engine, log, reqs = serving_setup(
        MOE, policy=Policy(weights_int8=True, kv_cache_dtype="float8_e4m3fn"))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    nbytes = model_bytes(model)
    print(f"[{card}] {MOE} full width, int8: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.moe.n_experts} experts "
          f"top-{cfg.moe.top_k}; bytes {nbytes}; set-up (layer by layer) and warm-up {setup_s:.3f} s, "
          f"allocated {torch.cuda.memory_allocated()} bytes", flush=True)
    moe.DROPS = torch.zeros((), dtype=torch.int64, device="cuda")
    try:
        out = serve_requests(card, kernels, f"{MOE} int8 factor {cfg.moe.capacity_factor}", cfg, model, engine,
                             log, reqs, greedy=False)
        out["dropped_routes"] = int(moe.DROPS)
        del engine
        parity_cfg = set_capacity_factor(model, MOE_PARITY_FACTOR)
        engine, log, reqs = serving_engine(parity_cfg, model)
        moe.DROPS.zero_()
        out["parity"] = serve_requests(card, kernels, f"{MOE} int8 factor {MOE_PARITY_FACTOR}", parity_cfg, model,
                                       engine, log, reqs, greedy=True)
        out["parity"]["dropped_routes"] = dropped = int(moe.DROPS)
        assert dropped == 0, f"{dropped} routes dropped at capacity factor {MOE_PARITY_FACTOR}"
        del engine
    finally:
        moe.DROPS = None
    print(f"[{card}] {MOE} int8: {out['dropped_routes']} routes dropped at factor {cfg.moe.capacity_factor}, "
          f"0 at {MOE_PARITY_FACTOR} (serve and teacher-forced forwards)", flush=True)
    out.update(bytes=nbytes, setup_s=setup_s)
    return out, parity_cfg, model


def phase_fp8_cache(card, cfg, model) -> dict:
    """The fp8 KV cache on the full-width int8 model (at the capacity
    factor it was left at): FP8_BATCH prompts of FP8_PROMPT tokens,
    prefill and FP8_STEPS decode steps on an f32 cache, greedy, then the
    same tokens teacher-forced through an fp8 contiguous cache
    (``prefill(cache_dtype=float8_e4m3fn)``) and an fp8 paged one
    (``init_paged_cache`` under the policy's fp8 dtype, each row prefilled
    alone and admitted by ``paged_insert``). Every logit finite, the first
    step's argmax agreement with the f32 run at least
    FP8_FIRST_AGREE_MIN."""
    import numpy as np
    import torch

    fp8 = torch.float8_e4m3fn
    rng = np.random.default_rng(SEED + 2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (FP8_BATCH, FP8_PROMPT))).cuda()
    s_cache = FP8_PROMPT + FP8_STEPS
    t0 = time.perf_counter()
    lg, cache = model.prefill(toks, s_cache, cache_dtype=torch.float32)
    want, feed = [], []
    tok = lg.argmax(-1)[:, None]
    for _ in range(FP8_STEPS):
        feed.append(tok)
        lg, cache = model.decode_step(cache, tok)
        want.append(lg[:, 0])
        tok = lg[:, 0].argmax(-1)[:, None]
    torch.cuda.synchronize()
    f32_s = time.perf_counter() - t0
    del cache

    def compare(got: list) -> dict:
        got, ref = torch.stack(got), torch.stack(want)
        assert bool(torch.isfinite(got).all()), "an fp8-cache logit is not finite"
        agree = (got.argmax(-1) == ref.argmax(-1)).float()
        return {"first_step_agree": float(agree[0].mean()), "agree": float(agree.mean()),
                "max_logit_gap": float((got - ref).abs().max())}

    t0 = time.perf_counter()
    _, cache = model.prefill(toks, s_cache, cache_dtype=fp8)
    assert cache["slots"]["s0"]["k"].dtype == fp8
    got = []
    for t in feed:
        lg, cache = model.decode_step(cache, t)
        got.append(lg[:, 0])
    torch.cuda.synchronize()
    contiguous = compare(got) | {"s": time.perf_counter() - t0}
    del cache

    t0 = time.perf_counter()
    nb = -(-s_cache // BLOCK)
    pool = model.init_paged_cache(FP8_BATCH, FP8_BATCH * nb + 1, BLOCK, nb)
    assert pool["slots"]["s0"]["k"].dtype == fp8, pool["slots"]["s0"]["k"].dtype
    for row in range(FP8_BATCH):
        _, small = model.prefill(toks[row : row + 1], nb * BLOCK, cache_dtype=fp8)
        ids = list(range(1 + row * nb, 1 + (row + 1) * nb))
        model.paged_insert(pool, small, row, ids, ids, FP8_PROMPT)
    got = []
    for t in feed:
        lg, pool = model.decode_step(pool, t)
        got.append(lg[:, 0])
    torch.cuda.synchronize()
    paged = compare(got) | {"s": time.perf_counter() - t0}
    del pool

    per_token = {dt: 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * size for dt, size in (("fp8", 1), ("f32", 4))}
    out = {"batch": FP8_BATCH, "prompt": FP8_PROMPT, "steps": FP8_STEPS, "f32_s": f32_s,
           "contiguous": contiguous, "paged": paged, "cache_bytes_per_token": per_token}
    for name, r in (("contiguous", contiguous), ("paged", paged)):
        print(f"[{card}] {MOE} int8, fp8 {name} cache ({FP8_BATCH} x {FP8_PROMPT}, {FP8_STEPS} steps) against f32: "
              f"first-step argmax agreement {r['first_step_agree']:.4f}, all steps {r['agree']:.4f}, "
              f"largest logit gap {r['max_logit_gap']:.4f}, {r['s']:.3f} s", flush=True)
        assert r["first_step_agree"] >= FP8_FIRST_AGREE_MIN, (name, r)
    print(f"[{card}] {MOE} KV cache bytes a token: fp8 {per_token['fp8']}, f32 {per_token['f32']}", flush=True)
    return out


def phase_int8_vs_bf16(card) -> dict:
    """qwen3-moe-30b-a3b's full width cut to MOE_BF16_LAYERS layers at
    MOE_PARITY_FACTOR: a bf16 model from SEED and an int8 one holding
    ``quantize_params`` of its tree, on one batch of MOE_BF16_BATCH tokens;
    the softmaxes' total variation and the argmax agreement held to
    INT8_TV_MAX and INT8_AGREE_MIN, no route dropped."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models.model import StreamModel, quantize_params
    from repro_torch.models.policy import Policy

    cfg = configs.get(MOE)
    cfg = dataclasses.replace(cfg, n_layers=MOE_BF16_LAYERS,
                              moe=dataclasses.replace(cfg.moe, capacity_factor=MOE_PARITY_FACTOR))
    t0 = time.perf_counter()
    bf = StreamModel(cfg, Policy(), device="cuda", generator=SEED)
    q8 = StreamModel(cfg, Policy(weights_int8=True), device="cuda", generator=None)
    q8.load_params(quantize_params(bf.param_tree()))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    toks = torch.from_numpy(np.random.default_rng(SEED + 3).integers(0, cfg.vocab, MOE_BF16_BATCH)).cuda()
    moe.DROPS = torch.zeros((), dtype=torch.int64, device="cuda")
    try:
        pf = torch.softmax(bf(toks), -1)
        pq = torch.softmax(q8(toks), -1)
        dropped = int(moe.DROPS)
    finally:
        moe.DROPS = None
    assert dropped == 0, f"{dropped} routes dropped at capacity factor {MOE_PARITY_FACTOR}"
    tv = float(0.5 * (pf - pq).abs().sum(-1).mean())
    agree = float((pf.argmax(-1) == pq.argmax(-1)).float().mean())
    out = {"layers": cfg.n_layers, "batch": list(MOE_BF16_BATCH), "tv": tv, "argmax_agree": agree,
           "bf16_bytes": model_bytes(bf), "int8_bytes": model_bytes(q8), "setup_s": setup_s}
    print(f"[{card}] {MOE} cut to {cfg.n_layers} layers, int8 against bf16 on {MOE_BF16_BATCH}: total variation "
          f"{tv:.6f} (bound {INT8_TV_MAX}), argmax agreement {agree:.6f} (bound {INT8_AGREE_MIN}); bytes bf16 "
          f"{out['bf16_bytes']['total']}, int8 {out['int8_bytes']['total']}", flush=True)
    assert tv < INT8_TV_MAX and agree > INT8_AGREE_MIN, out
    return out


def group_setup(cfg, model):
    """The serving group's workload: a BrokerCluster(3) holding a request
    and a response topic of GROUP_PARTITIONS partitions each at
    replication factor 3, an LMServingGroup of GROUP_WORKERS
    transactional workers, each a ContinuousLMEngine over ``model`` sized
    as ``serving_setup``'s and warmed up by one short request outside the
    topic, and the requests: PROMPT_LENS twice, tenant ``i % 4``.
    Returns (cluster, group, requests)."""
    import numpy as np

    from repro_torch.core.cluster import BrokerCluster
    from repro_torch.core.log import LogConfig
    from repro_torch.serve.lm_engine import ContinuousLMEngine, LMServingGroup, Request

    max_blocks = -(-(max(PROMPT_LENS) + MAX_NEW - 1) // BLOCK)
    rng = np.random.default_rng(SEED + 4)
    engines = []
    for _ in range(GROUP_WORKERS):
        engine = ContinuousLMEngine(
            model, n_slots=4, n_blocks=4 * max_blocks + 1, block_size=BLOCK,
            max_blocks=max_blocks, device="cuda",
        )
        engine.submit(Request(-1, rng.integers(0, cfg.vocab, 64).astype(np.int32), 2))
        engine.run_until_drained()
        engine.first_token_s.clear()
        engines.append(engine)

    cluster = BrokerCluster(3, default_acks="all")
    for topic in ("lm-req", "lm-resp"):
        cluster.create_topic(topic, LogConfig(num_partitions=GROUP_PARTITIONS, replication_factor=3))
    group = LMServingGroup(cluster, engines, input_topic="lm-req", response_topic="lm-resp", transactional=True)
    reqs = [
        Request(i, rng.integers(0, cfg.vocab, n).astype(np.int32), MAX_NEW, tenant=i % 4)
        for i, n in enumerate(PROMPT_LENS * 2)
    ]
    return cluster, group, reqs


def committed_records(cluster, topic: str, part: int) -> list[bytes]:
    """Read-committed audit of one partition: its records up to its end,
    or as far as they could be read. A partition whose leader is being
    elected reads as not there yet."""
    from repro_torch.core.cluster import ClusterError

    out, off = [], 0
    try:
        end = cluster.end_offset(topic, part)
        while off < end:
            batch = cluster.read(topic, part, off, 256, isolation="read_committed")
            out.extend(bytes(v) for v in batch.values)
            off = batch.next_offset
    except ClusterError:
        pass
    return out


def committed_completions(cluster) -> tuple[dict, dict]:
    """Read-committed audit of the response topic: req_id -> (tenant,
    tokens), and how often each req_id appears."""
    from repro_torch.serve.lm_engine import decode_completion

    got, counts = {}, {}
    for part in range(GROUP_PARTITIONS):
        for buf in committed_records(cluster, "lm-resp", part):
            rid, tenant, gen = decode_completion(buf)
            got[rid] = (tenant, gen)
            counts[rid] = counts.get(rid, 0) + 1
    return got, counts


def phase_serve_group(card, kernels: dict, cfg, model):
    """Serve ``group_setup``'s requests through the LMServingGroup across a
    broker failover, as tests/test_serving_chaos.py does: half of them,
    then the response partition 0's leader is killed while replication
    runs, and the rest are served under controller ticks until all are in
    the read_committed view. Every request must come back exactly once,
    each token a greedy choice of the forward within GREEDY_SLACK; K1
    launches once a layer per prefill, and a request re-served after an
    aborted transaction is prefilled again."""
    import torch

    from repro_torch.core.cluster import ClusterError
    from repro_torch.serve.lm_engine import encode_request, tenant_key

    t0 = time.perf_counter()
    cluster, group, reqs = group_setup(cfg, model)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"[{card}] yi-6b serving group: {GROUP_WORKERS} transactional workers, {GROUP_PARTITIONS} "
          f"partitions at replication factor 3 on 3 brokers, set-up and warm-up {setup_s:.3f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    half = len(reqs) // 2

    reset_counts(kernels)
    t_start = time.perf_counter()
    for r in reqs[:half]:
        cluster.produce("lm-req", encode_request(r), key=tenant_key(r.tenant))
    first_served = group.poll_all()
    torch.cuda.synchronize()
    t_kill = time.perf_counter()
    cluster.start_replication(interval_s=0.002, workers=2)
    try:
        killed = cluster.leader_for("lm-resp", 0)
        cluster.kill_broker(killed)
        for r in reqs[half:]:
            cluster.produce("lm-req", encode_request(r), key=tenant_key(r.tenant))
        deadline = time.monotonic() + GROUP_DEADLINE_S
        ticks = cluster_errors = 0
        while True:
            if time.monotonic() > deadline:
                raise AssertionError(f"the serving group did not serve all {len(reqs)} requests "
                                     f"within {GROUP_DEADLINE_S} s of the broker kill")
            ticks += 1
            cluster.controller_tick()
            try:
                group.poll_all()
            except ClusterError:
                cluster_errors += 1
                continue  # election window: abort and rewind, retry the tick
            got, counts = committed_completions(cluster)
            if len(got) == len(reqs):
                break
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        cluster.stop_replication()
    launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
    assert kernels["flash_attention"].BWD_LAUNCHES == kernels["ssd_scan"].BWD_LAUNCHES == 0, \
        "serving launched a backward"
    peak = torch.cuda.max_memory_allocated()

    assert sorted(got) == [r.req_id for r in reqs], sorted(got)
    dups = {rid: n for rid, n in counts.items() if n != 1}
    assert not dups, f"completions published more than once: {dups}"
    for r in reqs:
        tenant, g = got[r.req_id]
        assert tenant == r.tenant, (r.req_id, tenant)
        assert len(g) == MAX_NEW and ((g >= 0) & (g < cfg.vocab_padded)).all(), (r.req_id, g)
    attn = launches.pop("flash_attention")
    assert not any(launches.values()), launches
    assert attn % cfg.n_layers == 0 and attn >= cfg.n_layers * len(reqs), (
        f"flash_attention launched {attn}, want a multiple of {cfg.n_layers} of at least "
        f"{cfg.n_layers * len(reqs)}")
    reserved = attn // cfg.n_layers - len(reqs)
    admissions = [w.engine.admissions - 1 for w in group.workers]  # less each warm-up
    assert sum(admissions) == attn // cfg.n_layers, (admissions, attn)
    worst = greedy_worst_gap(model, reqs, {rid: g for rid, (_, g) in got.items()})
    assert worst <= GREEDY_SLACK, f"served tokens trail the forward's greedy choice by {worst}"

    served = {w.worker_id: w.served for w in group.workers}
    out = {
        "requests": len(reqs), "prompt_lens": list(PROMPT_LENS) * 2, "max_new": MAX_NEW,
        "workers": GROUP_WORKERS, "partitions": GROUP_PARTITIONS, "brokers": 3, "killed_broker": killed,
        "first_half_s": t_kill - t_start, "second_half_s": t_end - t_kill, "total_s": t_end - t_start,
        "first_half_served": first_served, "served": served, "reserved": reserved, "ticks": ticks,
        "cluster_errors": cluster_errors, "admissions": admissions,
        "peak_bytes": peak, "launches": attn, "greedy_worst_gap": worst,
    }
    print(f"[{card}] yi-6b group first half: {half} requests, {first_served} served in "
          f"{t_kill - t_start:.4f} s", flush=True)
    print(f"[{card}] yi-6b group second half: broker {killed} (leader of lm-resp/0) killed, "
          f"{len(reqs) - half} more requests, all {len(reqs)} committed exactly once after "
          f"{t_end - t_kill:.4f} s, {ticks} ticks, {cluster_errors} cluster errors", flush=True)
    print(f"[{card}] yi-6b group completions per worker {served}; re-served requests {reserved}", flush=True)
    print(f"[{card}] yi-6b group peak device memory {peak} bytes; flash_attention launches {attn}; "
          f"greedy worst gap {worst:.4f} (slack {GREEDY_SLACK})", flush=True)
    return out


def copd_setup(log, reg, topic: str, n_models: int = 1, training_kwargs=None):
    """``n_models`` registered copd-mlp models in one configuration, its
    training deployment, and the synthetic HCOPD stream ingested for it
    into ``topic`` (2 partitions at replication factor 3) by two
    idempotent producer threads (validation_rate 0.2). Returns (specs,
    deployment, dataset, message)."""
    from repro_torch.configs import copd_mlp
    from repro_torch.core.log import LogConfig
    from repro_torch.data import ingest
    from repro_torch.data.formats import AvroCodec, FieldSpec

    specs = [reg.register_model("copd-mlp") for _ in range(n_models)]
    dep = reg.deploy(reg.create_configuration([s.model_id for s in specs]).config_id, "train",
                     training_kwargs=training_kwargs)
    codec = AvroCodec([FieldSpec("data", "float32", (copd_mlp.N_FEATURES,))], [FieldSpec("label", "int32", ())])
    log.create_topic(topic, LogConfig(num_partitions=2, replication_factor=3))
    dataset = copd_mlp.synth_dataset()
    msg = ingest(log, topic, codec, dataset, dep.deployment_id, validation_rate=0.2, num_threads=2, idempotent=True)
    return specs, dep, dataset, msg


def match_rows(got, want, tol: float) -> list[int]:
    """For each row of ``got``, the one row of ``want`` within ``tol`` of
    it (max abs difference); raises if a row has none or several."""
    import numpy as np

    dist = np.abs(got[:, None, :] - want[None, :, :]).max(-1)
    near = dist <= tol
    if not (near.sum(1) == 1).all():
        raise AssertionError(f"rows without exactly one match within {tol}: {np.flatnonzero(near.sum(1) != 1)}")
    return [int(i) for i in near.argmax(1)]


def phase_paper_loop(card, kernels: dict):
    """The paper's loop on the card, as examples/torch_quickstart.py runs
    it: copd-mlp trained from a stream on a BrokerCluster(3) (Algorithm 1)
    and served by a 2-replica InferenceDeployment (Algorithm 2); then a
    transactional deployment on fresh topics across a kill of the
    predictions topic's leader; then the Supervisor (§IV-B) over a
    2-model configuration whose first job crashes once. The copd model
    launches no kernel of the port; the counts are held at 0."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import copd_mlp
    from repro_torch.core import METRICS_TOPIC, BrokerCluster, Registry, Supervisor
    from repro_torch.core.cluster import ClusterError
    from repro_torch.core.log import LogConfig
    from repro_torch.serve import InferenceDeployment
    from repro_torch.train import TrainingJob, adamw

    reset_counts(kernels)
    t0 = time.perf_counter()
    log, reg = BrokerCluster(3), Registry()
    reporter = log.start_metrics_reporter(interval_s=0.25)
    (spec,), dep, dataset, msg = copd_setup(log, reg, "copd")
    stamps = []

    def loss_fn(p, batch):
        if torch.is_grad_enabled():
            stamps.append(time.perf_counter())  # the step's start: the job syncs on each step's loss
        return copd_mlp.loss_fn(p, batch)

    job = TrainingJob(log, reg, dep.deployment_id, spec.model_id, loss_fn=loss_fn, init_fn=copd_mlp.init,
                      opt=adamw(COPD_LR), device="cuda")
    t_train = time.perf_counter()
    res = job.run(batch_size=COPD_BATCH, epochs=COPD_EPOCHS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t_train
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    med_ms = sorted(step_ms[1:])[len(step_ms[1:]) // 2]  # step 0 warms up
    uploaded = reg.results_for(dep.deployment_id)
    print(f"[{card}] copd-mlp: {msg.total_msg} records, {res.steps} steps of {COPD_BATCH} in {train_s:.3f} s, "
          f"median step {med_ms:.3f} ms ({1e3 / med_ms:.1f} steps/s); trained {res.metrics}, eval {res.eval_metrics}",
          flush=True)
    assert res.eval_metrics["accuracy"] > 0.9, res.eval_metrics  # tests/test_system.py:17
    assert len(uploaded) == 1 and uploaded[0].metrics["loss"] < 0.5, uploaded

    # Algorithm 2: 2 replicas, one request partition each
    params = job._final_state["params"]
    cpu_params = {k: v.detach().cpu() for k, v in params.items()}
    log.create_topic("requests", LogConfig(num_partitions=2))
    infer = InferenceDeployment(log, reg, uploaded[0].result_id,
                                predict_fn=lambda d: copd_mlp.predict(params, d["data"]),
                                input_topic="requests", output_topic="predictions", replicas=2)
    reqs = dataset["data"][:COPD_REQUESTS]
    half = COPD_REQUESTS // 2
    log.produce_batch("requests", [r.tobytes() for r in reqs[:half]], partition=0)
    log.produce_batch("requests", [r.tobytes() for r in reqs[half:]], partition=1)
    t_drain = time.perf_counter()
    served = infer.drain()
    drain_s = time.perf_counter() - t_drain
    infer.close()
    log.stop_metrics_reporter()
    lag = sum(sum(r.consumer.lag().values()) for r in infer.replicas if r.alive)
    n_preds = log.end_offset("predictions", 0)
    preds = log.read("predictions", 0, 0, 4 * COPD_REQUESTS).to_matrix().view(np.float32)
    want = copd_mlp.predict(cpu_params, reqs).numpy()  # replica order: partition 0's batch, then 1's
    pred_err = float(np.abs(preds - want).max())
    acc = float((preds.argmax(1) == dataset["label"][:COPD_REQUESTS]).mean())
    print(f"[{card}] copd-mlp served {served} predictions via 2 replicas in {drain_s:.4f} s; lag {lag}; accuracy "
          f"{acc:.2f}; max abs error against the CPU forward {pred_err:.3g} (tol {COPD_PRED_TOL}); "
          f"{reporter.published} metrics snapshots on {METRICS_TOPIC}", flush=True)
    assert served == n_preds == COPD_REQUESTS and preds.shape == want.shape, (served, n_preds, preds.shape)
    assert lag == 0, lag
    assert pred_err <= COPD_PRED_TOL, pred_err

    # the same model behind a transactional deployment on fresh topics, the
    # predictions topic's leader killed between two drains
    for topic, parts in (("requests-txn", 2), ("predictions-txn", 1)):
        log.create_topic(topic, LogConfig(num_partitions=parts, replication_factor=3))

    @torch.no_grad()
    def logits(d):
        return copd_mlp.forward(params, d["data"])

    txn = InferenceDeployment(log, reg, uploaded[0].result_id, predict_fn=logits, input_topic="requests-txn",
                              output_topic="predictions-txn", replicas=2, transactional=True)
    quarter = COPD_REQUESTS // 4
    for p in range(2):
        log.produce_batch("requests-txn", [r.tobytes() for r in reqs[p * quarter:(p + 1) * quarter]], partition=p)
    t_txn = time.perf_counter()
    first = txn.drain()
    t_kill = time.perf_counter()
    log.start_replication(interval_s=0.002, workers=2)
    try:
        killed = log.leader_for("predictions-txn", 0)
        log.kill_broker(killed)
        for p in range(2):
            log.produce_batch("requests-txn", [r.tobytes() for r in reqs[half + p * quarter:half + (p + 1) * quarter]],
                              partition=p)
        deadline = time.monotonic() + GROUP_DEADLINE_S
        ticks = cluster_errors = 0
        got = []
        while len(got) < COPD_REQUESTS:
            if time.monotonic() > deadline:
                raise AssertionError(f"{len(got)} of {COPD_REQUESTS} transactional predictions committed "
                                     f"within {GROUP_DEADLINE_S} s of the broker kill")
            ticks += 1
            log.controller_tick()
            try:
                txn.poll_all()
            except ClusterError:
                cluster_errors += 1
                continue  # election window: abort and rewind, retry the tick
            got = committed_records(log, "predictions-txn", 0)
        t_end = time.perf_counter()
    finally:
        log.stop_replication()
        txn.close()
    want_logits = copd_mlp.forward(cpu_params, reqs).numpy()
    got_logits = np.frombuffer(b"".join(got), np.float32).reshape(len(got), -1)
    matched = match_rows(got_logits, want_logits, COPD_LOGIT_TOL * float(np.abs(want_logits).max()))
    print(f"[{card}] copd-mlp transactional: {first} committed in {t_kill - t_txn:.4f} s, broker {killed} (leader "
          f"of predictions-txn/0) killed, all {len(got)} committed exactly once {t_end - t_kill:.4f} s later, "
          f"{ticks} ticks, {cluster_errors} cluster errors", flush=True)
    assert first == 2 * quarter, first
    assert sorted(matched) == list(range(COPD_REQUESTS)), f"requests answered other than once: {sorted(matched)}"

    # the supervisor, on a cluster and registry of its own (it runs every
    # pending training deployment): a 2-model configuration, the first job
    # crashing once
    sup_log, sup_reg = BrokerCluster(3), Registry()
    crashes = {"left": 1}

    def factory(dep_, spec_, ckpt_dir):
        crash_after = SUP_CRASH_AFTER if crashes["left"] > 0 else None
        crashes["left"] = 0

        class Job(TrainingJob):
            def run(self, **kw):
                return super().run(crash_after=crash_after, **kw)

        return Job(sup_log, sup_reg, dep_.deployment_id, spec_.model_id, loss_fn=copd_mlp.loss_fn, init_fn=copd_mlp.init,
                   opt=adamw(COPD_LR), ckpt_dir=ckpt_dir, ckpt_every=10, device="cuda")

    _, sup_dep, _, _ = copd_setup(sup_log, sup_reg, "copd", 2, {"batch_size": COPD_BATCH, "max_steps": SUP_MAX_STEPS})
    t_sup = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        outcomes = Supervisor(sup_log, sup_reg, factory, ckpt_root=root, max_restarts=2).reconcile()
    sup_s = time.perf_counter() - t_sup
    status = sup_reg.deployment(sup_dep.deployment_id).status
    print(f"[{card}] supervisor: {[(o.model_id, o.attempts, o.ok) for o in outcomes]}, deployment {status}, "
          f"{sup_s:.3f} s", flush=True)
    assert [(o.ok, o.attempts) for o in outcomes] == [(True, 2), (True, 1)], outcomes
    assert status == "finished", status
    assert len(sup_reg.results_for(sup_dep.deployment_id)) == 2

    counts = read_counts(kernels)
    assert not any(counts.values()), f"the copd loop launched a kernel of the port: {counts}"
    return {
        "card": card, "records": msg.total_msg, "batch": COPD_BATCH, "epochs": COPD_EPOCHS, "steps": res.steps,
        "train_s": train_s, "median_step_ms": med_ms, "steps_per_s": 1e3 / med_ms, "metrics": res.metrics,
        "eval_metrics": res.eval_metrics, "uploaded_loss": uploaded[0].metrics["loss"], "served": served,
        "lag": lag, "served_accuracy": acc, "pred_max_abs_err": pred_err, "pred_tol": COPD_PRED_TOL,
        "drain_s": drain_s, "txn_first_drain_s": t_kill - t_txn, "txn_after_kill_s": t_end - t_kill,
        "txn_killed_broker": killed, "txn_ticks": ticks, "txn_cluster_errors": cluster_errors,
        "supervisor": [dataclasses.asdict(o) for o in outcomes], "supervisor_s": sup_s,
        "phase_s": time.perf_counter() - t0, "launches": counts,
    }


def phase_deploy_lm(card, kernels: dict, cfg, model):
    """Full-width yi-6b behind a 2-replica InferenceDeployment, as
    examples/serve_lm.py runs its LM (``make_generate``: the prefill step,
    then DEPLOY_GEN decode steps): round 1 puts DEPLOY_PER_PARTITION
    prompts on each of DEPLOY_PARTITIONS partitions and drains; replica 0
    is killed and the clock moves past the session timeout; round 2 puts
    as many new prompts and drains. Checks every completion once, replica
    1 alone in round 2, every token a greedy choice of the forward within
    GREEDY_SLACK, and K1 once a layer a prefill call."""
    import numpy as np
    import torch

    from repro_torch.core import Registry, StreamLog
    from repro_torch.core.log import LogConfig
    from repro_torch.serve import InferenceDeployment
    from repro_torch.serve.lm_engine import Request

    generate = load_example("torch_serve_lm").make_generate(model, DEPLOY_PROMPT, DEPLOY_GEN)
    calls = []

    def predict(d):
        out = generate({"prompt": d["data"]})
        calls.append((d["data"].copy(), out))
        return out

    log, reg = StreamLog(), Registry()
    spec = reg.register_model("yi-6b")
    dep = reg.deploy(reg.create_configuration([spec.model_id]).config_id, "train")
    result = reg.upload_result(dep.deployment_id, spec.model_id, {"loss": 0.0}, input_format="RAW",
                               input_config={"data_type": "int32", "data_reshape": [DEPLOY_PROMPT],
                                             "label_type": "int32", "label_reshape": []})
    log.create_topic("deploy-prompts", LogConfig(num_partitions=DEPLOY_PARTITIONS))
    clock = [0.0]
    infer = InferenceDeployment(log, reg, result.result_id, predict_fn=predict, input_topic="deploy-prompts",
                                output_topic="deploy-completions", replicas=2, session_timeout_s=30.0,
                                clock=lambda: clock[0])
    per_round = DEPLOY_PARTITIONS * DEPLOY_PER_PARTITION
    rng = np.random.default_rng(SEED + 6)
    prompts = rng.integers(0, cfg.vocab, (2 * per_round, DEPLOY_PROMPT)).astype(np.int32)
    # a timed predict call outside the rounds (it also warms the path up)
    one = {"prompt": prompts[:DEPLOY_PER_PARTITION]}
    predict_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        generate(one)
        torch.cuda.synchronize()
        predict_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.reset_peak_memory_stats()

    reset_counts(kernels)
    rounds, processed = [], []
    for rnd in range(2):
        if rnd:
            infer.kill_replica(0)
            clock[0] += 60.0  # past the session timeout: replica 1 takes every partition
        batch = prompts[rnd * per_round:(rnd + 1) * per_round]
        for part in range(DEPLOY_PARTITIONS):
            rows = batch[part * DEPLOY_PER_PARTITION:(part + 1) * DEPLOY_PER_PARTITION]
            log.produce_batch("deploy-prompts", [r.tobytes() for r in rows], partition=part)
        t = time.perf_counter()
        served = infer.drain()
        torch.cuda.synchronize()
        rounds.append({"served": served, "wall_s": time.perf_counter() - t})
        processed.append([r.stats.processed for r in infer.replicas])
    infer.close()
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()

    records = [bytes(v) for v in log.read("deploy-completions", 0, 0, 4 * per_round).values]
    by_prompt = {p.tobytes(): out.cpu().numpy() for batch_in, out_t in calls
                 for p, out in zip(batch_in, out_t)}
    assert [r["served"] for r in rounds] == [per_round, per_round], rounds
    assert len(records) == 2 * per_round and len(calls) == 2 * DEPLOY_PARTITIONS, (len(records), len(calls))
    assert sorted(by_prompt) == sorted(p.tobytes() for p in prompts), "a prompt was served other than once"
    assert sorted(records) == sorted(v.astype(np.int32).tobytes() for v in by_prompt.values()), \
        "the completions topic differs from what the replicas computed"
    assert processed == [[per_round // 2, per_round // 2], [per_round // 2, per_round * 3 // 2]], processed
    reqs = [Request(i, p, DEPLOY_GEN) for i, p in enumerate(prompts)]
    got = {i: by_prompt[p.tobytes()] for i, p in enumerate(prompts)}
    for g in got.values():
        assert g.shape == (DEPLOY_GEN,) and ((g >= 0) & (g < cfg.vocab_padded)).all(), g
    worst = greedy_worst_gap(model, reqs, got)
    assert worst <= GREEDY_SLACK, f"served tokens trail the forward's greedy choice by {worst}"
    attn = counts.pop("flash_attention")
    assert attn == cfg.n_layers * len(calls) > 0, f"flash_attention launched {attn}, want {cfg.n_layers} x {len(calls)}"
    assert not any(counts.values()), counts
    out = {
        "card": card, "prompt_len": DEPLOY_PROMPT, "new_tokens": DEPLOY_GEN, "partitions": DEPLOY_PARTITIONS,
        "per_partition": DEPLOY_PER_PARTITION, "rounds": rounds, "processed": processed,
        "prefill_calls": len(calls), "predict_ms": predict_ms, "peak_bytes": peak, "launches": attn,
        "greedy_worst_gap": worst,
    }
    for i, r in enumerate(rounds):
        print(f"[{card}] yi-6b deployment round {i + 1}: {r['served']} prompts of {DEPLOY_PROMPT} tokens, "
              f"{DEPLOY_GEN} new each, in {r['wall_s']:.4f} s; per replica {processed[i]}", flush=True)
    print(f"[{card}] yi-6b deployment: a predict call of {DEPLOY_PER_PARTITION} prompts (prefill + {DEPLOY_GEN} "
          f"decode steps) {['%.3f' % x for x in predict_ms]} ms; peak device memory {peak} bytes; flash_attention "
          f"launches {attn} for {len(calls)} prefill calls; greedy worst gap {worst:.4f} (slack {GREEDY_SLACK})",
          flush=True)
    return out


def rglru_inputs(b, s, c, gen, h0: str | None, model_decays: bool):
    """x, log_a and h0 on the card for one K3 call: log a = -|N| * 0.3 (the
    tests' decays) or log(u) r / 2, u ~ U(0.81, 0.998) per channel and r a
    sigmoid gate (the model's); h0 None, "zero" (as the cache hands it) or
    "random"."""
    import torch

    x = torch.randn((b, s, c), generator=gen, device="cuda")
    if model_decays:
        u = torch.rand((c,), generator=gen, device="cuda") * (0.998 - 0.81) + 0.81
        r = torch.sigmoid(torch.randn((b, s, c), generator=gen, device="cuda"))
        log_a = torch.log(u) * r / 2
    else:
        log_a = -torch.randn((b, s, c), generator=gen, device="cuda").abs() * 0.3
    h_init = {None: None, "zero": torch.zeros((b, c), device="cuda"),
              "random": torch.randn((b, c), generator=gen, device="cuda")}[h0]
    return x, log_a, h_init


def check_rglru(card, ref, b, s, c, gen, h0: str | None, model_decays: bool, timed: bool):
    """K3 vs its plain version run in float64 on one input
    (``rglru_inputs``), element by element within |got - want| <= tol +
    tol |want| (tol RGLRU_TOL with the tests' decays, RGLRU_F64_TOL with
    the model's); the f32 plain version's own distance from the float64
    run is printed beside. With ``timed`` also times the kernel and both
    plain runs. Raises if the kernel disagrees."""
    import torch

    from repro_torch.kernels.ops import rglru_op

    x, log_a, h_init = rglru_inputs(b, s, c, gen, h0, model_decays)

    def kernel():
        return rglru_op(x, log_a, h_init)

    def plain():
        return ref.rglru(x, log_a, h_init)

    def plain64():
        return ref.rglru(x.double(), log_a.double(), None if h_init is None else h_init.double())

    (h, hl), (hr, _), (h64, hl64) = kernel(), plain(), plain64()
    torch.cuda.synchronize()
    tol = RGLRU_F64_TOL if model_decays else RGLRU_TOL
    row = {"b": b, "s": s, "c": c, "h0": h0, "model_decays": model_decays, "tol": tol,
           "rms_h": float(h64.square().mean().sqrt())}
    ok = bool(torch.isfinite(h).all()) and bool(torch.isfinite(hl).all())
    for name, got in (("kernel", h), ("plain_f32", hr)):
        err = (got.double() - h64).abs()
        row[f"{name}_vs_f64_max_abs_err"] = float(err.max())
        row[f"{name}_vs_f64_el_err"] = float((err / (tol + tol * h64.abs())).max())  # <= 1 passes
    row["max_abs_err"] = max(row["kernel_vs_f64_max_abs_err"], float((hl.double() - hl64).abs().max()))
    ok = ok and row["kernel_vs_f64_el_err"] <= 1.0
    ok = ok and bool(((hl.double() - hl64).abs() <= tol + tol * hl64.abs()).all())
    row["ok"] = ok
    if timed:
        row["ms"] = time_ms(kernel, 20)
        row["plain_ms"] = time_ms(plain, 2)
        row["plain_f64_ms"] = time_ms(plain64, 1)
        row["library_ms"] = None  # no single PyTorch call computes the RG-LRU recurrence
        row["bound_ms"], row["bound_by"] = rglru_bound(b, s, c, h0 is not None)
    print(f"[{card}] rglru_scan {json.dumps(row)}", flush=True)
    if not ok:
        raise AssertionError(f"rglru_scan disagrees with its plain version: {row}")
    return row


def check_rglru_bwd(card, K, ref, b, s, c, gen, h0: str | None, dh_last: bool, model_decays: bool, timed: bool):
    """K3's backward (``K.rglru_scan_bwd``) against its plain version
    ``ref.rglru_bwd`` run in float64 on one input (``rglru_inputs``, h from
    K3, a random dh and, with ``dh_last``, a random d(h_last)), element by
    element within tol + tol * scale (RGLRU_BWD_EDGES' comment: tol
    RGLRU_TOL with the tests' decays, RGLRU_F64_TOL with the model's); the
    f32 plain version's own distance from the float64 run is printed
    beside, and each gradient's error scaled by |want| alone. Where log
    a is 0 (a = 1: the card's ``torch.randn`` can return an exact 0, and
    the tests' decays are -|N| * 0.3) the weight's derivative is infinite
    and JAX's dlog_a is too: there dx must be 0 on both sides and dlog_a
    the float64 run's infinity, or NaN where it has NaN (``edge``
    counts those elements); everywhere else each gradient is finite and
    held as above. With ``timed`` also times the kernel and both plain
    runs. Raises if the kernel disagrees."""
    import torch

    from repro_torch.kernels.ops import rglru_op

    x, log_a, h_init = rglru_inputs(b, s, c, gen, h0, model_decays)
    with torch.no_grad():
        h, _ = rglru_op(x, log_a, h_init)
    dh = torch.randn((b, s, c), generator=gen, device="cuda")
    dl = torch.randn((b, c), generator=gen, device="cuda") if dh_last else None
    d64 = [None if t is None else t.double() for t in (x, log_a, h_init)]
    h64, _ = ref.rglru(*d64)

    def kernel():
        return K.rglru_scan_bwd(x, log_a, h_init, h, dh, dl)

    def plain():
        return ref.rglru_bwd(x, log_a, h_init, h, dh, dl)

    def plain64():
        return ref.rglru_bwd(*d64, h64, dh.double(), None if dl is None else dl.double())

    got, mine, want = kernel(), plain(), plain64()
    torch.cuda.synchronize()
    # each gradient's scale (RGLRU_BWD_EDGES' comment): the plain adjoint
    # of |dh|, and for dlog_a G, its chain, times the bracket's two terms
    x64, la64 = d64[0], d64[1]
    a64 = torch.exp(la64)
    v64 = -torch.expm1(2 * la64)
    w64 = torch.sqrt(torch.where(v64 > 0, v64, torch.zeros_like(v64)))
    hprev = torch.cat([(torch.zeros_like(h64[:, 0]) if h_init is None else d64[2])[:, None], h64[:, :-1]], 1)
    size = ref.rglru_bwd(*d64, h64, dh.double().abs(), None if dl is None else dl.double().abs())
    scales = [size[0], size[0] / w64 * ((a64 * hprev).abs() + (a64 * a64 * x64 / w64).abs()), size[2]]
    tol = RGLRU_F64_TOL if model_decays else RGLRU_TOL
    edge = la64 == 0  # a = 1: dlog_a's derivative is infinite
    row = {"b": b, "s": s, "c": c, "h0": h0, "dh_last": dh_last, "model_decays": model_decays, "tol": tol,
           "edge": int(edge.sum())}
    ok = True
    for name, gk, gp, w, sc in zip(("dx", "dlog_a", "dh0"), got, mine, want, scales):
        if w is None:
            ok = ok and gk is None
            continue
        keep = ~edge if name == "dlog_a" else torch.ones_like(w, dtype=torch.bool)
        ok = ok and bool(torch.isfinite(gk[keep]).all())
        for side, gg in (("kernel", gk), ("plain_f32", gp)):
            err = (gg.double() - w).abs()[keep]
            row[f"{side}_{name}_el_err"] = float((err / (tol + tol * sc[keep])).max())  # <= 1 passes
            row[f"{side}_{name}_el_err_want"] = float((err / (tol + tol * w.abs()[keep])).max())
        row[f"{name}_max_abs_err"] = float((gk.double() - w).abs()[keep].max())
        ok = ok and row[f"kernel_{name}_el_err"] <= 1.0
        if name == "dlog_a" and row["edge"]:  # the float64 run's infinities and NaNs, element for element
            ge, we = gk.double()[edge], w[edge]
            ok = ok and bool(((ge == we) | (ge.isnan() & we.isnan())).all()) and not bool(torch.isfinite(we).any())
    row["max_abs_err"] = max(v for k, v in row.items() if k.endswith("_max_abs_err"))
    row["ok"] = ok
    if timed:
        row["ms"] = time_ms(kernel, 20)
        row["plain_ms"] = time_ms(plain, 2)
        row["plain_f64_ms"] = time_ms(plain64, 1)
        row["library_ms"] = None  # no single PyTorch call computes the recurrence's adjoint
        row["bound_ms"], row["bound_by"] = rglru_bwd_bound(b, s, c, h0 is not None, dh_last)
    print(f"[{card}] rglru_scan_bwd {json.dumps(row)}", flush=True)
    if not ok:
        raise AssertionError(f"rglru_scan_bwd disagrees with its plain version: {row}")
    return row


def check_rglru_bwd_determinism(card, K, b, s, c, gen, calls: int = 3):
    """K3's backward called ``calls`` times on one input: the same bits every time."""
    import torch

    x, log_a, h_init = rglru_inputs(b, s, c, gen, "random", True)
    h, _ = K.rglru_scan(x, log_a, h_init)
    dh, dl = torch.randn((b, s, c), generator=gen, device="cuda"), torch.randn((b, c), generator=gen, device="cuda")
    first = K.rglru_scan_bwd(x, log_a, h_init, h, dh, dl)
    same = all(all(torch.equal(p.view(torch.int32), q.view(torch.int32))  # bits, NaNs included
                   for p, q in zip(first, K.rglru_scan_bwd(x, log_a, h_init, h, dh, dl)))
               for _ in range(calls - 1))
    row = {"b": b, "s": s, "c": c, "calls": calls, "bit_identical": same, "ok": same}
    print(f"[{card}] rglru_scan_bwd determinism {json.dumps(row)}", flush=True)
    if not same:
        raise AssertionError(f"rglru_scan_bwd gave other bits on the same input: {row}")
    return row


def phase_rglru_kernel_bwd(card, K, ref):
    """K3's backward against ref.rglru_bwd in float64: RGLRU_SWEEP's shapes
    and RGLRU_BWD_EDGES (the tests' decays), then the training path's call
    (RGLRU_TRAIN, the model's decays, no h0 and no d(h_last), as the
    mixer hands it) timed with the forward's call beside it, then the same
    bits on three calls. Returns (rows, the backward's and the forward's
    training rows)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    rows = [check_rglru_bwd(card, K, ref, b, s, c, gen, "random", True, False, False) for b, s, c in RGLRU_SWEEP]
    rows += [check_rglru_bwd(card, K, ref, b, s, c, gen, "random" if h0 else None, h0, False, False)
             for b, s, c, h0 in RGLRU_BWD_EDGES]
    b, s, c = RGLRU_TRAIN
    rows.append(check_rglru_bwd(card, K, ref, b, s, c, gen, "random", True, True, False))
    main = check_rglru_bwd(card, K, ref, b, s, c, gen, None, False, True, True)
    fwd = check_rglru(card, ref, b, s, c, gen, None, True, True)
    rows.append(check_rglru_bwd_determinism(card, K, b, s, c, gen))
    return rows, main, fwd


def phase_train_rglru_grads(card, ref, mixer: dict):
    """The trained recurrentgemma's first RG-LRU layer (``mixer``: its
    weights) at the training shape: the gradients of a fixed random
    projection of its output with respect to a random x and every weight
    of the layer, through K3 forward + backward (``rglru_op`` under grad),
    against the same computation with the plain ``ref.rglru`` (autograd)
    in the scan's place; each leaf's error relative to its largest
    element, within the bf16 tolerance of the layer's products (the scans
    differ in their f32 roundings, which the bf16 products around them
    round on)."""
    import math
    from unittest import mock

    import torch

    from repro_torch import configs
    from repro_torch.models import rglru as M

    cfg = configs.get("recurrentgemma-9b")
    b, s = TRAIN_BATCH, TRAIN_SEQ
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    leaves = {"x": randn(b, s, cfg.d_model), **mixer}
    proj = randn(b, s, cfg.d_model)

    def plain_rglru_op(x, log_a, h0=None):
        return ref.rglru(x.float(), log_a.float(), None if h0 is None else h0.float())

    def grads(kernel: bool):
        t = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
        p = {k: v for k, v in t.items() if k != "x"}
        with mock.patch.object(M, "rglru_op", M.rglru_op if kernel else plain_rglru_op):
            y, _ = M.rglru_mixer(p, t["x"], cfg.rglru)
        g = torch.autograd.grad((y.float() * proj.float()).sum(), list(t.values()))
        return dict(zip(t, g))

    got = grads(True)
    gc.collect()
    torch.cuda.empty_cache()
    want = grads(False)
    torch.cuda.synchronize()
    rel = {k: float((got[k].float() - want[k].float()).abs().max() / want[k].float().abs().max()) for k in got}
    row = {"shape": [b, s, cfg.d_model], "rel_err": rel, "tol": TOL["bfloat16"]}
    print(f"[{card}] recurrentgemma RG-LRU layer gradients, kernel vs plain {json.dumps(row)}", flush=True)
    assert all(math.isfinite(e) and e <= TOL["bfloat16"] for e in rel.values()), row
    return row


def phase_rglru_kernel(card, ref):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = [check_rglru(card, ref, b, s, c, gen, "random", False, False) for b, s, c in RGLRU_SWEEP]
    # the teacher-forced forward's call (B 1: a quarter of the path's
    # blocks), then the serving path's: one per RG-LRU layer of the wave,
    # the model's decays; the main row draws a random h0, the stricter
    # check of the carry, and the row beside it the zero h0 the cache
    # hands the path
    rows.append(check_rglru(card, ref, 1, RG_PROMPT_LEN + MAX_NEW - 1, 4096, gen, None, True, True))
    main = check_rglru(card, ref, WAVE_REQUESTS, RG_PROMPT_LEN, 4096, gen, "random", True, True)
    rows.append(check_rglru(card, ref, WAVE_REQUESTS, RG_PROMPT_LEN, 4096, gen, "zero", True, True))
    rows += [check_rglru(card, ref, b, s, c, gen, "random", False, False) for b, s, c in RGLRU_EDGES]
    return rows, main


def wave_setup(arch: str, compute_dtype: str, prompt_len: int):
    """A wave workload: full-width ``arch`` with random bf16 weights from
    SEED (the same for either activation dtype) behind a wave ``LMEngine``
    of WAVE_REQUESTS slots holding ``prompt_len + MAX_NEW`` cache slots,
    warmed up by one short wave (64 tokens: for a local layer, shorter than
    its window), and a topic of WAVE_REQUESTS fixed-length prompts in the
    JAX package's record format (int32[prompt_len] each)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core.log import StreamLog
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy
    from repro_torch.serve.lm_engine import LMEngine, Request

    cfg = configs.get(arch)
    model = StreamModel(cfg, Policy(compute_dtype=compute_dtype), device="cuda", generator=SEED)
    engine = LMEngine(model, n_slots=WAVE_REQUESTS, s_cache=prompt_len + MAX_NEW, device="cuda")
    rng = np.random.default_rng(SEED + 1)
    engine.submit(Request(-1, rng.integers(0, cfg.vocab, 64).astype(np.int32), 2))
    engine.run_until_drained()
    engine.first_token_s.clear()

    log = StreamLog()
    log.create_topic("lm-prompts")
    prompts = rng.integers(0, cfg.vocab, (WAVE_REQUESTS, prompt_len)).astype(np.int32)
    log.produce_batch("lm-prompts", [row.tobytes() for row in prompts])
    return cfg, model, engine, log, prompts


def phase_serve_wave(card, kernels: dict, arch: str, compute_dtype: str, prompt_len: int, slack: float):
    """Serve ``wave_setup``'s topic and check what comes back. ``kernels``
    maps each kernel's name to its module; the wave's prefill must launch
    K1 once an attention layer, K2 once an SSM layer and K3 once an RG-LRU
    layer, and nothing else (decode runs no kernel of the port)."""
    import numpy as np
    import torch

    from repro_torch.serve.lm_engine import serve_stream

    t0 = time.perf_counter()
    cfg, model, engine, log, prompts = wave_setup(arch, compute_dtype, prompt_len)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    tag = f"{arch} ({compute_dtype} activations)"
    print(f"[{card}] {arch} full width: {cfg.n_layers} layers, pattern {cfg.pattern}, d {cfg.d_model}, "
          f"{n_params} params bf16, {compute_dtype} activations, set-up and warm-up {setup_s:.3f} s",
          flush=True)
    torch.cuda.reset_peak_memory_stats()

    reset_counts(kernels)
    t_start = time.perf_counter()
    served = serve_stream(engine, log, "lm-prompts", "lm-completions", prompt_len, max_new=MAX_NEW)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
    assert kernels["flash_attention"].BWD_LAUNCHES == kernels["ssd_scan"].BWD_LAUNCHES == 0, \
        "serving launched a backward"

    peak = torch.cuda.max_memory_allocated()
    got = {}
    for buf in log.read("lm-completions", 0, 0, 64).values:
        rec = np.frombuffer(buf, np.int32)
        got[int(rec[0])] = rec[1:].copy()
    assert served == WAVE_REQUESTS and sorted(got) == list(range(WAVE_REQUESTS)), (served, sorted(got))
    for rid, g in got.items():
        assert len(g) == MAX_NEW and ((g >= 0) & (g < cfg.vocab_padded)).all(), (rid, g)
    assert engine.waves == 2, engine.waves  # the warm-up wave and the served one
    kinds = [kind for kind, *_ in model._layer_params()]
    want = {  # the wave's prefill: one launch per layer of the kernel's kind
        "flash_attention": sum(k in ("attn", "local") for k in kinds),
        "ssd_scan": kinds.count("ssm"),
        "rglru_scan": kinds.count("rec"),
        "adamw8bit": 0,
        "grad_norm": 0,
    }
    assert launches == want, f"{arch}: launches {launches}, want {want}"

    # each served token must be a greedy choice of the teacher-forced
    # full-sequence forward (the prefill's kernels over the whole sequence,
    # against decode through the recurrent states and caches): the first
    # token (the prefill's, the same kernels as the forward's) within
    # GREEDY_SLACK and the decoded ones within ``slack``
    gaps = []
    for rid in range(WAVE_REQUESTS):
        seq = np.concatenate([prompts[rid], got[rid][:-1]])
        logits = model(torch.from_numpy(seq[None].astype(np.int64)).cuda())[0, prompt_len - 1:]
        assert bool(torch.isfinite(logits).all())
        served_tok = torch.from_numpy(got[rid].astype(np.int64)).cuda()
        gap = logits.max(-1).values - logits.gather(-1, served_tok[:, None])[:, 0]
        gaps.append([round(float(x), 4) for x in gap])
        del logits
    first_gap = max(g[0] for g in gaps)
    worst = max(max(g[1:]) for g in gaps)
    assert first_gap <= GREEDY_SLACK, f"the first served tokens trail the forward's greedy choice by {first_gap}"
    assert worst <= slack, f"served tokens trail the forward's greedy choice by {worst} ({gaps})"

    first = max(engine.first_token_s[rid] for rid in range(WAVE_REQUESTS))
    ttft = (first - t_start) * 1e3
    decode_tokens = WAVE_REQUESTS * (MAX_NEW - 1)
    decode_s = t_end - first
    out = {
        "arch": arch, "requests": WAVE_REQUESTS, "prompt_len": prompt_len, "max_new": MAX_NEW,
        "prefill_ms": ttft, "ttft_ms": ttft, "decode_tokens": decode_tokens, "decode_s": decode_s,
        "decode_tokens_per_s": decode_tokens / decode_s, "total_s": t_end - t_start,
        "peak_bytes": peak, "launches": launches, "compute_dtype": compute_dtype,
        "greedy_first_gap": first_gap, "greedy_worst_decoded_gap": worst, "greedy_slack": slack,
        "greedy_gaps": gaps,
    }
    print(f"[{card}] {tag} wave of {WAVE_REQUESTS} x {prompt_len}: prefill (TTFT) {ttft:.3f} ms", flush=True)
    print(f"[{card}] {tag} decode {decode_tokens} tokens in {decode_s:.4f} s: "
          f"{decode_tokens / decode_s:.3f} tokens/s", flush=True)
    print(f"[{card}] {tag} peak device memory {peak} bytes; launches {launches}; "
          f"greedy gap first {first_gap:.4f}, worst decoded {worst:.4f} (slack {slack})", flush=True)
    del engine, model
    return out


def path_summary(launches: int, timed: list) -> dict:
    """One path's share of a kernel: its launches, and the sums of its
    timed calls' times with the ratios that say where the kernel stands
    (library_ms None where no PyTorch call computes the function)."""
    out = {"launches": launches}
    for key in ("ms", "plain_ms", "bound_ms"):
        out[key] = sum(r[key] for r in timed)
    lib = [r["library_ms"] for r in timed]
    out["library_ms"] = None if None in lib else sum(lib)
    out["bound_by"] = max(timed, key=lambda r: r["bound_ms"])["bound_by"]
    out["ms_over_library_ms"] = None if out["library_ms"] is None else out["ms"] / out["library_ms"]
    out["bound_ms_over_ms"] = out["bound_ms"] / out["ms"]
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import adamw8bit, flash_attention, grad_norm, rglru_scan, ssd_scan

    kernels = {"flash_attention": flash_attention, "ssd_scan": ssd_scan, "rglru_scan": rglru_scan,
               "adamw8bit": adamw8bit, "grad_norm": grad_norm}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)

    # the dry run of three training cells, on the CPU beside the card's phases
    dryrun_started = start_dryrun([[a, a, n, "train", TRAIN_BATCH, TRAIN_SEQ, [1, 1]] for a, n in DRYRUN_CELLS])
    build_s = _build.build_all()
    print(f"build: {build_s:.3f} s", flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if any(w in line.lower() for w in ("registers", "spill", "compiling entry function", "wgmma", "warning")):
                print(f"  {name}: {line.strip()}", flush=True)

    rows, main_rows, rg_attn_main, deploy_attn_main, family_attn = phase_kernels(card, flash_attention, ref)
    bwd_rows, lse_rows, train_fwd_main, bwd_main, rg_train_fwd_main, rg_bwd_main, family_bwd = phase_kernels_bwd(
        card, flash_attention, ref)
    wh_rows, wh_paths = phase_whisper_kernels(card, flash_attention, ref)
    k1_offset = phase_k1_offset(card, flash_attention, ref)
    ssd_rows, ssd_main = phase_ssd_kernel(card, ref)
    ssd_bwd_rows, ssd_bwd_main, ssd_train_fwd = phase_ssd_kernel_bwd(card, ssd_scan, ref)
    rglru_rows, rglru_main = phase_rglru_kernel(card, ref)
    rglru_bwd_rows, rglru_bwd_main, rglru_train_fwd = phase_rglru_kernel_bwd(card, rglru_scan, ref)
    paper_loop = phase_paper_loop(card, kernels)
    # training first: its ~60 GB are freed before the serving models load
    training, trained_layer = phase_train(card, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    train_grads = phase_train_grads(card, ref, trained_layer["mixer"])
    del trained_layer
    gc.collect()
    torch.cuda.empty_cache()
    opt8 = phase_optimizer_kernel(card)
    gc.collect()
    torch.cuda.empty_cache()
    # all 32 layers with the 8-bit state: freed before the serving models load
    training_full = phase_train_full(card, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    # mamba2 at all 64 layers with the 8-bit state, then its trained first
    # mixer layer's gradients: freed before the serving models load
    training_m2, trained_mixer = phase_train_mamba2(card, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    m2_grads = phase_train_ssm_grads(card, ref, trained_mixer["mixer"])
    del trained_mixer
    gc.collect()
    torch.cuda.empty_cache()
    # recurrentgemma cut to RG_TRAIN_LAYERS with the 8-bit state, then its
    # trained first RG-LRU layer's gradients: freed before the serving models load
    training_rg, trained_rec = phase_train_recurrentgemma(card, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    rg_grads = phase_train_rglru_grads(card, ref, trained_rec["mixer"])
    del trained_rec
    gc.collect()
    torch.cuda.empty_cache()
    # the dry run's predictions for the three training cells above
    dryrun = phase_dryrun(card, dryrun_started, {"yi-6b": training_full, "mamba2-2.7b": training_m2,
                                                 "recurrentgemma-9b": training_rg})
    # gemma2-2b at all 26 layers and qwen2-7b at all 28 with the 8-bit
    # state, each then its trained first attention layer's gradients
    # (gemma2's local one, with its window and softcap): freed before the
    # serving models load
    training_g2, trained_g2 = phase_train(card, kernels, arch=GEMMA2, layers=GEMMA2_LAYERS, opt_name="adamw8bit")
    gc.collect()
    torch.cuda.empty_cache()
    g2_grads = phase_train_grads(card, ref, trained_g2["mixer"], arch=GEMMA2, kind="local", attn=GEMMA2_TRAIN_ATTN)
    del trained_g2
    gc.collect()
    torch.cuda.empty_cache()
    training_q2, trained_q2 = phase_train(card, kernels, arch=QWEN2, layers=QWEN2_LAYERS, opt_name="adamw8bit")
    gc.collect()
    torch.cuda.empty_cache()
    q2_grads = phase_train_grads(card, ref, trained_q2["mixer"], arch=QWEN2, attn=QWEN2_TRAIN_ATTN)
    del trained_q2
    gc.collect()
    torch.cuda.empty_cache()
    # qwen3-moe-30b-a3b cut to MOE_TRAIN_LAYERS with the 8-bit state, then
    # its trained first MoE layer's gradients, then the 8-bit update and the
    # norm on its whole w_in leaf, past 2^31 elements; pixtral-12b cut to
    # PIXTRAL_TRAIN_LAYERS the same way: freed before the serving models load
    training_moe, trained_moe = phase_train(card, kernels, arch=MOE, layers=MOE_TRAIN_LAYERS, opt_name="adamw8bit",
                                            whole=("moe", "w_in"))
    gc.collect()
    torch.cuda.empty_cache()
    moe_grads = phase_train_moe_grads(card, trained_moe)
    gc.collect()
    torch.cuda.empty_cache()
    opt8_tail = phase_opt8_past_2_31(card, trained_moe.pop("whole"))
    del trained_moe
    gc.collect()
    torch.cuda.empty_cache()
    training_px, _ = phase_train(card, kernels, arch=PIXTRAL, layers=PIXTRAL_TRAIN_LAYERS, opt_name="adamw8bit")
    gc.collect()
    torch.cuda.empty_cache()
    # whisper-tiny at full depth, 448-token transcripts behind 1500 frames,
    # then its trained first encoder and decoder layers' gradients
    training_wh, trained_wh = phase_train(card, kernels, arch=WHISPER, layers=WHISPER_LAYERS, opt_name="adamw8bit",
                                          seq=WHISPER_CTX)
    wh_grads = phase_whisper_grads(card, ref, trained_wh)
    del trained_wh
    gc.collect()
    torch.cuda.empty_cache()
    # activation recomputation: each recomputing kernel path's layer groups
    # to the bit under the three modes, then recurrentgemma at all 38 layers
    # and pixtral deeper than its "none" phase, both under "full"; then data
    # parallelism over an NCCL group of one: freed before the serving models load
    remat_grads = phase_remat_grads(card, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    training_rg_remat = phase_train_recurrentgemma_remat(card, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    training_px_remat = phase_train_pixtral_remat(card, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    training_dp = phase_train_dp(card, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    # training on a mesh of every card present (a spawned NCCL rank each),
    # with nothing of this process's left on the card
    training_mesh = phase_train_mesh(card, kernels)
    mesh_fwd, mesh_bwd = mesh_paths(card, flash_attention, ref, training_mesh, k1_offset, train_fwd_main, bwd_main,
                                    main_rows)
    serving, yi_cfg, yi_model = phase_serve(card, kernels)
    serving_group = phase_serve_group(card, kernels, yi_cfg, yi_model)
    deployment = phase_deploy_lm(card, kernels, yi_cfg, yi_model)
    del yi_model
    # qwen2-7b at all 28 layers and mistral-large-123b cut to MISTRAL_LAYERS,
    # each through the ContinuousLMEngine as yi-6b
    served = {}
    for arch, layers in ((QWEN2, None), (MISTRAL, MISTRAL_LAYERS)):
        gc.collect()
        torch.cuda.empty_cache()
        served[arch], _, model = phase_serve(card, kernels, arch, layers)
        del model
    # mamba2's and gemma2's bf16 drift needs a slack above GREEDY_SLACK, so
    # an f32 twin holds every token at it; recurrentgemma's does not
    paths = {}
    for arch, compute_dtype, prompt_len, slack in (
        ("mamba2-2.7b", "bfloat16", SSM_PROMPT_LEN, SSM_BF16_DRIFT_SLACK),
        ("mamba2-2.7b", "float32", SSM_PROMPT_LEN, GREEDY_SLACK),
        ("recurrentgemma-9b", "bfloat16", RG_PROMPT_LEN, GREEDY_SLACK),
        (GEMMA2, "bfloat16", GEMMA2_PROMPT_LEN, GEMMA2_BF16_DRIFT_SLACK),
        (GEMMA2, "float32", GEMMA2_PROMPT_LEN, GREEDY_SLACK),
    ):
        gc.collect()
        torch.cuda.empty_cache()  # each serving phase's peak memory is its own
        paths[arch, compute_dtype] = phase_serve_wave(card, kernels, arch, compute_dtype, prompt_len, slack)
    serving_ssm, serving_rg = paths["mamba2-2.7b", "bfloat16"], paths["recurrentgemma-9b", "bfloat16"]
    serving_g2 = paths[GEMMA2, "bfloat16"]
    # qwen3-moe-30b-a3b at all 48 layers with int8 weights: served at the
    # published capacity factor and at the parity factor, then the fp8 KV
    # cache on it; then int8 against bf16 at MOE_BF16_LAYERS layers
    gc.collect()
    torch.cuda.empty_cache()
    serving_moe, moe_cfg, moe_model = phase_serve_moe(card, kernels)
    fp8_cache = phase_fp8_cache(card, moe_cfg, moe_model)
    del moe_model
    gc.collect()
    torch.cuda.empty_cache()
    int8_vs_bf16 = phase_int8_vs_bf16(card)
    # pixtral-12b at all 40 layers behind its patch frontend
    gc.collect()
    torch.cuda.empty_cache()
    serving_px = phase_serve_pixtral(card, kernels)
    # whisper-tiny at full depth: its prompts behind their frames, then a batch
    gc.collect()
    torch.cuda.empty_cache()
    serving_wh = phase_serve_whisper(card, kernels)

    # K1 runs on these kinds of call: yi-6b's serving calls (one per served
    # prompt length), yi-6b's training call (its forward, with lse), the
    # yi-6b deployment's prefill (one partition's prompts), recurrentgemma's
    # wave and recurrentgemma's training call (with lse, head dim 256,
    # window 2048), gemma2's wave (its local and its global layers' calls,
    # softcap 50, head dim 256) and training call, qwen2's and mistral's
    # serving calls (one per prompt length) and qwen2's training call, each
    # timed once; the sums cover all, by_path holds each path's own
    g2_wave, q2_serve, m_serve = family_attn[GEMMA2], family_attn[QWEN2], family_attn[MISTRAL]
    moe_serve, px_serve = family_attn[MOE], family_attn[PIXTRAL]
    attn_main = main_rows + [train_fwd_main, deploy_attn_main, rg_attn_main, rg_train_fwd_main] + g2_wave + [
        family_bwd["gemma2_fwd"]] + q2_serve + m_serve + [family_bwd["qwen2_fwd"]] + moe_serve + px_serve + [
        family_bwd["pixtral_fwd"]] + wh_paths["serve"] + wh_paths["train_fwd"]
    train_fwd_launches = training["launches"]["flash_attention"]
    full_fwd_launches = training_full["launches"]["flash_attention"]
    rg_train_fwd_launches = training_rg["launches"]["flash_attention"]
    family_launches = {
        "gemma2-2b-serve": serving_g2["launches"]["flash_attention"],
        "gemma2-2b-train": training_g2["launches"]["flash_attention"],
        "qwen2-7b-serve": served[QWEN2]["launches"],
        "qwen2-7b-train": training_q2["launches"]["flash_attention"],
        "mistral-large-123b-serve": served[MISTRAL]["launches"],
        "qwen3-moe-30b-a3b-int8": serving_moe["launches"],
        "qwen3-moe-30b-a3b-int8-parity": serving_moe["parity"]["launches"],
        "qwen3-moe-30b-a3b-train": training_moe["launches"]["flash_attention"],
        "pixtral-12b-serve": serving_px["launches"],
        "pixtral-12b-train": training_px["launches"]["flash_attention"],
        "whisper-tiny-serve": serving_wh["launches"],
        "whisper-tiny-train": training_wh["launches"]["flash_attention"],
        "recurrentgemma-9b-train-remat": training_rg_remat["launches"]["flash_attention"],
        "pixtral-12b-train-remat": training_px_remat["launches"]["flash_attention"],
        "yi-6b-dp": training_dp["launches"]["flash_attention"],
    }
    entry = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:34",
        "launches": serving["launches"] + serving_group["launches"] + train_fwd_launches + full_fwd_launches
        + deployment["launches"] + serving_rg["launches"]["flash_attention"] + rg_train_fwd_launches
        + sum(family_launches.values()) + sum(p["launches"] for p in mesh_fwd.values()),
        "max_abs_err": max(r["max_abs_err"] for r in attn_main),
        "matched": all(r["ok"] for r in rows + wh_rows + attn_main),
        "shapes": "one call at each of yi-6b's prompt lengths (1,S,32,128) S=%s bf16 causal, yi-6b's "
        "training call (%d,%d,32,128) kv 4 bf16 causal (16 and 32 layers), the yi-6b deployment's prefill (%d,%d,32,128) kv 4 "
        "bf16 causal, recurrentgemma's wave (%d,%d,16,256) kv 1 bf16 causal window 2048, recurrentgemma's "
        "training call (%d,%d,16,256) kv 1 bf16 causal window 2048 (%d layers), gemma2's wave (%d,%d,8,256) kv 4 "
        "bf16 causal softcap 50 with window 4096 and without, gemma2's training call (%d,%d,8,256) kv 4 bf16 "
        "causal softcap 50, qwen2's prefills (1,S,28,128) kv 4, mistral's (1,S,96,128) kv 8 and qwen3-moe's "
        "(1,S,32,128) kv 4 bf16 causal, qwen2's training call (%d,%d,28,128) kv 4 bf16 causal, qwen3-moe's "
        "training call (yi-6b's shape, %d layers), pixtral's prefills (1,1024+S,32,128) kv 8 bf16 causal and its "
        "training call (%d,%d,32,128) kv 8 bf16 causal (%d layers), whisper-tiny's serving calls (batch 1 at "
        "Sq %s, batch %d at %d: the encoder's (B,1500,6,64) bidirectional, the decoder's (B,Sq,6,64) causal and "
        "its cross (B,Sq over 1500,6,64), bf16) and its training calls (%d,1500), (%d,%d) causal and (%d,%d over "
        "1500); recurrentgemma's training call at all 38 layers and pixtral's at %d, both under remat full (each "
        "grouped layer's forward again in the backward), yi-6b's training call in dp_train_step, and the serving "
        "mesh's prefills (by_path *-serve-mesh: yi-6b's on one card; on n cards one rank's calls, mistral's "
        "(1,1024,96/n,128) kv 8/n bf16, gemma2's (1,8000,8/n,256) kv 4/n f32 cap 50 with window 4096 and without, "
        "qwen3-moe's (1,S,32/n,128) kv 4/n bf16), summed"
        % ("/".join(map(str, PROMPT_LENS)), TRAIN_BATCH, TRAIN_SEQ, DEPLOY_PER_PARTITION, DEPLOY_PROMPT,
           WAVE_REQUESTS, RG_PROMPT_LEN, TRAIN_BATCH, TRAIN_SEQ, RG_TRAIN_LAYERS, WAVE_REQUESTS, GEMMA2_PROMPT_LEN,
           TRAIN_BATCH, TRAIN_SEQ, TRAIN_BATCH, TRAIN_SEQ, MOE_TRAIN_LAYERS, PIXTRAL_TRAIN_ATTN[0],
           PIXTRAL_TRAIN_ATTN[1], PIXTRAL_TRAIN_LAYERS, "/".join(map(str, WHISPER_PROMPTS)), WHISPER_BATCH,
           WHISPER_BATCH_PROMPT, TRAIN_BATCH, TRAIN_BATCH, WHISPER_CTX, TRAIN_BATCH, WHISPER_CTX,
           PIXTRAL_REMAT_LAYERS),
        "by_path": {
            "yi-6b": path_summary(serving["launches"], main_rows),
            "yi-6b-group": path_summary(serving_group["launches"], main_rows),
            "yi-6b-train": path_summary(train_fwd_launches, [train_fwd_main]),
            "yi-6b-train-full": path_summary(full_fwd_launches, [train_fwd_main]),
            "yi-6b-deployment": path_summary(deployment["launches"], [deploy_attn_main]),
            "recurrentgemma-9b": path_summary(serving_rg["launches"]["flash_attention"], [rg_attn_main]),
            "recurrentgemma-9b-train": path_summary(rg_train_fwd_launches, [rg_train_fwd_main]),
            "gemma2-2b-serve": path_summary(family_launches["gemma2-2b-serve"], g2_wave),
            "gemma2-2b-train": path_summary(family_launches["gemma2-2b-train"], [family_bwd["gemma2_fwd"]]),
            "qwen2-7b-serve": path_summary(family_launches["qwen2-7b-serve"], q2_serve),
            "qwen2-7b-train": path_summary(family_launches["qwen2-7b-train"], [family_bwd["qwen2_fwd"]]),
            "mistral-large-123b-serve": path_summary(family_launches["mistral-large-123b-serve"], m_serve),
            "qwen3-moe-30b-a3b-int8": path_summary(family_launches["qwen3-moe-30b-a3b-int8"], moe_serve),
            "qwen3-moe-30b-a3b-int8-parity": path_summary(family_launches["qwen3-moe-30b-a3b-int8-parity"],
                                                          moe_serve),
            "qwen3-moe-30b-a3b-train": path_summary(family_launches["qwen3-moe-30b-a3b-train"], [train_fwd_main]),
            "pixtral-12b-serve": path_summary(family_launches["pixtral-12b-serve"], px_serve),
            "pixtral-12b-train": path_summary(family_launches["pixtral-12b-train"], [family_bwd["pixtral_fwd"]]),
            "whisper-tiny-serve": path_summary(family_launches["whisper-tiny-serve"], wh_paths["serve"]),
            "whisper-tiny-train": path_summary(family_launches["whisper-tiny-train"], wh_paths["train_fwd"]),
            "recurrentgemma-9b-train-remat": path_summary(family_launches["recurrentgemma-9b-train-remat"],
                                                          [rg_train_fwd_main]),
            "pixtral-12b-train-remat": path_summary(family_launches["pixtral-12b-train-remat"],
                                                    [family_bwd["pixtral_fwd"]]),
            "yi-6b-dp": path_summary(family_launches["yi-6b-dp"], [train_fwd_main]),
            **mesh_fwd,
        },
    }
    for key in ("ms", "plain_ms", "bound_ms"):
        entry[key] = sum(r[key] for r in attn_main)
    lib = [r["library_ms"] for r in attn_main]
    entry["library_ms"] = None if None in lib else sum(lib)
    entry["bound_by"] = max(attn_main, key=lambda r: r["bound_ms"])["bound_by"]  # the largest term
    # K2 runs on two kinds of call, each timed once: mamba2's serving wave
    # and its training call (the forward of each layer a step and an eval
    # batch); the sums cover both, by_path holds each path's own
    ssd_paths = [ssd_main, ssd_train_fwd]
    ssd_entry = {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:33",
        "launches": serving_ssm["launches"]["ssd_scan"] + training_m2["launches"]["ssd_scan"],
        "max_abs_err": max(r["max_abs_err"] for r in ssd_paths),
        "matched": all(r["ok"] for r in ssd_rows + ssd_paths),
        "shapes": "one call per layer of the wave (%d,%d,80,64) N128 G1 chunk 256 bf16, and one per layer of "
        "mamba2's training call (%d,%d,80,64) N128 G1 chunk 256 bf16, summed" % (
            WAVE_REQUESTS, SSM_PROMPT_LEN, TRAIN_BATCH, TRAIN_SEQ),
        "by_path": {
            "mamba2-2.7b": path_summary(serving_ssm["launches"]["ssd_scan"], [ssd_main]),
            "mamba2-2.7b-train": path_summary(training_m2["launches"]["ssd_scan"], [ssd_train_fwd]),
        },
    }
    for key in ("ms", "plain_ms", "bound_ms"):
        ssd_entry[key] = sum(r[key] for r in ssd_paths)
    ssd_entry["bound_by"] = max(ssd_paths, key=lambda r: r["bound_ms"])["bound_by"]
    ssd_entry["library_ms"] = None
    ssd_bwd_entry = {
        "name": "ssd_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        # no TPU kernel: JAX differentiates its plain chunked SSD
        "replaces": "none (JAX differentiates src/repro/models/ssm.py:123 ssd_chunked)",
        "launches": training_m2["launches"]["ssd_scan_bwd"],
        "max_abs_err": ssd_bwd_main["max_abs_err"],
        "matched": all(r["ok"] for r in ssd_bwd_rows + [ssd_bwd_main]) and m2_grads is not None,
        "shapes": "mamba2's training call (%d,%d,80,64) N128 G1 chunk 256 bf16, one a layer a step" % (
            TRAIN_BATCH, TRAIN_SEQ),
        "by_path": {"mamba2-2.7b-train": path_summary(training_m2["launches"]["ssd_scan_bwd"], [ssd_bwd_main])},
    }
    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
        ssd_bwd_entry[key] = ssd_bwd_main[key]
    # K3 runs on two kinds of call, each timed once: recurrentgemma's
    # serving wave and its training call (the forward of each RG-LRU layer
    # a step and an eval batch); the sums cover both, by_path holds each
    # path's own
    rglru_paths = [rglru_main, rglru_train_fwd]
    rg_train_rec = training_rg["launches"]["rglru_scan"]
    rglru_entry = {
        "name": "rglru_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:30",
        "launches": serving_rg["launches"]["rglru_scan"] + rg_train_rec + training_rg_remat["launches"]["rglru_scan"],
        "max_abs_err": max(r["max_abs_err"] for r in rglru_paths),
        "matched": all(r["ok"] for r in rglru_rows + rglru_paths),
        "shapes": "one call per RG-LRU layer of the wave (%d,%d,4096) f32 and one per RG-LRU layer of "
        "recurrentgemma's training call (%d,%d,4096) f32, the model's decays, against a float64 run, summed"
        % (WAVE_REQUESTS, RG_PROMPT_LEN, TRAIN_BATCH, TRAIN_SEQ),
        "by_path": {
            "recurrentgemma-9b": path_summary(serving_rg["launches"]["rglru_scan"], [rglru_main]),
            "recurrentgemma-9b-train": path_summary(rg_train_rec, [rglru_train_fwd]),
            "recurrentgemma-9b-train-remat": path_summary(training_rg_remat["launches"]["rglru_scan"],
                                                          [rglru_train_fwd]),
        },
    }
    for key in ("ms", "plain_ms", "plain_f64_ms", "bound_ms"):
        rglru_entry[key] = sum(r[key] for r in rglru_paths)
    rglru_entry["bound_by"] = max(rglru_paths, key=lambda r: r["bound_ms"])["bound_by"]
    rglru_entry["library_ms"] = None
    rg_train_rec_bwd = training_rg["launches"]["rglru_scan_bwd"]
    rg_remat_rec_bwd = training_rg_remat["launches"]["rglru_scan_bwd"]
    rglru_bwd_entry = {
        "name": "rglru_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan_bwd.cu",
        # no TPU kernel: JAX differentiates its plain associative scan
        "replaces": "none (JAX differentiates src/repro/models/rglru.py:93 rglru_scan)",
        "launches": rg_train_rec_bwd + rg_remat_rec_bwd,
        "max_abs_err": rglru_bwd_main["max_abs_err"],
        "matched": all(r["ok"] for r in rglru_bwd_rows + [rglru_bwd_main]) and rg_grads is not None,
        "shapes": "recurrentgemma's training call (%d,%d,%d) f32, the model's decays, no h0, one an RG-LRU layer "
        "a step, against a float64 run" % RGLRU_TRAIN,
        "by_path": {"recurrentgemma-9b-train": path_summary(rg_train_rec_bwd, [rglru_bwd_main]),
                    "recurrentgemma-9b-train-remat": path_summary(rg_remat_rec_bwd, [rglru_bwd_main])},
    }
    for key in ("ms", "plain_ms", "plain_f64_ms", "bound_ms", "bound_by", "library_ms"):
        rglru_bwd_entry[key] = rglru_bwd_main[key]
    bwd_entry = {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        # no TPU kernel: JAX differentiates its plain chunked attention
        "replaces": "none (JAX differentiates src/repro/models/layers.py:314)",
        "launches": training["launches"]["flash_attention_bwd"] + training_full["launches"]["flash_attention_bwd"]
        + training_rg["launches"]["flash_attention_bwd"] + training_g2["launches"]["flash_attention_bwd"]
        + training_q2["launches"]["flash_attention_bwd"] + training_moe["launches"]["flash_attention_bwd"]
        + training_px["launches"]["flash_attention_bwd"] + training_wh["launches"]["flash_attention_bwd"]
        + training_rg_remat["launches"]["flash_attention_bwd"] + training_px_remat["launches"]["flash_attention_bwd"]
        + training_dp["launches"]["flash_attention_bwd"] + sum(p["launches"] for p in mesh_bwd.values()),
        # gemma2's launches are all the softcap's (every one of its layers caps its scores)
        "softcap_launches": training_g2["launches"]["flash_attention_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in [bwd_main, rg_bwd_main, family_bwd["gemma2_bwd"],
                                                      family_bwd["qwen2_bwd"], family_bwd["pixtral_bwd"]]
                           + wh_paths["train_bwd"]),
        "matched": all(r["ok"] for r in bwd_rows + [bwd_main, rg_bwd_main, family_bwd["gemma2_bwd"],
                                                    family_bwd["gemma2_context_bwd"], family_bwd["qwen2_bwd"],
                                                    family_bwd["pixtral_bwd"]] + wh_paths["train_bwd"])
        and all(g is not None for g in (train_grads, g2_grads, q2_grads, moe_grads, wh_grads)),
        "shapes": "yi-6b's training call (%d,%d,32,128) kv 4 bf16 causal, one a layer a step (16 and 32 layers), "
        "recurrentgemma's (%d,%d,16,256) kv 1 bf16 causal window 2048, one a local layer a step, gemma2's "
        "(%d,%d,8,256) kv 4 bf16 causal softcap 50, one a layer a step, qwen2's (%d,%d,28,128) kv 4 bf16 "
        "causal, one a layer a step, qwen3-moe's (yi-6b's shape, %d layers) and pixtral's (%d,%d,32,128) kv 8 "
        "bf16 causal (%d layers), one a layer a step, whisper-tiny's (%d,1500,6,64) bidirectional, (%d,%d,6,64) "
        "causal and (%d,%d over 1500,6,64) cross, no mask, bf16, three a layer pair a step, summed" % (
            TRAIN_BATCH, TRAIN_SEQ, TRAIN_BATCH, TRAIN_SEQ, TRAIN_BATCH, TRAIN_SEQ, TRAIN_BATCH, TRAIN_SEQ,
            MOE_TRAIN_LAYERS, PIXTRAL_TRAIN_ATTN[0], PIXTRAL_TRAIN_ATTN[1], PIXTRAL_TRAIN_LAYERS, TRAIN_BATCH,
            TRAIN_BATCH, WHISPER_CTX, TRAIN_BATCH, WHISPER_CTX),
        "by_path": {
            "yi-6b-train": path_summary(training["launches"]["flash_attention_bwd"], [bwd_main]),
            "yi-6b-train-full": path_summary(training_full["launches"]["flash_attention_bwd"], [bwd_main]),
            "recurrentgemma-9b-train": path_summary(training_rg["launches"]["flash_attention_bwd"], [rg_bwd_main]),
            "gemma2-2b-train": path_summary(training_g2["launches"]["flash_attention_bwd"], [family_bwd["gemma2_bwd"]]),
            "qwen2-7b-train": path_summary(training_q2["launches"]["flash_attention_bwd"], [family_bwd["qwen2_bwd"]]),
            "qwen3-moe-30b-a3b-train": path_summary(training_moe["launches"]["flash_attention_bwd"], [bwd_main]),
            "pixtral-12b-train": path_summary(training_px["launches"]["flash_attention_bwd"],
                                              [family_bwd["pixtral_bwd"]]),
            "whisper-tiny-train": path_summary(training_wh["launches"]["flash_attention_bwd"], wh_paths["train_bwd"]),
            "recurrentgemma-9b-train-remat": path_summary(training_rg_remat["launches"]["flash_attention_bwd"],
                                                          [rg_bwd_main]),
            "pixtral-12b-train-remat": path_summary(training_px_remat["launches"]["flash_attention_bwd"],
                                                    [family_bwd["pixtral_bwd"]]),
            "yi-6b-dp": path_summary(training_dp["launches"]["flash_attention_bwd"], [bwd_main]),
            **mesh_bwd,
        },
    }
    bwd_paths = [bwd_main, rg_bwd_main, family_bwd["gemma2_bwd"], family_bwd["qwen2_bwd"],
                 family_bwd["pixtral_bwd"]] + wh_paths["train_bwd"]
    for key in ("ms", "plain_ms", "bound_ms"):
        bwd_entry[key] = sum(r[key] for r in bwd_paths)
    bwd_entry["bound_by"] = max(bwd_paths, key=lambda r: r["bound_ms"])["bound_by"]
    lib = [r["library_ms"] for r in bwd_paths]
    bwd_entry["library_ms"] = None if None in lib else sum(lib)
    opt8_launches = training_full["launches"]["adamw8bit"]
    opt8_entry = {
        "name": "adamw8bit",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/adamw8bit.cu",
        "replaces": "none (JAX's adamw8bit is XLA ops: src/repro/train/optimizer.py:237)",
        "launches": opt8_launches,
        "max_abs_err": opt8["max_abs_err"],
        "matched": opt8["ok"] and opt8_tail["ok"],
        "shapes": "one call a leaf a step over yi-6b's %d-layer tree (%d leaves, %d params, bf16), timed as the "
        "whole tree; by_path: qwen3-moe's training, timed on its %s w_in leaf (%d elements, held bit for bit past "
        "2^31)" % (FULL_LAYERS, opt8["leaves"], opt8["params"], tuple(opt8_tail["shape"]), opt8_tail["elements"]),
        "by_path": {"yi-6b-train-full": {
            "launches": opt8_launches, "ms": opt8["ms"], "plain_ms": opt8["plain_ms"], "bound_ms": opt8["bound_ms"],
            "bound_by": opt8["bound_by"], "library_ms": None, "bound_ms_over_ms": opt8["bound_ms"] / opt8["ms"],
        }, "qwen3-moe-30b-a3b-train": {
            "launches": training_moe["launches"]["adamw8bit"], "ms": opt8_tail["ms"], "plain_ms": opt8_tail["plain_ms"],
            "bound_ms": opt8_tail["bound_ms"], "bound_by": opt8_tail["bound_by"], "library_ms": None,
            "bound_ms_over_ms": opt8_tail["bound_ms"] / opt8_tail["ms"],
        }},
    }
    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
        opt8_entry[key] = opt8[key]
    norm = opt8["norm"]
    norm_launches = training_full["launches"]["grad_norm"]
    norm_entry = {
        "name": "grad_norm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grad_norm.cu",
        "replaces": "none (JAX's clip_by_global_norm is XLA ops: src/repro/train/optimizer.py:48)",
        "launches": norm_launches,
        "max_abs_err": norm["max_abs_err"],
        "matched": norm["ok"] and all(e <= NORM_RTOL for e in opt8["norm_rel_errs"]) and opt8_tail["ok"],
        "shapes": "a launch a leaf and one to finish, a step, over yi-6b's %d-layer tree of bf16 grads (%d bytes); "
        "library_ms: torch.linalg.vector_norm of the same bytes; by_path: qwen3-moe's training, timed on one "
        "gradient of its w_in leaf's shape" % (FULL_LAYERS, norm["bytes"]),
        "by_path": {"yi-6b-train-full": {
            "launches": norm_launches, "ms": norm["ms"], "plain_ms": norm["plain_ms"], "bound_ms": norm["bound_ms"],
            "bound_by": norm["bound_by"], "library_ms": norm["library_ms"], "bound_ms_over_ms": norm["bound_ms"] / norm["ms"],
        }, "qwen3-moe-30b-a3b-train": {
            "launches": training_moe["launches"]["grad_norm"], "ms": opt8_tail["norm_ms"],
            "plain_ms": opt8_tail["norm_plain_ms"], "bound_ms": opt8_tail["norm_bound_ms"],
            "bound_by": opt8_tail["norm_bound_by"], "library_ms": opt8_tail["norm_library_ms"],
            "bound_ms_over_ms": opt8_tail["norm_bound_ms"] / opt8_tail["norm_ms"],
        }},
    }
    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
        norm_entry[key] = norm[key]
    kernels_line = {"kernels": [entry, bwd_entry, ssd_entry, ssd_bwd_entry, rglru_entry, rglru_bwd_entry, opt8_entry,
                                norm_entry]}

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "torch": torch.__version__, "build_s": build_s, "checks": rows,
        "bwd_checks": bwd_rows, "lse_checks": lse_rows, "training": training, "training_grads": train_grads,
        "optimizer_kernel": opt8, "training_full": training_full,
        "main_path_kernel": attn_main, "serving": serving, "serving_group": serving_group,
        "paper_loop": paper_loop, "deployment_lm": deployment, "ssd_checks": ssd_rows,
        "ssd_main_path_kernel": ssd_main, "ssd_bwd_checks": ssd_bwd_rows, "ssd_bwd_main_path_kernel": ssd_bwd_main,
        "ssd_train_fwd": ssd_train_fwd, "training_mamba2": training_m2, "training_mamba2_grads": m2_grads,
        "rglru_checks": rglru_rows, "rglru_main_path_kernel": rglru_main, "rglru_bwd_checks": rglru_bwd_rows,
        "rglru_bwd_main_path_kernel": rglru_bwd_main, "rglru_train_fwd": rglru_train_fwd,
        "rg_attention_train_fwd": rg_train_fwd_main, "rg_attention_bwd_main_path_kernel": rg_bwd_main,
        "training_recurrentgemma": training_rg, "training_recurrentgemma_grads": rg_grads,
        "family_attention": family_attn, "family_attention_bwd": family_bwd,
        "training_gemma2": training_g2, "training_gemma2_grads": g2_grads,
        "training_qwen2": training_q2, "training_qwen2_grads": q2_grads, "serving_continuous": served,
        "serving_moe_int8": serving_moe, "fp8_cache": fp8_cache, "int8_vs_bf16": int8_vs_bf16,
        "serving_waves": {f"{arch} {dt}": out for (arch, dt), out in paths.items()},
        "training_moe": training_moe, "training_moe_grads": moe_grads, "opt8_past_2_31": opt8_tail,
        "training_pixtral": training_px, "serving_pixtral": serving_px,
        "whisper_kernel_checks": wh_rows, "whisper_kernel_paths": wh_paths, "training_whisper": training_wh,
        "training_whisper_grads": wh_grads, "serving_whisper": serving_wh, "remat_grads": remat_grads,
        "training_recurrentgemma_remat": training_rg_remat, "training_pixtral_remat": training_px_remat,
        "training_dp": training_dp, "k1_offset": k1_offset, "training_mesh": training_mesh, "dryrun": dryrun,
        "kernels": kernels_line["kernels"],
    }, indent=1))

    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
