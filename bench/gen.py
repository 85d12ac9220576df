"""The benchmark's traffic generators, frozen here so that no later
change to the program moves them. Every draw comes from ``--seed``.

* :func:`markov_corpus` — token rows of a seeded Markov chain (a frozen
  copy of ``examples/torch_train_lm.py``'s ``synth_corpus``, its number
  of states a parameter).
* :func:`open_loop` — an open loop of requests: Poisson arrivals at a
  fixed rate and log-normal prompt lengths. The sizes and the gaps are
  drawn from the traffic file's own seed, the same for every run; the
  run's seed deals them in another order and draws the tokens, so every
  seed offers the same work.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def markov_corpus(rows: int, vocab: int, seq: int, seed: int, states: int = 64) -> np.ndarray:
    """(rows, seq) int32 tokens: a Markov chain over ``states`` states
    with Dirichlet(0.1) transitions, each state spread over ``vocab //
    states`` ids plus a uniform offset in [0, 4)."""
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.full(states, 0.1), size=states)
    out = np.zeros((rows, seq), np.int32)
    s = rng.integers(0, states, rows)
    cum = trans.cumsum(1)
    for t in range(seq):
        out[:, t] = s
        u = rng.random(rows)
        s = (cum[s] > u[:, None]).argmax(1)
    return (out * (vocab // states) + rng.integers(0, 4, out.shape)).astype(np.int32)


@dataclasses.dataclass
class Arrival:
    req_id: int
    due_s: float  # seconds after the window opens
    prompt: np.ndarray  # int32
    max_new: int
    tenant: int


def open_loop(traffic: dict, vocab: int, seed: int, seconds: float) -> list[Arrival]:
    """The requests due in a window of ``seconds``: Poisson at
    ``traffic["rate_per_s"]``, prompts log-normal (median
    ``prompt_median``, sigma ``prompt_sigma``) clipped to [prompt_min,
    prompt_max], ``max_new`` tokens each, tenants dealt round-robin."""
    rate = float(traffic["rate_per_s"])
    fixed = np.random.default_rng(int(traffic["shape_seed"]))
    n_max = int(np.ceil(rate * seconds * 3 + 50))
    gaps = fixed.exponential(1.0 / rate, n_max)
    lens = np.exp(fixed.normal(np.log(traffic["prompt_median"]), traffic["prompt_sigma"], n_max))
    lens = np.clip(np.round(lens), traffic["prompt_min"], traffic["prompt_max"]).astype(np.int64)
    # the first n arrivals that fit in the window: the same multiset of
    # gaps and lengths for every seed, dealt in the seed's order
    n = int(np.searchsorted(np.cumsum(gaps), seconds, side="left"))
    rng = np.random.default_rng(seed)
    gaps, lens = rng.permutation(gaps[:n]), rng.permutation(lens[:n])
    due = np.cumsum(gaps)
    out = []
    for i in range(n):
        prompt = rng.integers(0, vocab, int(lens[i]), dtype=np.int64).astype(np.int32)
        out.append(Arrival(i, float(due[i]), prompt, int(traffic["max_new"]), i % int(traffic["tenants"])))
    return out
