"""copd-mlp — the paper's own validation model (§VI) (port of
``repro.configs.copd_mlp``).

Kafka-ML's evaluation trains a small Keras MLP on the HCOPD dataset
(age / smoking status / gender / biosensor features -> diagnosis class).
This is the paper-faithful model used by the quickstart example. It is
not an LM, so it gets its own tiny functional model rather than an
ArchConfig, and is not registered in ``configs.ARCHS``.

The parameters are a flat dict of f32 tensors in the JAX layout
(``w1`` (features, hidden), ``b1``, ``w2`` (hidden, classes), ``b2``), so
they move between the packages through ``repro_torch.convert``.
Differences that belong to PyTorch: ``init`` takes a ``torch.Generator``
and draws on its device (the ``TrainingJob`` makes one on the job's
device) where JAX takes a PRNG key; the labels are cast to int64 for
``gather``. :func:`predict` is the port's serving function: the
quickstart's softmax over :func:`forward`, computed without grad.
"""

from __future__ import annotations

import math

import torch

ID = "copd-mlp"

N_FEATURES = 5  # age, smoking, gender, + 2 biosensor readings
N_CLASSES = 4  # COPD / HC / Asthma / Infected
HIDDEN = 32


def init(generator: torch.Generator, n_features: int = N_FEATURES, hidden: int = HIDDEN,
         n_classes: int = N_CLASSES):
    dev = generator.device

    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator, device=dev) / math.sqrt(fan_in)

    return {
        "w1": normal((n_features, hidden), n_features),
        "b1": torch.zeros((hidden,), device=dev),
        "w2": normal((hidden, n_classes), hidden),
        "b2": torch.zeros((n_classes,), device=dev),
    }


def forward(params, x):
    """Logits (B, classes); ``x`` may be a numpy batch as the deployment
    decodes it (a read-only view of the log), copied to where the
    parameters are."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, device=params["w1"].device)
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def loss_fn(params, batch):
    """Sparse categorical cross-entropy, as the paper's Listing 2 compiles."""
    logits = forward(params, batch["data"])
    labels = torch.as_tensor(batch["label"], device=logits.device).long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels[:, None])[:, 0]
    loss = torch.mean(lse - picked)
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return loss, {"loss": loss, "accuracy": acc}


@torch.no_grad()
def predict(params, x) -> torch.Tensor:
    """Class probabilities (B, classes) in f32, on the parameters' device.
    Grad mode is per thread and a deployment predicts on its pool's
    threads, where it is on: without ``no_grad`` a trained job's
    parameters (which require grad) would build a graph there."""
    return torch.softmax(forward(params, x), dim=-1)


def synth_dataset(rng_seed: int = 0, n: int = 220):
    """Synthetic HCOPD-like tabular data (the real CSV is not bundled)."""
    import numpy as np

    rng = np.random.default_rng(rng_seed)
    labels = rng.integers(0, N_CLASSES, size=n).astype(np.int32)
    centers = rng.normal(size=(N_CLASSES, N_FEATURES)).astype(np.float32) * 2.0
    data = centers[labels] + rng.normal(size=(n, N_FEATURES)).astype(np.float32)
    return {"data": data.astype(np.float32), "label": labels}
