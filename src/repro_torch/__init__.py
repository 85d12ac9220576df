"""PyTorch/CUDA port of the Kafka-ML reproduction (the JAX package is ``repro``).

The layout mirrors ``repro``: ``models/``, ``kernels/``, ``serve/``,
``configs/``, ``core/``, ``analysis/``. Nothing here imports ``jax`` or
``repro``; the stream substrate the port needs is its own copy.

Every entry point takes ``device=`` and defaults to ``"cuda"``. It runs
on the CPU only when the caller passes ``device="cpu"`` (as the tests
do); with no card and no explicit CPU request it raises rather than
falling back.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card. A CUDA device with no card present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
