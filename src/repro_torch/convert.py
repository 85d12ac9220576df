"""Move parameter trees and optimizer states between the JAX package and
the port.

The two frameworks draw different numbers from the same seed, so parity
between them comes from moved weights: a JAX parameter tree turned into
numpy (``jax.tree.map(np.asarray, params)``) goes through
:func:`params_from_jax` and into ``StreamModel.load_params``. An AdamW
state (``{"step", "m", "v"}`` in the JAX tree layout) moves the same way
through :func:`opt_state_from_jax` and back through
:func:`opt_state_to_numpy`. None of them imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["opt_state_from_jax", "opt_state_to_numpy", "params_from_jax", "params_to_numpy"]


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree):
    """Nested dict of numpy arrays (JAX layout) -> same nesting of CPU
    tensors, dtypes kept (``StreamModel.load_params`` moves them to the
    model's device)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    return _to_torch(tree)


def params_to_numpy(tree):
    """Nested dict of tensors -> numpy. bfloat16 comes back as float32
    (numpy has no bfloat16; the JAX checkpoint stores it the same way)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


_OPT_KEYS = {"step", "m", "v"}


def opt_state_from_jax(state) -> dict:
    """An AdamW state of the JAX package (numpy leaves: ``step`` an int32
    scalar, ``m`` and ``v`` f32 trees in the params' layout) -> the port's
    (``step`` a 0-d int32 CPU tensor, ``m`` and ``v`` trees of f32 CPU
    tensors; ``.to`` the card as the params go)."""
    if set(state) != _OPT_KEYS:
        raise KeyError(f"an AdamW state has keys {sorted(_OPT_KEYS)}, got {sorted(state)}")
    return {
        "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32),
        "m": params_from_jax(state["m"]),
        "v": params_from_jax(state["v"]),
    }


def opt_state_to_numpy(state) -> dict:
    """The port's AdamW state -> the JAX package's layout in numpy."""
    if set(state) != _OPT_KEYS:
        raise KeyError(f"an AdamW state has keys {sorted(_OPT_KEYS)}, got {sorted(state)}")
    return {
        "step": np.int32(int(state["step"])),
        "m": params_to_numpy(state["m"]),
        "v": params_to_numpy(state["v"]),
    }
