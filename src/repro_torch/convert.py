"""Move parameter trees and optimizer states between the JAX package and
the port.

The two frameworks draw different numbers from the same seed, so parity
between them comes from moved weights: a JAX parameter tree turned into
numpy (``jax.tree.map(np.asarray, params)``) goes through
:func:`params_from_jax` and into ``StreamModel.load_params``. An AdamW
state (``{"step", "m", "v"}`` in the JAX tree layout) moves the same way
through :func:`opt_state_from_jax` and back through
:func:`opt_state_to_numpy`, and so does an ``adamw8bit`` state, whose m
and v leaves are ``{"codes": int8, "scales": f32}``. None of them
imports JAX.
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


def _moment_leaves(tree) -> list:
    """A moment tree's leaves: tensors or arrays, or ``adamw8bit``'s
    ``{"codes", "scales"}`` dicts, each taken whole."""
    if isinstance(tree, dict) and "codes" not in tree:
        return [leaf for v in tree.values() for leaf in _moment_leaves(v)]
    return [tree]


def _check_opt_state(state, dtype_of) -> None:
    """Raise unless ``state`` is an AdamW state (f32 moment leaves) or an
    ``adamw8bit`` one (every moment leaf ``{codes: int8, scales: f32}``).
    ``dtype_of`` names a leaf's dtype ("float32", "int8", ...)."""
    if set(state) != _OPT_KEYS:
        raise KeyError(f"an AdamW state has keys {sorted(_OPT_KEYS)}, got {sorted(state)}")
    leaves = _moment_leaves(state["m"]) + _moment_leaves(state["v"])
    if all(isinstance(x, dict) for x in leaves):
        for x in leaves:
            if set(x) != {"codes", "scales"}:
                raise KeyError(f"an adamw8bit moment has keys ['codes', 'scales'], got {sorted(x)}")
            if (dtype_of(x["codes"]), dtype_of(x["scales"])) != ("int8", "float32"):
                raise TypeError(f"adamw8bit codes and scales are int8 and float32, got "
                                f"{dtype_of(x['codes'])} and {dtype_of(x['scales'])}")
    elif any(isinstance(x, dict) or dtype_of(x) != "float32" for x in leaves):
        raise TypeError("neither an AdamW state (float32 moments) nor an adamw8bit one ({codes, scales} moments)")


def opt_state_from_jax(state) -> dict:
    """An AdamW or ``adamw8bit`` state of the JAX package (numpy leaves:
    ``step`` an int32 scalar, ``m`` and ``v`` in the params' layout, f32
    leaves or ``{codes, scales}``) -> the port's (``step`` a 0-d int32 CPU
    tensor, the same trees of CPU tensors; ``.to`` the card as the params
    go)."""
    _check_opt_state(state, lambda a: np.asarray(a).dtype.name)
    return {
        "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32),
        "m": params_from_jax(state["m"]),
        "v": params_from_jax(state["v"]),
    }


def opt_state_to_numpy(state) -> dict:
    """The port's AdamW or ``adamw8bit`` state -> the JAX package's layout
    in numpy."""
    _check_opt_state(state, lambda t: str(t.dtype).removeprefix("torch."))
    return {
        "step": np.int32(int(state["step"])),
        "m": params_to_numpy(state["m"]),
        "v": params_to_numpy(state["v"]),
    }
